// Native TFRecord + SequenceExample parser for the YT8M frame-level
// dataset.
//
// This is the rebuild's equivalent of the compiled data plane the
// reference inherits from the TensorFlow 1.3 runtime (TFRecordReader +
// parse_single_sequence_example,
// readers.py:190-201): a single-pass, zero-allocation-per-record wire
// parser that fills caller-provided numpy buffers through a C ABI
// (ctypes on the Python side, see native/__init__.py).
//
// Layout contract per video (matching data/loader.py):
//   features: [max_frames, total_feature_size] uint8, zero-padded rows
//   labels:   int32 class ids (video-level, from the context)
//   id:       UTF-8 video id
//
// Two entry points share one decoder: the per-file reader (yt8m_open /
// yt8m_next_batch), which fills a caller's arrays a video at a time, and
// the batcher (yt8m_batcher_*), whose own team of threads reads a few
// record streams over a file list and decodes their videos straight into
// the rows of the batch blocks the caller hands in, with no Python per
// video.
//
// Wire format notes: TFRecord framing is {u64 len, u32 masked crc(len),
// data, u32 masked crc(data)}; SequenceExample is
//   { Features context = 1; FeatureLists feature_lists = 2; }
// with Features/FeatureLists being map<string, Feature/FeatureList> and
// Feature { BytesList=1 | FloatList=2 | Int64List=3 }.

#include <errno.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <exception>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8
// ---------------------------------------------------------------------------

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t crc = i;
      for (int k = 0; k < 8; k++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      t[0][i] = crc;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t i = 0; i < 256; i++)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

// `start` is a finalized CRC32C value (post xor-out) to continue from,
// 0 for a fresh checksum — the same incremental contract as the Python
// table fallback in data/tfrecord.py.
uint32_t crc32c_ext(const uint8_t* data, size_t n, uint32_t start) {
  uint32_t crc = ~start;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
          kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
          kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
          kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  return crc32c_ext(data, n, 0);
}

uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t c = crc32c(data, n);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// proto wire primitives
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  Cursor slice(size_t n) {
    if (size_t(end - p) < n) {
      ok = false;
      return {p, p};
    }
    Cursor c{p, p + n};
    p += n;
    return c;
  }

  bool skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); return ok;
      case 1: return (ok = ok && size_t(end - p) >= 8) && (p += 8, true);
      case 2: { uint64_t n = varint(); return ok && slice(n).ok; }
      case 5: return (ok = ok && size_t(end - p) >= 4) && (p += 4, true);
      default: ok = false; return false;
    }
  }

  bool done() const { return p >= end; }
};

struct StringView {
  const uint8_t* p = nullptr;
  size_t n = 0;
  bool eq(const char* s) const { return strlen(s) == n && !memcmp(p, s, n); }
};

// ---------------------------------------------------------------------------
// Reader
// ---------------------------------------------------------------------------

// The requested features and how a video's rows are laid out.
struct Layout {
  std::vector<std::string> names;
  std::vector<int32_t> sizes;
  std::vector<int32_t> col_offsets;  // column offset per feature
  int32_t total_size = 0;
  int32_t max_frames = 0;
  int32_t stride = 1;     // keep every stride-th frame (student paths)
  int32_t out_rows = 0;   // ceil(max_frames / stride): rows per video

  Layout(const char* const* feature_names, const int32_t* feature_sizes,
         int32_t nfeat, int32_t max_frames_, int32_t stride_)
      : max_frames(max_frames_), stride(stride_ < 1 ? 1 : stride_) {
    out_rows = (max_frames + stride - 1) / stride;
    for (int32_t i = 0; i < nfeat; i++) {
      names.emplace_back(feature_names[i]);
      sizes.push_back(feature_sizes[i]);
      col_offsets.push_back(total_size);
      total_size += feature_sizes[i];
    }
  }

  size_t video_bytes() const { return size_t(out_rows) * total_size; }
};

constexpr uint64_t kMaxRecordBytes = 1ull << 30;

struct Yt8mReader {
  explicit Yt8mReader(const Layout& l) : layout(l) {}

  FILE* f = nullptr;
  Layout layout;
  bool verify_crc = false;
  std::string error;
  std::vector<uint8_t> record;  // reusable record buffer

  bool fail(const char* msg) {
    error = msg;
    return false;
  }

  // Reads the next framed record into `record`. 1 = ok, 0 = eof, -1 = err.
  int next_record() {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, f);
    if (got == 0) return 0;
    if (got < 12) return fail("truncated header"), -1;
    uint64_t len;
    memcpy(&len, header, 8);
    if (verify_crc) {
      uint32_t c;
      memcpy(&c, header + 8, 4);
      if (masked_crc32c(header, 8) != c) return fail("length crc mismatch"), -1;
    }
    // The length is UNTRUSTED input: a corrupt header can claim up to
    // 2^64 bytes, and letting resize() throw would unwind a C++
    // exception through the extern "C" ctypes frame — std::terminate,
    // killing the host process. Bound it (a YT8M SequenceExample is a
    // few hundred KB; 1 GB is generous for any TFRecord) and absorb
    // allocation failure into the normal error path.
    if (len > kMaxRecordBytes)
      return fail("record length implausible (corrupt header?)"), -1;
    try {
      record.resize(len);
    } catch (const std::exception&) {
      return fail("record allocation failed"), -1;
    }
    if (fread(record.data(), 1, len, f) != len)
      return fail("truncated record"), -1;
    uint8_t footer[4];
    if (fread(footer, 1, 4, f) != 4) return fail("truncated footer"), -1;
    if (verify_crc) {
      uint32_t c;
      memcpy(&c, footer, 4);
      if (masked_crc32c(record.data(), len) != c)
        return fail("data crc mismatch"), -1;
    }
    return 1;
  }
};

// Feature { bytes_list=1 { value=1 } } -> first bytes value
StringView feature_first_bytes(Cursor c) {
  StringView out;
  while (c.ok && !c.done()) {
    uint64_t tag = c.varint();
    if (!c.ok) break;
    if ((tag >> 3) == 1 && (tag & 7) == 2) {  // BytesList
      uint64_t n = c.varint();
      Cursor bl = c.slice(n);
      while (bl.ok && !bl.done()) {
        uint64_t btag = bl.varint();
        if (!bl.ok) break;
        if ((btag >> 3) == 1 && (btag & 7) == 2) {
          uint64_t bn = bl.varint();
          Cursor v = bl.slice(bn);
          if (bl.ok) {
            out.p = v.p;
            out.n = bn;
          }
          return out;  // first value only (one frame vector per Feature)
        }
        bl.skip(btag & 7);
      }
      return out;
    }
    c.skip(tag & 7);
  }
  return out;
}

// Feature { int64_list=3 { value=1 packed|scalar } } -> append ints.
// The count is untrusted (a corrupt record could pack ~1 GB of varints
// -> an 8 GB vector); drop entries past a generous bound — the real
// vocab is 4716 classes and consumers truncate to labels_cap anyway.
constexpr size_t kMaxInt64s = size_t(1) << 16;

void feature_int64s(Cursor c, std::vector<int64_t>* out) {
  while (c.ok && !c.done()) {
    uint64_t tag = c.varint();
    if (!c.ok) break;
    if ((tag >> 3) == 3 && (tag & 7) == 2) {  // Int64List
      uint64_t n = c.varint();
      Cursor il = c.slice(n);
      while (il.ok && !il.done()) {
        uint64_t itag = il.varint();
        if (!il.ok) break;
        uint32_t wt = itag & 7;
        if ((itag >> 3) == 1 && wt == 2) {  // packed
          uint64_t pn = il.varint();
          Cursor pk = il.slice(pn);
          while (pk.ok && !pk.done()) {
            int64_t v = int64_t(pk.varint());
            if (out->size() < kMaxInt64s) out->push_back(v);
          }
        } else if ((itag >> 3) == 1 && wt == 0) {
          int64_t v = int64_t(il.varint());
          if (out->size() < kMaxInt64s) out->push_back(v);
        } else {
          il.skip(wt);
        }
      }
      return;
    }
    c.skip(tag & 7);
  }
}

// Decodes one SequenceExample into `feat_out` (layout.video_bytes() bytes:
// every kept frame row written, the padding rows zeroed), the ORIGINAL
// (capped) frame count, the label ids and the video id (a view into
// `record`). Returns nullptr, or the error.
const char* decode_video(const Layout& L, const std::vector<uint8_t>& record,
                         uint8_t* feat_out, int32_t* num_frames_out,
                         std::vector<int64_t>* labels, StringView* video_id) {
  Cursor top{record.data(), record.data() + record.size()};
  int32_t num_frames = -1;
  size_t matched = 0;  // requested features found in the record

  while (top.ok && !top.done()) {
    uint64_t tag = top.varint();
    if (!top.ok) break;
    uint32_t field = tag >> 3, wt = tag & 7;
    if (field == 1 && wt == 2) {  // context: Features
      uint64_t n = top.varint();
      Cursor ctx = top.slice(n);
      while (ctx.ok && !ctx.done()) {
        uint64_t etag = ctx.varint();
        if (!ctx.ok) break;
        if ((etag >> 3) == 1 && (etag & 7) == 2) {  // map entry
          uint64_t en = ctx.varint();
          Cursor entry = ctx.slice(en);
          StringView key;
          Cursor feat{nullptr, nullptr};
          while (entry.ok && !entry.done()) {
            uint64_t ftag = entry.varint();
            if (!entry.ok) break;
            if ((ftag >> 3) == 1 && (ftag & 7) == 2) {
              uint64_t kn = entry.varint();
              Cursor k = entry.slice(kn);
              key = {k.p, kn};
            } else if ((ftag >> 3) == 2 && (ftag & 7) == 2) {
              uint64_t vn = entry.varint();
              feat = entry.slice(vn);
            } else {
              entry.skip(ftag & 7);
            }
          }
          if (key.p) {
            if (key.eq("id")) {
              *video_id = feature_first_bytes(feat);
            } else if (key.eq("labels")) {
              feature_int64s(feat, labels);
            }
          }
        } else {
          ctx.skip(etag & 7);
        }
      }
    } else if (field == 2 && wt == 2) {  // feature_lists
      uint64_t n = top.varint();
      Cursor fls = top.slice(n);
      while (fls.ok && !fls.done()) {
        uint64_t etag = fls.varint();
        if (!fls.ok) break;
        if ((etag >> 3) == 1 && (etag & 7) == 2) {  // map entry
          uint64_t en = fls.varint();
          Cursor entry = fls.slice(en);
          StringView key;
          Cursor flist{nullptr, nullptr};
          while (entry.ok && !entry.done()) {
            uint64_t ftag = entry.varint();
            if (!entry.ok) break;
            if ((ftag >> 3) == 1 && (ftag & 7) == 2) {
              uint64_t kn = entry.varint();
              Cursor k = entry.slice(kn);
              key = {k.p, kn};
            } else if ((ftag >> 3) == 2 && (ftag & 7) == 2) {
              uint64_t vn = entry.varint();
              flist = entry.slice(vn);
            } else {
              entry.skip(ftag & 7);
            }
          }
          // match requested feature names
          for (size_t fi = 0; fi < L.names.size(); fi++) {
            if (key.p == nullptr || key.n != L.names[fi].size() ||
                memcmp(key.p, L.names[fi].data(), key.n) != 0)
              continue;
            matched++;
            const int32_t size = L.sizes[fi];
            const int32_t col = L.col_offsets[fi];
            int32_t frame = 0;
            Cursor fl = flist;
            while (fl.ok && !fl.done()) {
              uint64_t ltag = fl.varint();
              if (!fl.ok) break;
              if ((ltag >> 3) == 1 && (ltag & 7) == 2) {  // Feature
                uint64_t ln = fl.varint();
                Cursor feat = fl.slice(ln);
                if (frame < L.max_frames) {
                  // every frame's payload size is still VALIDATED (the
                  // pure-Python parser rejects corrupt frames too, a
                  // frame with no bytes among them); the stride only
                  // skips the memcpy of dropped frames
                  StringView bytes = feature_first_bytes(feat);
                  if (!bytes.p || int32_t(bytes.n) != size)
                    return "frame feature size mismatch";
                  if (frame % L.stride == 0) {
                    memcpy(feat_out + size_t(frame / L.stride) * L.total_size + col,
                           bytes.p, size);
                  }
                }
                frame++;
              } else {
                fl.skip(ltag & 7);
              }
            }
            if (num_frames == -1) {
              num_frames = frame;
            } else if (num_frames != frame) {
              // the reference asserts per-feature frame-count equality
              // (readers.py:229)
              return "per-feature frame counts differ";
            }
          }
        } else {
          fls.skip(etag & 7);
        }
      }
    } else {
      top.skip(wt);
    }
  }
  if (!top.ok) return "malformed SequenceExample";
  // a requested feature the record lacks has no frames, like the
  // pure-Python parser's; its columns would otherwise go unwritten
  if (matched < L.names.size() && num_frames > 0)
    return "per-feature frame counts differ";

  if (num_frames < 0) num_frames = 0;
  if (num_frames > L.max_frames) num_frames = L.max_frames;
  // num_frames reports the ORIGINAL (capped) count even under stride —
  // the consumers' seq-length math runs on original frame counts
  *num_frames_out = num_frames;
  // zero the padding rows of the (possibly strided) output
  const int32_t kept = (num_frames + L.stride - 1) / L.stride;
  if (kept < L.out_rows)
    memset(feat_out + size_t(kept) * L.total_size, 0,
           size_t(L.out_rows - kept) * L.total_size);
  return nullptr;
}

// Copies the id, cut to id_cap - 1 bytes, and its terminating NUL.
void copy_id(const StringView& id, char* out, int32_t id_cap) {
  int32_t idn = int32_t(id.n);
  if (idn >= id_cap) idn = id_cap - 1;
  if (idn > 0) memcpy(out, id.p, idn);
  out[idn < 0 ? 0 : idn] = '\0';
}

// ---------------------------------------------------------------------------
// Batcher: a team of threads that reads `num_readers` record streams and
// decodes their records into the caller's blocks
// ---------------------------------------------------------------------------

// time.time_ns's clock, the one the program's spans are kept on
int64_t realtime_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// One batch's arrays, handed in by the caller: features [batch, out_rows,
// total_size] u8, labels [batch, vocab] bool, num_frames [batch] i32, ids
// [batch, id_cap] char. A thread claims a row (`claimed`) once it holds a
// whole record, and counts it `done` once the row is written.
struct Block {
  uint8_t* features;
  uint8_t* labels;
  int32_t* num_frames;
  char* ids;
  int32_t claimed = 0;
  int32_t done = 0;
};

// An open file of the list, shared by its stream and by the team threads
// still reading records of it: closed when the last lets go.
struct File {
  int fd = -1;
  int64_t index = 0;  // the cursor's index of it
  int64_t size = 0;
  ~File() {
    if (fd >= 0) close(fd);
  }
};

// One record stream: a file at a time from the batcher's cursor, whose
// records whichever team thread holds it locates in order, from their
// headers.
struct Stream {
  std::shared_ptr<File> file;
  int64_t offset = 0;    // of the next record's header
  bool held = false;
  bool retired = false;  // the cursor had no file left for it
};

// A record a stream located: its file, and where its bytes lie in it.
struct Record {
  std::shared_ptr<File> file;
  int64_t offset = 0;
  uint64_t len = 0;
};

// Reads `n` bytes of `fd` at `offset`; false if the file ends first or
// the read fails.
bool pread_all(int fd, uint8_t* p, size_t n, int64_t offset) {
  while (n > 0) {
    const ssize_t got = pread(fd, p, n, offset);
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) return false;
    p += got;
    n -= size_t(got);
    offset += got;
  }
  return true;
}

// The team's logged stretches are kept as (kind, thread id, start, end)
// on CLOCK_REALTIME, up to this many a drain: a stream held to locate a
// record (from taking the stream to giving it back, less any wait for a
// block), and a record's read and decode into its row.
constexpr int64_t kSpanRead = 0, kSpanDecode = 1;
constexpr size_t kMaxSpans = size_t(1) << 18;

struct Batcher {
  explicit Batcher(const Layout& l) : layout(l) {}

  Layout layout;
  std::vector<std::string> files;
  int64_t files_total = -1;  // files.size() x epochs; -1: endless
  int32_t batch = 0, vocab = 0, labels_cap = 0, id_cap = 0;

  std::mutex mu;  // guards everything below
  std::condition_variable rows_free;    // a block with an unclaimed row
  std::condition_variable block_done;   // the oldest block can go out
  std::condition_variable stream_free;  // a stream given back or retired
  int64_t next_file = 0;
  std::vector<Stream> streams;
  int32_t retired = 0;        // streams retired
  std::deque<Block> blocks;   // handed in and not yet handed out, oldest first
  int32_t live = 0;           // team threads still running
  int32_t decoding = 0;       // rows claimed and neither written nor abandoned
  int64_t stream_waits = 0;   // times a thread found every stream held
  bool stop = false;
  std::string error;          // the first error, as the consumer raises it
  std::vector<int64_t> spans;
  std::vector<std::thread> threads;

  // The oldest block's rows can go out: all written, or the stream has
  // ended (no thread left, none failed) and every row claimed is written.
  bool front_ready() const {
    const Block& b = blocks.front();
    return b.done == batch || (live == 0 && error.empty() && b.done == b.claimed);
  }

  // What the consumer waits for: the oldest block, or an error once no
  // row claimed before it is still being written (so the rows read
  // before a failed one still go out).
  bool settled() const {
    return front_ready() || (!error.empty() && decoding == 0);
  }

  void fail(const std::string& msg) {
    std::lock_guard<std::mutex> lk(mu);
    if (error.empty()) error = msg;
    rows_free.notify_all();
    block_done.notify_all();
    stream_free.notify_all();
  }

  // The next file of the cursor, or false once it has ended or failed.
  bool take_file(int64_t* file) {
    std::lock_guard<std::mutex> lk(mu);
    if (stop || !error.empty()) return false;
    if (files_total >= 0 && next_file >= files_total) return false;
    *file = next_file++;
    return true;
  }

  const std::string& path(int64_t index) const {
    return files[size_t(index % int64_t(files.size()))];
  }

  // Takes a free stream at `*t0`, waiting while every one is held;
  // nullptr once all have retired, or on stop or error.
  Stream* take_stream(int64_t* t0) {
    std::unique_lock<std::mutex> lk(mu);
    bool waited = false;
    for (;;) {
      if (stop || !error.empty() || retired == int32_t(streams.size())) return nullptr;
      for (Stream& s : streams) {
        if (!s.held && !s.retired) {
          s.held = true;
          *t0 = realtime_ns();  // under the lock: a stream's holds never overlap
          return &s;
        }
      }
      if (!waited) stream_waits++;
      waited = true;
      stream_free.wait(lk);
    }
  }

  void retire(Stream* s) {
    std::lock_guard<std::mutex> lk(mu);
    s->held = false;
    s->retired = true;
    retired++;
    stream_free.notify_all();
  }

  // Locates the held stream's next record from its header, as the per-file
  // reader frames it, moving on to the cursor's next file where one ends.
  // 1 = a record, 0 = the cursor has no file left, -1 = failed (the error
  // set).
  int next_record(Stream* s, Record* rec) {
    for (;;) {
      if (!s->file) {
        auto file = std::make_shared<File>();
        if (!take_file(&file->index)) return 0;
        file->fd = open(path(file->index).c_str(), O_RDONLY | O_CLOEXEC);
        struct stat st;
        if (file->fd < 0 || fstat(file->fd, &st) != 0)
          return fail("cannot open " + path(file->index)), -1;
        file->size = st.st_size;
        s->file = std::move(file);
        s->offset = 0;
      }
      const int64_t left = s->file->size - s->offset;
      if (left == 0) {
        s->file.reset();
        continue;
      }
      uint8_t header[12];
      uint64_t len = 0;
      const char* err = nullptr;
      if (left < 12) {
        err = "truncated header";
      } else if (!pread_all(s->file->fd, header, 12, s->offset)) {
        err = "read error";
      } else {
        memcpy(&len, header, 8);
        if (len > kMaxRecordBytes) err = "record length implausible (corrupt header?)";
        else if (uint64_t(left - 12) < len) err = "truncated record";
        else if (uint64_t(left - 12) - len < 4) err = "truncated footer";
      }
      if (err) return fail("parse error in " + path(s->file->index) + ": " + err), -1;
      rec->file = s->file;
      rec->offset = s->offset + 12;
      rec->len = len;
      s->offset += 12 + int64_t(len) + 4;
      return 1;
    }
  }

  // Claims the next row of the oldest block with one free, waiting for
  // the caller to hand a block in, and gives the stream back at `*t3`.
  // Claimed while the stream is held, one stream's rows keep its order.
  // False on stop or error; `waited` says whether it waited for a block.
  bool claim(Stream* s, Block** block, int32_t* row, bool* waited, int64_t* t3) {
    std::unique_lock<std::mutex> lk(mu);
    *waited = false;
    for (;;) {
      if (stop || !error.empty()) return false;
      for (Block& b : blocks) {
        if (b.claimed < batch) {
          *block = &b;
          *row = b.claimed++;
          decoding++;
          s->held = false;
          *t3 = realtime_ns();
          stream_free.notify_one();
          return true;
        }
      }
      *waited = true;
      rows_free.wait(lk);
    }
  }

  // Counts the row written, and logs the stream's read [t0, read_end] and
  // the record's decode from `decode_start` to now.
  void finish_row(Block* block, int64_t tid, int64_t t0, int64_t read_end,
                  int64_t decode_start) {
    std::lock_guard<std::mutex> lk(mu);
    if (spans.size() + 8 <= 4 * kMaxSpans)
      spans.insert(spans.end(), {kSpanRead, tid, t0, read_end,
                                 kSpanDecode, tid, decode_start, realtime_ns()});
    block->done++;
    decoding--;
    if ((block == &blocks.front() && block->done == batch) ||
        (!error.empty() && decoding == 0))
      block_done.notify_one();
  }

  // One round of a team thread: take a stream, locate its next record,
  // claim a row and give the stream back; then, outside every lock, read
  // the record's bytes and decode them into the row. False once the
  // thread is done: every stream retired, stop, or an error. `in_row`: a
  // row claimed and not written.
  bool round(int64_t tid, Record* rec, std::vector<uint8_t>* record,
             std::vector<int64_t>* labels, bool* in_row) {
    int64_t t0, t1, t3;  // stream taken, record located, stream given back
    Stream* s = take_stream(&t0);
    if (!s) return false;
    const int rc = next_record(s, rec);
    if (rc == 0) retire(s);
    if (rc <= 0) return rc == 0;
    t1 = realtime_ns();
    Block* b;
    int32_t row;
    bool waited;
    if (!claim(s, &b, &row, &waited, &t3)) return false;
    *in_row = true;
    const std::string& file = path(rec->file->index);
    try {
      record->resize(rec->len);
    } catch (const std::exception&) {
      return fail("parse error in " + file + ": record allocation failed"), false;
    }
    if (!pread_all(rec->file->fd, record->data(), rec->len, rec->offset))
      return fail("parse error in " + file + ": truncated record"), false;
    rec->file.reset();  // the stream may have closed it meanwhile
    labels->clear();
    StringView id;
    const char* err = decode_video(layout, *record, b->features + row * layout.video_bytes(),
                                   b->num_frames + row, labels, &id);
    if (err) return fail("parse error in " + file + ": " + err), false;
    if (labels->size() > size_t(labels_cap)) {
      fail("record in " + file + " has " + std::to_string(labels->size()) +
           " labels > labels_cap " + std::to_string(labels_cap) +
           "; pass a larger labels_cap (the loader sizes it to the vocabulary)");
      return false;
    }
    uint8_t* dense = b->labels + size_t(row) * vocab;
    memset(dense, 0, vocab);
    for (int64_t c : *labels)
      if (0 <= c && c < vocab) dense[c] = 1;
    copy_id(id, b->ids + size_t(row) * id_cap, id_cap);
    // a wait for a block, the stream still held, is no part of the read
    finish_row(b, tid, t0, waited ? t1 : t3, t3);
    *in_row = false;
    return true;
  }

  void run_member() {
    const int64_t tid = int64_t(syscall(SYS_gettid));
    Record rec;
    std::vector<uint8_t> record;
    std::vector<int64_t> labels;
    bool in_row = false;
    try {
      while (round(tid, &rec, &record, &labels, &in_row)) {
      }
    } catch (const std::exception&) {  // allocation: never unwind past here
      fail("reader thread failed (allocation)");
    }
    std::lock_guard<std::mutex> lk(mu);
    if (in_row) decoding--;
    live--;
    block_done.notify_one();
  }
};

}  // namespace

extern "C" {

void yt8m_batcher_close(Batcher* b);

Yt8mReader* yt8m_open(const char* path, const char* const* names,
                      const int32_t* sizes, int32_t nfeat, int32_t max_frames,
                      int32_t verify_crc, int32_t stride) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  auto* r = new Yt8mReader(Layout(names, sizes, nfeat, max_frames, stride));
  r->f = f;
  r->verify_crc = verify_crc != 0;
  return r;
}

const char* yt8m_error(Yt8mReader* r) { return r ? r->error.c_str() : "null"; }

void yt8m_close(Yt8mReader* r) {
  if (!r) return;
  if (r->f) fclose(r->f);
  delete r;
}

// Parse one video. feat_out: [out_rows * total_size] u8 (we write every
// byte: the padding rows are zeroed); labels_out: [labels_cap] i32;
// id_out: [id_cap] char. Returns 1 ok, 0 eof, -1 error.
int32_t yt8m_next(Yt8mReader* r, uint8_t* feat_out, int32_t* num_frames_out,
                  int32_t* labels_out, int32_t labels_cap,
                  int32_t* num_labels_out, char* id_out, int32_t id_cap) {
  int rc = r->next_record();
  if (rc <= 0) return rc;

  std::vector<int64_t> labels;
  StringView video_id;
  const char* err = decode_video(r->layout, r->record, feat_out, num_frames_out,
                                 &labels, &video_id);
  if (err) return r->fail(err), -1;

  // nl counts ALL labels; only the first labels_cap are stored. The
  // Python side raises when nl > labels_cap — silent truncation would
  // diverge from the pure-Python parser (which keeps every label), and
  // the loader sizes the cap to the vocabulary so valid records never
  // overflow.
  int32_t nl = 0;
  for (int64_t l : labels) {
    if (nl < labels_cap) labels_out[nl] = int32_t(l);
    nl++;
  }
  *num_labels_out = nl;
  copy_id(video_id, id_out, id_cap);
  return 1;
}

// Batched variant: fills up to `n` videos; returns the count (0 = eof,
// -1 = error). Strides are in elements.
int32_t yt8m_next_batch(Yt8mReader* r, int32_t n, uint8_t* feat_out,
                        int32_t* num_frames_out, int32_t* labels_out,
                        int32_t labels_cap, int32_t* num_labels_out,
                        char* ids_out, int32_t id_cap) {
  const size_t feat_stride = r->layout.video_bytes();
  int32_t count = 0;
  while (count < n) {
    int32_t rc = yt8m_next(r, feat_out + count * feat_stride,
                           num_frames_out + count,
                           labels_out + size_t(count) * labels_cap, labels_cap,
                           num_labels_out + count, ids_out + size_t(count) * id_cap,
                           id_cap);
    if (rc < 0) return -1;
    if (rc == 0) break;
    count++;
  }
  return count;
}

// Opens `num_readers` record streams over the files of `paths`, repeated
// `num_epochs` times (endless when negative), and starts a team of `team`
// threads (at least one). A thread takes a free stream, locates its next
// record from its header (the stream moving on to the next file of the
// list where one ends), claims the next row of the oldest block handed in
// with one free and gives the stream back; then it reads the record's
// bytes and decodes them into the row. Returns nullptr if the threads
// cannot start.
Batcher* yt8m_batcher_open(const char* const* paths, int32_t npaths,
                           int64_t num_epochs, const char* const* names,
                           const int32_t* sizes, int32_t nfeat, int32_t max_frames,
                           int32_t stride, int32_t vocab, int32_t labels_cap,
                           int32_t batch, int32_t id_cap, int32_t num_readers,
                           int32_t team) {
  auto* b = new Batcher(Layout(names, sizes, nfeat, max_frames, stride));
  for (int32_t i = 0; i < npaths; i++) b->files.emplace_back(paths[i]);
  b->files_total = num_epochs < 0 ? -1 : int64_t(npaths) * num_epochs;
  b->batch = batch;
  b->vocab = vocab;
  b->labels_cap = labels_cap;
  b->id_cap = id_cap;
  b->streams.resize(size_t(std::max(num_readers, 1)));
  team = std::max(team, 1);
  b->live = team;
  try {
    for (int32_t i = 0; i < team; i++)
      b->threads.emplace_back(&Batcher::run_member, b);
  } catch (const std::exception&) {
    {
      std::lock_guard<std::mutex> lk(b->mu);
      b->stop = true;
      b->live -= team - int32_t(b->threads.size());
    }
    yt8m_batcher_close(b);
    return nullptr;
  }
  return b;
}

// Hands in a block for the threads to fill; blocks go out in the order
// they came in.
void yt8m_batcher_add(Batcher* b, uint8_t* features, uint8_t* labels,
                      int32_t* num_frames, char* ids) {
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->blocks.push_back(Block{features, labels, num_frames, ids});
  }
  b->rows_free.notify_all();
}

// Waits up to `timeout_ms` for the oldest block handed in. Returns its
// rows, from then on the caller's and written by no thread (fewer than
// the batch only where the stream ended; 0: the stream has ended), -1 on
// an error (yt8m_batcher_error), -2 if the wait timed out.
int32_t yt8m_batcher_next(Batcher* b, int32_t timeout_ms) {
  std::unique_lock<std::mutex> lk(b->mu);
  if (b->blocks.empty()) {
    if (b->error.empty()) b->error = "no block handed in";
    return -1;
  }
  const bool ready = b->block_done.wait_for(
      lk, std::chrono::milliseconds(timeout_ms), [b] { return b->settled(); });
  if (!ready) return -2;
  if (!b->front_ready()) return -1;
  const int32_t rows = b->blocks.front().done;
  b->blocks.pop_front();
  return rows;
}

const char* yt8m_batcher_error(Batcher* b) { return b->error.c_str(); }

// How many stretches the team has logged and not yet given up.
int64_t yt8m_batcher_span_count(Batcher* b) {
  std::lock_guard<std::mutex> lk(b->mu);
  return int64_t(b->spans.size() / 4);
}

// Moves up to `cap` of the team's logged stretches, oldest first, into
// `out` as (kind, thread id, start ns, end ns) on CLOCK_REALTIME, and
// returns how many; with no `out`, drops them all. Kind 0 is a stream
// held to locate a record, 1 a record's read and decode into its row.
int64_t yt8m_batcher_spans(Batcher* b, int64_t* out, int64_t cap) {
  std::lock_guard<std::mutex> lk(b->mu);
  if (!out) {
    b->spans.clear();
    return 0;
  }
  const int64_t n = std::min<int64_t>(cap, int64_t(b->spans.size() / 4));
  std::copy(b->spans.begin(), b->spans.begin() + 4 * n, out);
  b->spans.erase(b->spans.begin(), b->spans.begin() + 4 * n);
  return n;
}

// The times a team thread found every stream held and waited for one,
// since the last call.
int64_t yt8m_batcher_stream_waits(Batcher* b) {
  std::lock_guard<std::mutex> lk(b->mu);
  const int64_t n = b->stream_waits;
  b->stream_waits = 0;
  return n;
}

// Stops and joins the threads, then frees the batcher (its files closed):
// no thread writes into a block after this returns.
void yt8m_batcher_close(Batcher* b) {
  if (!b) return;
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->stop = true;
  }
  b->rows_free.notify_all();
  b->stream_free.notify_all();
  for (auto& t : b->threads) t.join();
  delete b;
}

uint32_t yt8m_crc32c(const uint8_t* data, uint64_t n) { return crc32c(data, n); }

uint32_t yt8m_crc32c_ext(const uint8_t* data, uint64_t n, uint32_t start) {
  return crc32c_ext(data, n, start);
}

}  // extern "C"
