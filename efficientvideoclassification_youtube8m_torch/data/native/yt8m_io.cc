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
// Wire format notes: TFRecord framing is {u64 len, u32 masked crc(len),
// data, u32 masked crc(data)}; SequenceExample is
//   { Features context = 1; FeatureLists feature_lists = 2; }
// with Features/FeatureLists being map<string, Feature/FeatureList> and
// Feature { BytesList=1 | FloatList=2 | Int64List=3 }.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
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

struct Yt8mReader {
  FILE* f = nullptr;
  std::vector<std::string> names;
  std::vector<int32_t> sizes;
  std::vector<int32_t> col_offsets;  // column offset per feature
  int32_t total_size = 0;
  int32_t max_frames = 0;
  int32_t stride = 1;     // keep every stride-th frame (student paths)
  int32_t out_rows = 0;   // ceil(max_frames / stride): rows per video
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
    constexpr uint64_t kMaxRecordBytes = 1ull << 30;
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

}  // namespace

extern "C" {

Yt8mReader* yt8m_open(const char* path, const char* const* names,
                      const int32_t* sizes, int32_t nfeat, int32_t max_frames,
                      int32_t verify_crc, int32_t stride) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  auto* r = new Yt8mReader();
  r->f = f;
  r->max_frames = max_frames;
  r->stride = stride < 1 ? 1 : stride;
  r->out_rows = (max_frames + r->stride - 1) / r->stride;
  r->verify_crc = verify_crc != 0;
  int32_t off = 0;
  for (int32_t i = 0; i < nfeat; i++) {
    r->names.emplace_back(names[i]);
    r->sizes.push_back(sizes[i]);
    r->col_offsets.push_back(off);
    off += sizes[i];
  }
  r->total_size = off;
  return r;
}

const char* yt8m_error(Yt8mReader* r) { return r ? r->error.c_str() : "null"; }

void yt8m_close(Yt8mReader* r) {
  if (!r) return;
  if (r->f) fclose(r->f);
  delete r;
}

// Parse one video. feat_out: [max_frames * total_size] u8 (caller-zeroed or
// we zero pad rows); labels_out: [labels_cap] i32; id_out: [id_cap] char.
// Returns 1 ok, 0 eof, -1 error.
int32_t yt8m_next(Yt8mReader* r, uint8_t* feat_out, int32_t* num_frames_out,
                  int32_t* labels_out, int32_t labels_cap,
                  int32_t* num_labels_out, char* id_out, int32_t id_cap) {
  int rc = r->next_record();
  if (rc <= 0) return rc;

  Cursor top{r->record.data(), r->record.data() + r->record.size()};
  StringView video_id;
  std::vector<int64_t> labels;
  int32_t num_frames = -1;

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
              video_id = feature_first_bytes(feat);
            } else if (key.eq("labels")) {
              feature_int64s(feat, &labels);
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
          for (size_t fi = 0; fi < r->names.size(); fi++) {
            if (key.p == nullptr || key.n != r->names[fi].size() ||
                memcmp(key.p, r->names[fi].data(), key.n) != 0)
              continue;
            const int32_t size = r->sizes[fi];
            const int32_t col = r->col_offsets[fi];
            int32_t frame = 0;
            Cursor fl = flist;
            while (fl.ok && !fl.done()) {
              uint64_t ltag = fl.varint();
              if (!fl.ok) break;
              if ((ltag >> 3) == 1 && (ltag & 7) == 2) {  // Feature
                uint64_t ln = fl.varint();
                Cursor feat = fl.slice(ln);
                if (frame < r->max_frames) {
                  // every frame's payload size is still VALIDATED (the
                  // pure-Python parser rejects corrupt frames too); the
                  // stride only skips the memcpy of dropped frames
                  StringView bytes = feature_first_bytes(feat);
                  if (bytes.p && int32_t(bytes.n) != size) {
                    r->fail("frame feature size mismatch");
                    return -1;
                  }
                  if (bytes.p && frame % r->stride == 0) {
                    memcpy(feat_out +
                               size_t(frame / r->stride) * r->total_size + col,
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
              r->fail("per-feature frame counts differ");
              return -1;
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
  if (!top.ok) {
    r->fail("malformed SequenceExample");
    return -1;
  }

  if (num_frames < 0) num_frames = 0;
  if (num_frames > r->max_frames) num_frames = r->max_frames;
  // num_frames reports the ORIGINAL (capped) count even under stride —
  // the consumers' seq-length math runs on original frame counts
  *num_frames_out = num_frames;
  // zero the padding rows of the (possibly strided) output
  const int32_t kept = (num_frames + r->stride - 1) / r->stride;
  if (kept < r->out_rows)
    memset(feat_out + size_t(kept) * r->total_size, 0,
           size_t(r->out_rows - kept) * r->total_size);

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

  int32_t idn = int32_t(video_id.n);
  if (idn >= id_cap) idn = id_cap - 1;
  if (idn > 0) memcpy(id_out, video_id.p, idn);
  id_out[idn < 0 ? 0 : idn] = '\0';
  return 1;
}

// Batched variant: fills up to `n` videos; returns the count (0 = eof,
// -1 = error). Strides are in elements.
int32_t yt8m_next_batch(Yt8mReader* r, int32_t n, uint8_t* feat_out,
                        int32_t* num_frames_out, int32_t* labels_out,
                        int32_t labels_cap, int32_t* num_labels_out,
                        char* ids_out, int32_t id_cap) {
  const size_t feat_stride = size_t(r->out_rows) * r->total_size;
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

uint32_t yt8m_crc32c(const uint8_t* data, uint64_t n) { return crc32c(data, n); }

uint32_t yt8m_crc32c_ext(const uint8_t* data, uint64_t n, uint32_t start) {
  return crc32c_ext(data, n, start);
}

}  // extern "C"
