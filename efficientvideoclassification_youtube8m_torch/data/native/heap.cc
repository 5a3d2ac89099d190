// Bulk (prediction, label) heap pushes for the AP calculators.
//
// The GAP/mAP parity contract pins not just the AP formula but the HEAP
// LAYOUT: the reference stores ranked entries via heapq
// (average_precision_calculator.py:117-122) and its seeded tie-break
// shuffle permutes heap POSITIONS, so exact score parity requires
// reproducing CPython heapq's array order bit-for-bit. This kernel
// replays heapq.heappush / heapq.heapreplace semantics (lexicographic
// (prediction, label) tuple comparison) over parallel double arrays —
// one C call per batch instead of one Python heappush per entry.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// Python tuple comparison (p1, a1) < (p2, a2). NaN scores compare
// "not less" from either side, matching float __lt__.
inline bool lt(double p1, double a1, double p2, double a2) {
  if (p1 != p2) return p1 < p2;
  return a1 < a2;
}

// heapq._siftdown: bubble the item at `pos` up toward `startpos`.
inline void siftdown(double* hp, double* ha, int64_t startpos, int64_t pos) {
  const double np = hp[pos], na = ha[pos];
  while (pos > startpos) {
    const int64_t parent = (pos - 1) >> 1;
    if (lt(np, na, hp[parent], ha[parent])) {
      hp[pos] = hp[parent];
      ha[pos] = ha[parent];
      pos = parent;
    } else {
      break;
    }
  }
  hp[pos] = np;
  ha[pos] = na;
}

// heapq._siftup: move the item at `pos` down to a leaf (always swapping
// with the smaller child), then restore with _siftdown — CPython's exact
// two-phase algorithm, which leaves a different layout than the
// textbook compare-with-children variant.
inline void siftup(double* hp, double* ha, int64_t pos, int64_t endpos) {
  const int64_t startpos = pos;
  const double np = hp[pos], na = ha[pos];
  int64_t childpos = 2 * pos + 1;
  while (childpos < endpos) {
    const int64_t rightpos = childpos + 1;
    if (rightpos < endpos &&
        !lt(hp[childpos], ha[childpos], hp[rightpos], ha[rightpos])) {
      childpos = rightpos;
    }
    hp[pos] = hp[childpos];
    ha[pos] = ha[childpos];
    pos = childpos;
    childpos = 2 * pos + 1;
  }
  hp[pos] = np;
  ha[pos] = na;
  siftdown(hp, ha, startpos, pos);
}

}  // namespace

extern "C" {

// Push n (p, a) pairs into the heap stored in hp/ha (current length
// `size`; caller guarantees capacity for min(size+n, top_n) entries).
// top_n < 0 means unbounded (plain heappush); otherwise the bounded
// accumulate rule: push while under top_n, then heapreplace when the
// new prediction beats the root (average_precision_calculator.py:117-122).
// Returns the new heap length.
int64_t ap_heap_push(double* hp, double* ha, int64_t size, int64_t top_n,
                     const double* p, const double* a, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (top_n < 0 || size < top_n) {
      hp[size] = p[i];
      ha[size] = a[i];
      siftdown(hp, ha, 0, size);
      ++size;
    } else if (top_n > 0 && p[i] > hp[0]) {
      hp[0] = p[i];
      ha[0] = a[i];
      siftup(hp, ha, 0, size);
    }
  }
  return size;
}

// Heapify `nseg` contiguous segments of the parallel (p, a) arrays in
// place. Each segment [starts[i], ends[i]) is turned into the EXACT
// layout CPython heapq would produce by heappushing the segment's
// elements left to right into an empty heap (position j is the
// "append", siftdown restores the invariant) — the epoch-end bulk path
// for the 4716 per-class AP heaps: one C call instead of one Python
// accumulate() per class.
void ap_heap_build_segments(double* p, double* a, const int64_t* starts,
                            const int64_t* ends, int64_t nseg) {
  for (int64_t s = 0; s < nseg; ++s) {
    double* hp = p + starts[s];
    double* ha = a + starts[s];
    const int64_t len = ends[s] - starts[s];
    for (int64_t i = 0; i < len; ++i) siftdown(hp, ha, 0, i);
  }
}

// Stable counting-sort group-by over the parallel (classes, preds, acts)
// triplet arrays: writes the class-sorted streams into out_p/out_a and
// the per-class entry counts into counts[0..num_class). Within a class,
// entries keep arrival order — identical to the stable composite-key
// argsort in eval_util._class_sorted, but O(n) with two passes instead
// of O(n log n): at the 28M-entry YT8M epoch flush this is ~0.5s vs
// ~10s of introsort. Segment starts are the exclusive prefix sum of
// counts, so callers also skip the np.unique segment scan.
void group_by_class_sort(const int64_t* classes, const double* preds,
                         const double* acts, int64_t n, int64_t num_class,
                         int64_t* counts, double* out_p, double* out_a) {
  for (int64_t c = 0; c < num_class; ++c) counts[c] = 0;
  for (int64_t i = 0; i < n; ++i) ++counts[classes[i]];
  std::vector<int64_t> pos(num_class);
  int64_t acc = 0;
  for (int64_t c = 0; c < num_class; ++c) {
    pos[c] = acc;
    acc += counts[c];
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t j = pos[classes[i]]++;
    out_p[j] = preds[i];
    out_a[j] = acts[i];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// CPython-exact seeded shuffle permutation.
//
// The reference tie-break is `random.seed(0); random.sample(range(n), n)`
// (average_precision_calculator.py:234-240) — Python-speed for the
// millions of pooled entries an epoch accumulates. This replays CPython's
// Mersenne Twister (_randommodule.c) and random.sample's pool algorithm
// bit-for-bit; tests/test_metrics_fast.py validates the permutation
// against the Python implementation for a range of sizes.

namespace {

struct MT19937 {
  static constexpr int N = 624, M = 397;
  static constexpr uint32_t MATRIX_A = 0x9908b0dfu;
  static constexpr uint32_t UPPER_MASK = 0x80000000u, LOWER_MASK = 0x7fffffffu;
  uint32_t mt[N];
  int mti = N + 1;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < N; mti++) {
      mt[mti] = 1812433253u * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) +
                static_cast<uint32_t>(mti);
    }
  }

  void init_by_array(const uint32_t* init_key, int key_length) {
    init_genrand(19650218u);
    int i = 1, j = 0;
    int k = (N > key_length ? N : key_length);
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525u)) +
              init_key[j] + static_cast<uint32_t>(j);
      i++; j++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
      if (j >= key_length) j = 0;
    }
    for (k = N - 1; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941u)) -
              static_cast<uint32_t>(i);
      i++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
    }
    mt[0] = 0x80000000u;
  }

  uint32_t genrand() {
    uint32_t y;
    static const uint32_t mag01[2] = {0u, MATRIX_A};
    if (mti >= N) {
      int kk;
      for (kk = 0; kk < N - M; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + M] ^ (y >> 1) ^ mag01[y & 1u];
      }
      for (; kk < N - 1; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + (M - N)] ^ (y >> 1) ^ mag01[y & 1u];
      }
      y = (mt[N - 1] & UPPER_MASK) | (mt[0] & LOWER_MASK);
      mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ mag01[y & 1u];
      mti = 0;
    }
    y = mt[mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= (y >> 18);
    return y;
  }

  // Random.getrandbits(k) for k in [1, 32] (_randommodule.c).
  uint32_t getrandbits(int k) { return genrand() >> (32 - k); }

  // Random._randbelow_with_getrandbits(n) for n >= 1.
  uint64_t randbelow(uint64_t n) {
    int k = 64 - __builtin_clzll(n);  // n.bit_length()
    if (k <= 32) {
      uint32_t r = getrandbits(k);
      while (r >= n) r = getrandbits(k);
      return r;
    }
    // getrandbits(k>32): CPython fills 32-bit words low-to-high, the
    // LAST word truncated to the remaining bits.
    for (;;) {
      uint64_t lo = genrand();
      uint64_t hi = static_cast<uint64_t>(genrand()) >> (64 - k);
      uint64_t r = lo | (hi << 32);
      if (r < n) return r;
    }
  }
};

}  // namespace

extern "C" {

// out[0..n) := random.seed(seed); random.sample(range(n), n) — for
// k == n, random.sample always takes its pool branch (the selection-set
// branch needs setsize > n, impossible at k == n), so this is exact.
void ap_sample_perm(uint32_t seed, int64_t n, int64_t* out) {
  MT19937 rng;
  // random.seed(int): abs value split into 32-bit chunks little-endian;
  // 0 still yields one key word (_randommodule.c random_seed).
  uint32_t key[2] = {seed, 0};
  rng.init_by_array(key, 1);
  if (n <= 0) return;
  // pool algorithm (random.sample, Lib/random.py): result[i] = pool[j],
  // then pool[j] = pool[n-i-1]
  int64_t* pool = new int64_t[n];
  for (int64_t i = 0; i < n; ++i) pool[i] = i;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t j = rng.randbelow(static_cast<uint64_t>(n - i));
    out[i] = pool[j];
    pool[j] = pool[n - i - 1];
  }
  delete[] pool;
}

// Full AP@n sweep over `nseg` heap segments — shuffle, stable descending
// sort, and the reference's sequential precision accumulation
// (average_precision_calculator.py:186-223), all bit-for-bit:
//   * the seeded shuffle is the MT19937 sample replay above;
//   * std::stable_sort with a strict `<` on scores == Python's stable
//     sorted(reverse=True) tie behavior;
//   * ap accumulates poscount/(i+1)*delta_recall left to right in
//     doubles — the same IEEE op sequence as the Python loop.
// top_n < 0 means unbounded (the epoch per-class/global calculators).
//
// Large segments (the epoch GLOBAL calculator pools tens of millions of
// entries) take a stable LSD radix path instead of the index-indirect
// introsort: doubles map to monotone u64 keys (sign-flip trick, -0.0
// canonicalized to +0.0 so key equality == comparator equivalence), a
// stable ascending radix on the COMPLEMENT key is exactly a stable
// descending sort, and ties keep the shuffled arrival order — the
// resulting rank/actual sequence, and hence the AP doubles, are
// bit-identical to the stable_sort path (pinned in tests). ~5x at 28M.

namespace {

constexpr int64_t kRadixMinN = 1 << 17;

// Stable 4x16-bit LSD radix sort of (key, pos-flag) pairs, ascending.
void radix_sort_pairs(std::vector<uint64_t>& key, std::vector<uint8_t>& flag,
                      std::vector<uint64_t>& key_tmp,
                      std::vector<uint8_t>& flag_tmp,
                      std::vector<int64_t>& cnt, int64_t n) {
  // cnt is caller-owned scratch (like every other vector here): ctypes
  // releases the GIL, so function-local statics would race across threads.
  cnt.assign(1 << 16, 0);
  uint64_t* k = key.data();
  uint8_t* f = flag.data();
  uint64_t* kt = key_tmp.data();
  uint8_t* ft = flag_tmp.data();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 16;
    if (pass) std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t i = 0; i < n; ++i) ++cnt[(k[i] >> shift) & 0xFFFF];
    // all keys share this digit: the pass is the identity — skip it
    if (cnt[(k[0] >> shift) & 0xFFFF] == n) continue;
    int64_t acc = 0;
    for (int64_t d = 0; d < (1 << 16); ++d) {
      const int64_t c = cnt[d];
      cnt[d] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      const int64_t j = cnt[(k[i] >> shift) & 0xFFFF]++;
      kt[j] = k[i];
      ft[j] = f[i];
    }
    std::swap(k, kt);
    std::swap(f, ft);
  }
  if (f != flag.data()) std::copy(f, f + n, flag.data());
}

}  // namespace

void ap_sweep_segments(const double* preds, const double* acts,
                       const int64_t* starts, const int64_t* ends,
                       const double* num_pos, int64_t top_n, uint32_t seed,
                       int64_t nseg, double* out) {
  std::vector<int64_t> perm, order;
  std::vector<double> sp, sa;
  std::vector<uint64_t> key, key_tmp;
  std::vector<uint8_t> flag, flag_tmp;
  std::vector<int64_t> cnt;
  for (int64_t s = 0; s < nseg; ++s) {
    const int64_t n = ends[s] - starts[s];
    double numpos = num_pos[s];
    if (n <= 0 || numpos == 0.0) {
      out[s] = 0.0;
      continue;
    }
    if (top_n > 0 && numpos > static_cast<double>(top_n))
      numpos = static_cast<double>(top_n);
    const double delta_recall = 1.0 / numpos;
    const double* p = preds + starts[s];
    const double* a = acts + starts[s];
    perm.resize(n);
    ap_sample_perm(seed, n, perm.data());
    const int64_t r = (top_n > 0 && top_n < n) ? top_n : n;
    double ap = 0.0, poscount = 0.0;
    if (n >= kRadixMinN) {
      key.resize(n);
      flag.resize(n);
      key_tmp.resize(n);
      flag_tmp.resize(n);
      for (int64_t i = 0; i < n; ++i) {
        double d = p[perm[i]];
        if (d == 0.0) d = 0.0;  // -0.0 -> +0.0: ties stay ties
        // NaN ranks LAST like the numpy fallback (argsort sorts NaN
        // keys to the end); the raw bit pattern would rank a positive
        // NaN FIRST, and a NaN comparator breaks strict weak ordering
        if (std::isnan(d)) d = -std::numeric_limits<double>::infinity();
        uint64_t u;
        std::memcpy(&u, &d, 8);
        u = (u >> 63) ? ~u : (u | 0x8000000000000000ULL);
        key[i] = ~u;  // ascending radix == descending double
        flag[i] = a[perm[i]] > 0.0 ? 1 : 0;
      }
      radix_sort_pairs(key, flag, key_tmp, flag_tmp, cnt, n);
      for (int64_t i = 0; i < r; ++i) {
        if (flag[i]) {
          poscount += 1.0;
          ap += poscount / static_cast<double>(i + 1) * delta_recall;
        }
      }
    } else {
      sp.resize(n);
      sa.resize(n);
      for (int64_t i = 0; i < n; ++i) {
        double d = p[perm[i]];
        // NaN -> -inf: 'sp[x] > sp[y]' with NaN violates strict weak
        // ordering (UB for std::stable_sort); -inf ranks last, stable
        // order among them, matching the radix path and the numpy
        // fallback
        sp[i] = std::isnan(d)
                    ? -std::numeric_limits<double>::infinity() : d;
        sa[i] = a[perm[i]];
      }
      order.resize(n);
      for (int64_t i = 0; i < n; ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t x, int64_t y) { return sp[x] > sp[y]; });
      for (int64_t i = 0; i < r; ++i) {
        if (sa[order[i]] > 0.0) {
          poscount += 1.0;
          ap += poscount / static_cast<double>(i + 1) * delta_recall;
        }
      }
    }
    out[s] = ap;
  }
}

}  // extern "C"
