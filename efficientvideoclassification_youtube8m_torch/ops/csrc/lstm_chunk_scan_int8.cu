// Forward-only int8 LSTM recurrence of one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lstm_chunk_kernel_int8`
// (efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py,
// called through `lstm_chunk_scan_pallas_int8`). Same math, same layouts:
//   xp       [T, B, 4H] bf16, time-major (the dequantized int8 x @ Wx, no bias)
//   Wh_q     [H, 4H] int8, gate g of unit u in column g*H + u (TF order i, j, f, o)
//   wh_scale [4H] f32 (per-column weight scales), bias [4H] f32, seq [B] int32
// Each step t, for every row b:
//   h_scale[b] = max(max_u |h[b, u]| / 127, 1e-12)
//   h_q[b]     = clip(round_half_even(h[b] / h_scale[b]), -127, 127)   (int8)
//   acc        = h_q @ Wh_q                                            (int32, exact)
//   gates      = (f32(xp_t) + bias) + (f32(acc) * h_scale[b]) * wh_scale
//   c_t = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
//   h_t = tanh(c_t) * sigmoid(o)
//   t >= seq[b]: c and h frozen, out_t[b] = 0 (a frozen h is re-quantized
//   the next step, as in the TPU kernel)
// Outputs: outs [T, B, H] bf16, final c and h [B, H] f32.
//
// Numerics. The scale is a true quotient (IEEE), and h_q rounds to nearest
// even (rintf, as jnp.round and torch.round) the true quotient h / h_scale,
// reached by a reciprocal product that rounds the same way (see quantize
// below); the int32 sums are exact. The gate and cell arithmetic is
// written with explicit _rn intrinsics, so the compiler fuses no
// multiply-add: every operation rounds where the plain PyTorch version
// (one kernel per operation) rounds. Do not build with --use_fast_math: an
// approximate quotient one ulp off can flip a rounding tie of h_q.
//
// What bounds it on this card (ops/kernels/bounds.py): a row-step is 8*H^2
// int8 operations against 10*H bytes of xp and outs, so at the flagship
// shapes the tensor cores' 1,979 TOP/s bound it, except at student L2
// (5 x 256), where the 4 MiB of Wh_q read once weigh more.
//
// Design. The time loop runs on the host, all on the caller's stream: two
// launches a step. quantize_rows_kernel (a warp a row, the row read once)
// writes h_q int8 [B, H] and h_scale [B]; the row scale needs max|h| over
// all H units of a row, which no block of the product owns. The step
// kernel follows the bf16 one (lstm_step.cuh): a block owns BM = 64*WGS
// batch rows x BU hidden units and all four gate columns of those units
// (N = 4*BU); Wh_q comes packed into K-major slabs (the layout of
// ops/kernels/layout.pack_wh), so a block's B operand is one contiguous
// box. One producer warp keeps a ring of 128-deep int8 K tiles of h_q and
// Wh_q in flight with TMA (128B-swizzled boxes of 128 bytes, the bf16
// ring's bytes a row); WGS consumer warpgroups each multiply their 64
// rows by the whole N on wgmma (m64 x N x k32, s8 x s8 -> s32 in
// registers) and release a stage once the wgmma that read it has
// retired. The gate epilogue runs on the int32 accumulators in registers
// (a thread holds the same (row, unit) pairs of all four gates); what it
// reads besides them (xp, c, seq, the row scales, a frozen row's h) is
// loaded before the products, so its latency hides behind the pipeline
// fill, and the block's columns of bias and wh_scale wait in shared
// memory. TMA needs 16-byte row strides, so H % 16 == 0; the wrapper
// (ops/kernels/lstm_scan_int8.py) zero-pads other widths.
//
// The quantize pass stays a launch of its own: quantizing inside the step
// kernel (one launch a step; partial row maxima by atomicMax, quantized
// tiles shared across a cluster) was 1.4-1.7x slower at every flagship
// shape on an H100 (PERF.md), since a block then waits for its rows'
// quantization before its first product.
//
// What it still gives up: as the bf16 kernel, Wh_q is re-read from L2 by
// every row tile on every step, the host time loop pays two launches and
// a pipeline fill every step, and the epilogue does not overlap the next
// tile's products.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK8 = kRowBytes;  // int8 depth of one K tile: one 128-byte row
constexpr int Q_THREADS = 256;   // quantize_rows_kernel: 8 warps, one row each
constexpr int Q_ROWS = Q_THREADS / 32;
constexpr int Q_VECS = 8;        // float4s of h a lane holds: rows of H <= 1024

template <int WGS, int BU>
struct Int8Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int BN = 4 * BU;
  static constexpr int THREADS = 128 * WGS + 32;  // consumers, then the producer warp
  static constexpr int A_BYTES = BM * kBK8;       // one K tile of h_q, all warpgroups
  static constexpr int STAGE_BYTES = A_BYTES + BN * kBK8;
  static constexpr int STAGES = 4;  // depth of the TMA ring
  // Dynamic shared memory: the ring, then its mbarriers.
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static constexpr int MIN_BLOCKS = SMEM + 8 * BN <= kTwoBlockSmem ? 2 : 1;
};

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
}

// A row's scale and its reciprocal rounded to nearest.
struct RowScale {
  float scale, inv;
};

__device__ __forceinline__ RowScale with_inverse(float scale) {
  return {scale, __frcp_rn(scale)};
}

// clip(rint(RN(x / scale)), -127, 127), with rint rounding half to even,
// without a division for nearly every x. |x / scale| <= 127 (1 + 2^-23)
// since |x| <= amax, and x * inv (inv = RN(1 / scale)) is within
// (2^-23 + 2^-24) |x / scale| <= 2.3e-5 of RN(x / scale). So where x * inv
// lies more than 5e-5 from a half-way point n + 1/2, RN(x / scale) lies on
// the same side of it and rounds to the same integer; nearer, the true
// quotient is taken (a few inputs in 10^4).
__device__ __forceinline__ int quantize(float x, RowScale s) {
  const float t = __fmul_rn(x, s.inv);
  float r = rintf(t);
  if (fabsf(__fsub_rn(t, r)) > 0.49995f) r = rintf(__fdiv_rn(x, s.scale));
  return static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// A warp a row. Rows of up to 32 * 4 * Q_VECS units are read once, all
// their loads in flight together, and quantized from registers; longer
// rows are read twice.
__global__ void __launch_bounds__(Q_THREADS) quantize_rows_kernel(
    const float* __restrict__ h,       // [B, H]
    signed char* __restrict__ h_q,     // [B, H]
    float* __restrict__ h_scale,       // [B]
    int B, int H) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * Q_ROWS + threadIdx.x / 32;
  if (m >= B) return;  // the whole warp
  const float* row = h + (size_t)m * H;
  char4* q_row = reinterpret_cast<char4*>(h_q + (size_t)m * H);
  const bool in_regs = H <= 128 * Q_VECS;
  float4 v[Q_VECS];
  float amax = 0.0f;
  if (in_regs) {
#pragma unroll
    for (int i = 0; i < Q_VECS; ++i) {
      const int k = (lane + 32 * i) * 4;
      v[i] = k < H ? *reinterpret_cast<const float4*>(row + k)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < Q_VECS; ++i) {
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                               fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
  } else {
    for (int k = lane * 4; k < H; k += 128) {
      const float4 x = *reinterpret_cast<const float4*>(row + k);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const RowScale scale = with_inverse(row_scale(amax));
  if (lane == 0) h_scale[m] = scale.scale;
  if (in_regs) {
#pragma unroll
    for (int i = 0; i < Q_VECS; ++i) {
      const int k = (lane + 32 * i) * 4;
      if (k < H) {
        q_row[k / 4] = make_char4(quantize(v[i].x, scale), quantize(v[i].y, scale),
                                  quantize(v[i].z, scale), quantize(v[i].w, scale));
      }
    }
  } else {
    for (int k = lane * 4; k < H; k += 128) {
      const float4 x = *reinterpret_cast<const float4*>(row + k);
      q_row[k / 4] = make_char4(quantize(x.x, scale), quantize(x.y, scale),
                                quantize(x.z, scale), quantize(x.w, scale));
    }
  }
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The epilogue's inputs of one consumer thread. In the wgmma layout
// thread (warp w, lane l) of a warpgroup holds units uu, uu+1 (uu =
// 2 (l % 4) + 8 j) of rows m and m+8 (m = 16 w + l / 4, the two halves)
// for each 8-unit block j, in all four gates: acc[4 (g BU/8 + j) + 2 half
// + e]. The four lanes with one l / 4 hold one row.
template <int BU>
struct EpilogueIn {
  int m_lane, uu_lane;
  int len[2];
  float hs[2];
  __nv_bfloat162 xp[2][BU / 8][4];
  float2 c[2][BU / 8];
  float2 h[2][BU / 8];  // the carried h of a frozen row (t >= len), else 0

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ xp_t,
                                       const int* __restrict__ seq,
                                       const float* __restrict__ h_scale,
                                       const float* __restrict__ h_prev,
                                       const float* __restrict__ c_in, int t, int B, int H) {
    const size_t G = 4 * (size_t)H;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_lane + 8 * half;
      const bool row = m < B;
      len[half] = row ? seq[m] : 0;
      hs[half] = row ? h_scale[m] : 1.0f;
      const bool frozen = row && t >= len[half];
#pragma unroll
      for (int j = 0; j < BU / 8; ++j) {
        const int u = blockIdx.x * BU + uu_lane + 8 * j;
        const bool in = row && u < H;
        const size_t off = (size_t)m * H + u;
        c[half][j] = in ? *reinterpret_cast<const float2*>(c_in + off) : make_float2(0.0f, 0.0f);
        h[half][j] = in && frozen ? *reinterpret_cast<const float2*>(h_prev + off)
                                  : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          xp[half][j][g] = in ? *reinterpret_cast<const __nv_bfloat162*>(
                                    xp_t + (size_t)m * G + g * H + u)
                              : __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
    }
  }
};

template <int WGS, int BU>
__global__ void __launch_bounds__(Int8Tile<WGS, BU>::THREADS,
                                  Int8Tile<WGS, BU>::MIN_BLOCKS) lstm_int8_step_kernel(
    const __grid_constant__ CUtensorMap a_map,   // h_q int8 [B, H]
    const __grid_constant__ CUtensorMap w_map,   // packed Wh_q int8 [tiles * 4BU, H]
    const __nv_bfloat16* __restrict__ xp_t,      // [B, 4H]
    const float* __restrict__ wh_scale,          // [4H]
    const float* __restrict__ bias,              // [4H]
    const int* __restrict__ seq,                 // [B]
    const float* __restrict__ h_scale,           // [B]
    const float* __restrict__ h_prev,            // [B, H]
    float* __restrict__ h_next,                  // [B, H]
    float* __restrict__ c,                       // [B, H], updated in place
    __nv_bfloat16* __restrict__ out_t,           // [B, H]
    int t, int B, int H, float forget_bias) {
  using Tile = Int8Tile<WGS, BU>;
  constexpr int BN = Tile::BN;
  extern __shared__ uint8_t smem_raw[];
  // the block's columns of bias and wh_scale, gate g of unit uu at g*BU + uu
  __shared__ __align__(16) float col_bias[BN];
  __shared__ __align__(16) float col_scale[BN];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_k = (H + kBK8 - 1) / kBK8;
  const int m0 = blockIdx.y * Tile::BM;
  uint8_t* ring = align_1024(smem_raw);  // STAGES x ([BM][128] A, [BN][128] B)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tile::STAGES * Tile::STAGE_BYTES);
  uint64_t* empty = full + Tile::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  for (int i = threadIdx.x; i < BN; i += Tile::THREADS) {
    const int u = blockIdx.x * BU + i % BU;
    const int col = (i / BU) * H + u;
    col_bias[i] = u < H ? bias[col] : 0.0f;
    col_scale[i] = u < H ? wh_scale[col] : 0.0f;
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // Producer: one lane keeps the ring full.
    if (lane == 0) {
      prefetch_map(&a_map);
      prefetch_map(&w_map);
      const int n0 = blockIdx.x * BN;
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % Tile::STAGES;
        if (kt >= Tile::STAGES) mbar_wait(&empty[s], ((kt / Tile::STAGES) - 1) & 1);
        uint8_t* stage = ring + s * Tile::STAGE_BYTES;
        mbar_expect_tx(&full[s], Tile::STAGE_BYTES);
        tma_load(stage, &a_map, &full[s], kt * kBK8, m0, 0);
        tma_load(stage + Tile::A_BYTES, &w_map, &full[s], kt * kBK8, n0, 0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows 64*wg .. 64*wg + 63 of the tile.
  const int wg = warp / 4;
  const int m_wg = m0 + wg * 64;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // What the epilogue reads besides the products, loaded first so that
  // its latency hides behind the pipeline fill.
  EpilogueIn<BU> in;
  in.m_lane = m_wg + (warp % 4) * 16 + lane / 4;
  in.uu_lane = 2 * (lane % 4);
  in.load(xp_t, seq, h_scale, h_prev, c, t, B, H);

  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt % Tile::STAGES;
    const uint8_t* stage = ring + s * Tile::STAGE_BYTES;
    const uint8_t* a = stage + wg * 64 * kBK8;
    const uint8_t* b = stage + Tile::A_BYTES;
    mbar_wait(&full[s], (kt / Tile::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK8 / 32; ++kk) {
      wgmma_s8_n128(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have retired
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % Tile::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue, on the registers: the products, then the cell update.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = in.m_lane + 8 * half;
    if (m < B) {
      const float hs = in.hs[half];
      const bool valid = t < in.len[half];
#pragma unroll
      for (int j = 0; j < BU / 8; ++j) {
        const int uu = in.uu_lane + 8 * j;
        const int u = blockIdx.x * BU + uu;
        if (u >= H) continue;  // H % 16 == 0, so u + 1 < H too
        float gate[4][2];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int idx = 4 * (g * (BU / 8) + j) + 2 * half;
          const float2 xv = __bfloat1622float2(in.xp[half][j][g]);
          const float2 bv = *reinterpret_cast<const float2*>(col_bias + g * BU + uu);
          const float2 wv = *reinterpret_cast<const float2*>(col_scale + g * BU + uu);
          gate[g][0] = __fadd_rn(__fadd_rn(xv.x, bv.x),
                                 __fmul_rn(__fmul_rn(__int2float_rn(acc[idx]), hs), wv.x));
          gate[g][1] = __fadd_rn(__fadd_rn(xv.y, bv.y),
                                 __fmul_rn(__fmul_rn(__int2float_rn(acc[idx + 1]), hs), wv.y));
        }
        const float2 c_old = in.c[half][j];
        const float2 h_old = in.h[half][j];
        float c_new[2], h_new[2], out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float si = sigmoid_rn(gate[0][e]);
          const float tj = tanhf(gate[1][e]);
          const float sf = sigmoid_rn(__fadd_rn(gate[2][e], forget_bias));
          const float so = sigmoid_rn(gate[3][e]);
          const float co = e == 0 ? c_old.x : c_old.y;
          const float nc = __fadd_rn(__fmul_rn(co, sf), __fmul_rn(si, tj));
          const float nh = __fmul_rn(tanhf(nc), so);
          c_new[e] = valid ? nc : co;
          h_new[e] = valid ? nh : (e == 0 ? h_old.x : h_old.y);
          out[e] = valid ? nh : 0.0f;
        }
        const size_t off = (size_t)m * H + u;
        *reinterpret_cast<float2*>(c + off) = make_float2(c_new[0], c_new[1]);
        *reinterpret_cast<float2*>(h_next + off) = make_float2(h_new[0], h_new[1]);
        *reinterpret_cast<__nv_bfloat162*>(out_t + off) = __floats2bfloat162_rn(out[0], out[1]);
      }
    }
  }
}

// The T steps of one layer on `stream` with tile (64*WGS, BU); see
// lstm_chunk_scan_int8 below for the buffers.
template <int WGS, int BU>
int run_tile(const __nv_bfloat16* xp, const void* wpk, const float* ws, const float* bias,
             const int* seq, __nv_bfloat16* outs, float* c, float* h, signed char* h_q,
             float* h_scale, int T, int B, int H, float forget_bias, cudaStream_t stream) {
  using Tile = Int8Tile<WGS, BU>;
  const int tiles = (H + BU - 1) / BU;
  CUtensorMap a_map, w_map;
  int err = make_map(&a_map, h_q, H, B, 1, Tile::BM, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0) {
    err = make_map(&w_map, wpk, H, (uint64_t)tiles * Tile::BN, 1, Tile::BN,
                   CU_TENSOR_MAP_DATA_TYPE_UINT8);
  }
  if (err != 0) return err;
  auto kernel = lstm_int8_step_kernel<WGS, BU>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          Tile::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(tiles, (B + Tile::BM - 1) / Tile::BM);
  const dim3 q_grid((B + Q_ROWS - 1) / Q_ROWS);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const float* h_prev = h + (t % 2) * bh;
    quantize_rows_kernel<<<q_grid, Q_THREADS, 0, stream>>>(h_prev, h_q, h_scale, B, H);
    kernel<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(
        a_map, w_map, xp + (size_t)t * 4 * bh, ws, bias, seq, h_scale, h_prev,
        h + ((t + 1) % 2) * bh, c, outs + (size_t)t * bh, t, B, H, forget_bias);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return 0;
}

}  // namespace

extern "C" {

// Runs all T steps of one layer on `stream` with the tile (bm rows, bu
// units) of ops/kernels/layout.int8_tile. `wpk` is Wh_q packed by
// ops/kernels/layout.pack_wh for bu. `h` holds two [B, H] f32 buffers;
// h[0] must be zero on entry and the final h ends in h[T % 2]. `c` must
// be zero on entry and holds the final c on return. `h_q` ([B, H] int8)
// and `h_scale` ([B] f32) are scratch. H % 16 == 0. Returns the first
// error (see lstm_chunk_scan_int8_error_string), or 0. Does not
// synchronise.
int lstm_chunk_scan_int8(const void* xp, const void* wpk, const void* wh_scale,
                         const void* bias, const void* seq, void* outs, void* c,
                         void* h, void* h_q, void* h_scale, int T, int B, int H,
                         int bm, int bu, float forget_bias, void* stream) {
  const auto* xp_bf = static_cast<const __nv_bfloat16*>(xp);
  const auto* ws_f = static_cast<const float*>(wh_scale);
  const auto* bias_f = static_cast<const float*>(bias);
  const auto* seq_i = static_cast<const int*>(seq);
  auto* outs_bf = static_cast<__nv_bfloat16*>(outs);
  auto* c_f = static_cast<float*>(c);
  auto* h_f = static_cast<float*>(h);
  auto* hq = static_cast<signed char*>(h_q);
  auto* hs = static_cast<float*>(h_scale);
  auto st = static_cast<cudaStream_t>(stream);
#define LSTM_INT8_TILE(BM_, BU_)                                                             \
  if (bm == BM_ && bu == BU_) {                                                             \
    return run_tile<BM_ / 64, BU_>(xp_bf, wpk, ws_f, bias_f, seq_i, outs_bf, c_f, h_f, hq, \
                                   hs, T, B, H, forget_bias, st);                            \
  }
  LSTM_INT8_TILE(128, 32)
  LSTM_INT8_TILE(64, 32)
#undef LSTM_INT8_TILE
  return hopper::kErrTile;
}

// The quantize pass of one step alone, on `stream`: h_q ([B, H] int8) and
// h_scale ([B] f32) of h ([B, H] f32), H % 4 == 0. Returns a cudaError_t,
// or 0.
int lstm_int8_quantize_rows(const void* h, void* h_q, void* h_scale, int B, int H,
                            void* stream) {
  quantize_rows_kernel<<<(B + Q_ROWS - 1) / Q_ROWS, Q_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<signed char*>(h_q),
      static_cast<float*>(h_scale), B, H);
  return static_cast<int>(cudaGetLastError());
}

const char* lstm_chunk_scan_int8_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
