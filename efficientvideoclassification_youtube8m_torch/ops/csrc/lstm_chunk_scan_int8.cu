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
// Numerics. Both divisions are true quotients (IEEE, no reciprocal) and the
// rounding is to nearest even (rintf), as jnp.round and torch.round; the
// int32 sums are exact. The gate and cell arithmetic is written with
// explicit _rn intrinsics, so the compiler fuses no multiply-add: every
// operation rounds where the plain PyTorch version (one kernel per
// operation) rounds. Do not build with --use_fast_math: an approximate
// quotient one ulp off can flip a rounding tie of h_q.
//
// Design. The Pallas kernel kept the whole int8 Wh (4 MB at H=1024)
// resident in one core's VMEM and quantized its own tile of rows. Here, as
// in the bf16 kernel (lstm_step.cuh), the time loop runs on the host, two
// launches a step, all on the caller's stream, none synchronising:
//   1. quantize_rows_kernel: one warp per row reduces max|h| over all H
//      units (the scale needs the whole row, which no block of the product
//      owns) and writes h_q int8 [B, H] and h_scale f32 [B];
//   2. lstm_int8_step_kernel: a block owns BM batch rows x BU hidden units
//      and all four gate columns of those units; the K loop multiplies int8
//      tiles of h_q and Wh_q in shared memory on the tensor cores (WMMA
//      16x16x16 s8 with int32 accumulation), and the epilogue rescales,
//      applies the gates and the mask, updates c in place and writes h_next
//      (f32, ping-ponged) and out_t (bf16). Its launch bounds ask for two
//      blocks an SM (at most 128 registers a thread; 143 without them):
//      on an H100 that took student L1 from 1.06 to 0.82 ms and teacher
//      L1 from 10.4 to 7.3 ms, with the same results bit for bit.
// Global loads are 8-byte vectors (8 int8): H % 8 == 0 keeps every vector
// whole and aligned, also where a gate's columns start at g*H with H not a
// multiple of 16 (the ragged H=48 case). For 8-bit WMMA the fragment
// pointers must be 256-bit aligned with a stride that is a multiple of 16
// bytes, so the tiles are kept in shared memory as 16-byte-wide chunks:
// h_q as [k chunk][row][16], Wh_q as [column chunk][k][16].
//
// What bounds it on this card: each step is a [B, H] x [H, 4H] int8 product
// (2*B*4H*H operations) plus one read of xp_t (B*4H bf16), of h and c, and
// of Wh_q from L2 by every row tile. At the student's B=256 a step is
// ~2 GOP over 128 blocks: bound by latency (two launches, the K loop's
// load-sync-multiply chain), as the bf16 kernel is. Keeping Wh_q resident
// in shared memory across steps (a persistent kernel), fusing the row
// quantization into the product's prologue, TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int Q_THREADS = 256;             // quantize: 8 warps, one row each
constexpr int Q_ROWS = Q_THREADS / 32;

constexpr int BM = 64;                     // batch rows per block
constexpr int BU = 32;                     // hidden units per block
constexpr int BN = 4 * BU;                 // gate columns per block
constexpr int BK = 64;                     // depth of one shared-memory K tile
constexpr int KC = BK / 16;                // 16-deep k chunks in a tile
constexpr int THREADS = 256;               // 8 warps, two blocks an SM
constexpr int WARPS_N = 4;                 // warp grid 2 (rows) x 4 (columns)
constexpr int WM = BM / 2;                 // 32 rows per warp
constexpr int WN = BN / WARPS_N;           // 32 columns per warp
constexpr int FM = WM / 16;                // 2 x 2 fragments per warp
constexpr int FN = WN / 16;
constexpr int C_LD = BN + 4;               // int32 row stride of the sums
constexpr int A_VECS = BM * BK / 8 / THREADS;   // 8-byte vectors per thread
constexpr int B_VECS = BK * BN / 8 / THREADS;

static_assert(A_VECS == 2 && B_VECS == 4, "tile loads assume 2 + 4 vectors");

__device__ __forceinline__ signed char quantize(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));  // round half to even
  return static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(Q_THREADS) quantize_rows_kernel(
    const float* __restrict__ h,       // [B, H]
    signed char* __restrict__ h_q,     // [B, H]
    float* __restrict__ h_scale,       // [B]
    int B, int H) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * Q_ROWS + threadIdx.x / 32;
  if (m >= B) return;  // the whole warp
  const float* row = h + (size_t)m * H;
  float amax = 0.0f;
  for (int k = lane * 4; k < H; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (lane == 0) h_scale[m] = scale;
  char4* q_row = reinterpret_cast<char4*>(h_q + (size_t)m * H);
  for (int k = lane * 4; k < H; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    q_row[k / 4] = make_char4(quantize(v.x, scale), quantize(v.y, scale),
                              quantize(v.z, scale), quantize(v.w, scale));
  }
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__global__ void __launch_bounds__(THREADS, 2) lstm_int8_step_kernel(
    const __nv_bfloat16* __restrict__ xp_t,   // [B, 4H]
    const signed char* __restrict__ wh,       // [H, 4H]
    const float* __restrict__ wh_scale,       // [4H]
    const float* __restrict__ bias,           // [4H]
    const int* __restrict__ seq,              // [B]
    const signed char* __restrict__ h_q,      // [B, H]
    const float* __restrict__ h_scale,        // [B]
    const float* __restrict__ h_prev,         // [B, H]
    float* __restrict__ h_next,               // [B, H]
    float* __restrict__ c,                    // [B, H], updated in place
    __nv_bfloat16* __restrict__ out_t,        // [B, H]
    int t, int B, int H, float forget_bias) {
  __shared__ __align__(256) signed char a_s[KC * BM * 16];          // [kc][row][16]
  __shared__ __align__(256) signed char b_s[(BN / 16) * BK * 16];   // [nc][k][16]
  __shared__ __align__(256) int c_s[BM * C_LD];

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * BU;
  const int m0 = blockIdx.y * BM;
  const size_t G = 4 * (size_t)H;

  uint2 a_reg[A_VECS];
  uint2 b_reg[B_VECS];

  // Global -> registers for the K tile starting at k0; out-of-range rows,
  // units and depths read as zero. H % 8 == 0 keeps every vector whole.
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int m = m0 + idx / (BK / 8);
      const int k = k0 + (idx % (BK / 8)) * 8;
      a_reg[v] = make_uint2(0u, 0u);
      if (m < B && k < H) {
        a_reg[v] = *reinterpret_cast<const uint2*>(h_q + (size_t)m * H + k);
      }
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int k = k0 + idx / (BN / 8);
      const int g = (idx % (BN / 8)) / (BU / 8);
      const int u = u0 + (idx % (BU / 8)) * 8;
      b_reg[v] = make_uint2(0u, 0u);
      if (k < H && u < H) {
        b_reg[v] = *reinterpret_cast<const uint2*>(wh + (size_t)k * G + (size_t)g * H + u);
      }
    }
  };

  // Registers -> the chunked shared-memory tiles.
  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int row = idx / (BK / 8);
      const int kq = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint2*>(a_s + (kq / 16) * BM * 16 + row * 16 + kq % 16) = a_reg[v];
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int kl = idx / (BN / 8);
      const int n = ((idx % (BN / 8)) / (BU / 8)) * BU + (idx % (BU / 8)) * 8;
      *reinterpret_cast<uint2*>(b_s + (n / 16) * BK * 16 + kl * 16 + n % 16) = b_reg[v];
    }
  };

  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int num_k = (H + BK - 1) / BK;
  load_tile(0);
  for (int kt = 0; kt < num_k; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < num_k) load_tile((kt + 1) * BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_s + kk * BM * 16 + (wm * WM + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b_s + ((wn * WN + j * 16) / 16) * BK * 16 + kk * 16 * 16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(c_s + (wm * WM + i * 16) * C_LD + wn * WN + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: one (row, unit) per thread per pass; a warp covers 32
  // neighbouring units of one row, so global accesses are coalesced.
  const int uu = tid % BU;
  const int u = u0 + uu;
  if (u >= H) return;
  for (int r = tid / BU; r < BM; r += THREADS / BU) {
    const int m = m0 + r;
    if (m >= B) break;
    const int* acc_row = c_s + r * C_LD;
    const __nv_bfloat16* x = xp_t + (size_t)m * G;
    const float hs = h_scale[m];
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * H + u;
      const float xb = __fadd_rn(__bfloat162float(x[col]), bias[col]);
      const float prod = __fmul_rn(__fmul_rn(__int2float_rn(acc_row[g * BU + uu]), hs),
                                   wh_scale[col]);
      gate[g] = __fadd_rn(xb, prod);
    }
    const float si = sigmoid_f32(gate[0]);
    const float tj = tanhf(gate[1]);
    const float sf = sigmoid_f32(__fadd_rn(gate[2], forget_bias));
    const float so = sigmoid_f32(gate[3]);
    const size_t off = (size_t)m * H + u;
    const float c_old = c[off];
    const float new_c = __fadd_rn(__fmul_rn(c_old, sf), __fmul_rn(si, tj));
    const float new_h = __fmul_rn(tanhf(new_c), so);
    const bool valid = t < seq[m];
    c[off] = valid ? new_c : c_old;
    h_next[off] = valid ? new_h : h_prev[off];
    out_t[off] = __float2bfloat16(valid ? new_h : 0.0f);
  }
}

}  // namespace

extern "C" {

// Runs all T steps of one layer on `stream`. `h` holds two [B, H] f32
// buffers; h[0] must be zero on entry and the final h ends in h[T % 2].
// `c` must be zero on entry and holds the final c on return. `h_q` ([B, H]
// int8) and `h_scale` ([B] f32) are scratch. Returns the first launch error
// (a cudaError_t), or 0. Does not synchronise.
int lstm_chunk_scan_int8(const void* xp, const void* wh_q, const void* wh_scale,
                         const void* bias, const void* seq, void* outs, void* c,
                         void* h, void* h_q, void* h_scale, int T, int B, int H,
                         float forget_bias, void* stream) {
  const dim3 grid((H + BU - 1) / BU, (B + BM - 1) / BM);
  const dim3 q_grid((B + Q_ROWS - 1) / Q_ROWS);
  const size_t bh = (size_t)B * H;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp_bf = static_cast<const __nv_bfloat16*>(xp);
  auto* outs_bf = static_cast<__nv_bfloat16*>(outs);
  auto* h_f = static_cast<float*>(h);
  auto* hq = static_cast<signed char*>(h_q);
  auto* hs = static_cast<float*>(h_scale);
  for (int t = 0; t < T; ++t) {
    const float* h_prev = h_f + (t % 2) * bh;
    quantize_rows_kernel<<<q_grid, Q_THREADS, 0, s>>>(h_prev, hq, hs, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    lstm_int8_step_kernel<<<grid, THREADS, 0, s>>>(
        xp_bf + (size_t)t * B * 4 * (size_t)H, static_cast<const signed char*>(wh_q),
        static_cast<const float*>(wh_scale), static_cast<const float*>(bias),
        static_cast<const int*>(seq), hq, hs, h_prev, h_f + ((t + 1) % 2) * bh,
        static_cast<float*>(c), outs_bf + (size_t)t * bh, t, B, H, forget_bias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* lstm_chunk_scan_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
