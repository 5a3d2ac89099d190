// One step of the bf16 LSTM recurrence of one layer, for Hopper (sm_90a),
// shared by the forward-only scan (lstm_chunk_scan.cu) and the train
// forward (lstm_train.cu). Same math and layouts as the TPU kernels of
// efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py:
//   xp_t [B, 4H] bf16 (x @ Wx, no bias)
//   Wh   [H, 4H] bf16, gate g of unit u in column g*H + u (TF order i, j, f, o)
//   bias [4H] f32, seq [B] int32
//   gates = (f32(xp_t) + bias) + bf16(h_{t-1}) @ Wh   (f32 accumulation)
//   c_t = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
//   h_t = tanh(c_t) * sigmoid(o)
//   t >= seq[b]: c and h frozen, out_t[b] = 0
// With kTrain the epilogue also writes the train residuals of step t:
// the post-activations [sigmoid(i), tanh(j), sigmoid(f + forget_bias),
// sigmoid(o)] of every row, t >= seq included (gates_t [B, 4H] f32), and
// the masked c_t (cs_t [B, H] f32).
//
// Design. The Pallas kernels kept the whole bf16 Wh (8 MB at H=1024)
// resident in one core's VMEM for all T steps. One SM has 227 KB of
// shared memory, so that does not carry over. Here the time loop runs on
// the host: one launch per step, all on the caller's stream, none
// synchronising. A block owns a tile of BM batch rows x BU hidden units
// and computes all four gate columns (u, H+u, 2H+u, 3H+u) of those units,
// so the whole cell update stays inside the block: the K loop over H
// multiplies bf16 tiles of h and Wh in shared memory on the tensor cores
// (WMMA 16x16x16, f32 accumulation), the sums go through shared memory,
// and the epilogue adds xp and the bias, applies the gates and the mask,
// updates c in place (each (row, unit) has one owner), and writes h_next
// (f32) and out_t (bf16). h is ping-ponged between two f32 [B, H]
// buffers, because every block reads all of h_prev. Ragged B and H (any
// H that is a multiple of 8) are masked inside the kernel.
//
// What bounds it on this card: each step is a [B, H] x [H, 4H] product
// (2*B*4H*H flops) plus one read of xp_t (B*4H bf16) and of c/h, and with
// kTrain a write of B*4H + B*H f32 residuals. At the student's B=256 (L2)
// a step is ~2 GFLOP over 128 blocks: latency-bound, dominated by the K
// loop's load-sync-multiply chain and the launch. At B=1280..5120 (L1)
// the tensor-core work dominates.
//
// What the simple design gives up: Wh is re-read from L2 (it fits the
// 50 MB L2) by every row tile on every step (ceil(B/BM) * 8 MB per step),
// h_prev by every unit tile, and the K loop does not overlap its shared
// memory traffic with the multiplies beyond one tile of register
// prefetch. A persistent kernel that keeps a slice of Wh in shared memory
// across steps, TMA loads and wgmma are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;                 // batch rows per block
constexpr int BU = 32;                 // hidden units per block
constexpr int BN = 4 * BU;             // gate columns per block
constexpr int BK = 32;                 // depth of one shared-memory K tile
constexpr int THREADS = 256;           // 8 warps
constexpr int WARPS_N = 4;             // warp grid 2 (rows) x 4 (columns)
constexpr int WM = BM / 2;             // 32 rows per warp
constexpr int WN = BN / WARPS_N;       // 32 columns per warp
constexpr int FM = WM / 16;            // 2 x 2 fragments per warp
constexpr int FN = WN / 16;
constexpr int A_LD = BK + 8;           // bf16 row stride of the h tile
constexpr int B_LD = BN + 8;           // bf16 row stride of the Wh tile
constexpr int C_LD = BN + 4;           // f32 row stride of the gate sums
constexpr int A_VECS = BM * BK / 4 / THREADS;          // float4 per thread
constexpr int B_VECS = BK * 4 * (BU / 8) / THREADS;    // uint4 per thread

static_assert(A_VECS == 2 && B_VECS == 2, "tile loads assume 2 vectors each");

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kTrain>
__global__ void __launch_bounds__(THREADS) lstm_step_kernel(
    const __nv_bfloat16* __restrict__ xp_t,   // [B, 4H]
    const __nv_bfloat16* __restrict__ wh,     // [H, 4H]
    const float* __restrict__ bias,           // [4H]
    const int* __restrict__ seq,              // [B]
    const float* __restrict__ h_prev,         // [B, H]
    float* __restrict__ h_next,               // [B, H]
    float* __restrict__ c,                    // [B, H], updated in place
    __nv_bfloat16* __restrict__ out_t,        // [B, H]
    float* __restrict__ gates_t,              // [B, 4H], kTrain only
    float* __restrict__ cs_t,                 // [B, H], kTrain only
    int t, int B, int H, float forget_bias) {
  __shared__ __align__(128) __nv_bfloat16 a_s[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 b_s[BK * B_LD];
  __shared__ __align__(128) float c_s[BM * C_LD];

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * BU;
  const int m0 = blockIdx.y * BM;
  const size_t G = 4 * (size_t)H;

  float4 a_reg[A_VECS];
  uint4 b_reg[B_VECS];

  // Global -> registers for the K tile starting at k0; out-of-range rows,
  // units and depths read as zero. H % 8 == 0 keeps every vector whole.
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int row = idx / (BK / 4);
      const int k = k0 + (idx % (BK / 4)) * 4;
      const int m = m0 + row;
      a_reg[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < B && k < H) {
        a_reg[v] = *reinterpret_cast<const float4*>(h_prev + (size_t)m * H + k);
      }
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int k = k0 + idx / 16;
      const int g = (idx % 16) / 4;
      const int u = u0 + (idx % 4) * 8;
      b_reg[v] = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && u < H) {
        b_reg[v] = *reinterpret_cast<const uint4*>(wh + (size_t)k * G + (size_t)g * H + u);
      }
    }
  };

  // Registers -> shared memory; h is rounded to bf16 here (round to
  // nearest even, as the TPU kernel's astype).
  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int row = idx / (BK / 4);
      const int kq = (idx % (BK / 4)) * 4;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a_s + row * A_LD + kq);
      dst[0] = __floats2bfloat162_rn(a_reg[v].x, a_reg[v].y);
      dst[1] = __floats2bfloat162_rn(a_reg[v].z, a_reg[v].w);
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int kl = idx / 16;
      const int g = (idx % 16) / 4;
      const int q = (idx % 4) * 8;
      *reinterpret_cast<uint4*>(b_s + kl * B_LD + g * BU + q) = b_reg[v];
    }
  };

  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int num_k = (H + BK - 1) / BK;
  load_tile(0);
  for (int kt = 0; kt < num_k; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < num_k) load_tile((kt + 1) * BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_s + (wm * WM + i * 16) * A_LD + kk * 16, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b_s + (kk * 16) * B_LD + wn * WN + j * 16, B_LD);
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
    const float* acc_row = c_s + r * C_LD;
    const __nv_bfloat16* x = xp_t + (size_t)m * G;
    const float gi = (__bfloat162float(x[u]) + bias[u]) + acc_row[uu];
    const float gj = (__bfloat162float(x[H + u]) + bias[H + u]) + acc_row[BU + uu];
    const float gf = (__bfloat162float(x[2 * H + u]) + bias[2 * H + u]) + acc_row[2 * BU + uu];
    const float go = (__bfloat162float(x[3 * H + u]) + bias[3 * H + u]) + acc_row[3 * BU + uu];
    const float si = sigmoid_f32(gi);
    const float tj = tanhf(gj);
    const float sf = sigmoid_f32(gf + forget_bias);
    const float so = sigmoid_f32(go);
    const size_t off = (size_t)m * H + u;
    const float c_old = c[off];
    const float new_c = c_old * sf + si * tj;
    const float new_h = tanhf(new_c) * so;
    const bool valid = t < seq[m];
    const float c_kept = valid ? new_c : c_old;
    c[off] = c_kept;
    h_next[off] = valid ? new_h : h_prev[off];
    out_t[off] = __float2bfloat16(valid ? new_h : 0.0f);
    if constexpr (kTrain) {
      float* g_row = gates_t + (size_t)m * G;
      g_row[u] = si;
      g_row[H + u] = tj;
      g_row[2 * H + u] = sf;
      g_row[3 * H + u] = so;
      cs_t[off] = c_kept;
    }
  }
}

}  // namespace
