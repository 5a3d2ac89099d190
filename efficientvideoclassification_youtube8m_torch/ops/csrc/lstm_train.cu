// Train-mode bf16 LSTM recurrence of one layer, forward and backward, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of
// efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py:
//   * `_lstm_chunk_kernel_train_fwd` (called by `_train_fwd_pallas`): the
//     forward recurrence plus two residual streams, the UNMASKED
//     post-activations gates [T, B, 4H] f32 = [sigmoid(i), tanh(j),
//     sigmoid(f + forget_bias), sigmoid(o)] and the masked c_t, cs
//     [T, B, H] f32. Entry point `lstm_train_fwd_bf16`; the step kernel is
//     lstm_step.cuh's, with its train epilogue.
//   * `_lstm_chunk_kernel_train_bwd` (called in the custom VJP of
//     `make_lstm_layer_train_pallas`): the reverse-time dh/dc chain. Per
//     step t, from the carries (dc, dh) and the residuals:
//       dnew_h = valid ? dh + d_out[t] : 0
//       dnew_c = (valid ? dc : 0) + dnew_h * so * (1 - tanh(c_t)^2)
//       dgates = [dnew_c*tj*si*(1-si), dnew_c*si*(1-tj^2),
//                 dnew_c*c_{t-1}*sf*(1-sf), dnew_h*tanh(c_t)*so*(1-so)]
//       dh_{t-1} = hi @ Wh^T + lo @ Wh^T + (valid ? 0 : dh)
//       dc_{t-1} = dnew_c * sf + (valid ? 0 : dc)
//     with hi = bf16(dgates), lo = bf16(dgates - hi): the two-term split
//     keeps the sequential dh chain at about f32 precision on the left
//     operand, while the emitted stream dgates [T, B, 4H] is hi alone
//     (bf16). c_{-1} = 0. Entry point `lstm_train_bwd_bf16`.
//
// Backward design. Each step needs all of dgates_t in every block, for
// dh_{t-1} = dgates_t @ Wh^T (K = 4H). A dgates column of unit u depends
// only on unit u's dh, dc and residuals, so a block that owns a tile of
// BBM rows x BBU units of dh_{t-1} finishes step t-1's cell derivative
// for those units in its epilogue: it adds d_out[t-1], applies the mask,
// computes dnew_c and the four dgates columns u, H+u, 2H+u, 3H+u, writes
// hi to the bf16 stream (which the next launch reads back as its A
// operand) and lo to a ping-ponged bf16 scratch. dh and dc are carried in
// place in f32 [B, H] (each (row, unit) has one owner). A prologue launch
// does step T-1's cell derivative from dh_fin and dc_fin. So T launches
// per layer: the prologue and T-1 products; step 0's dh_{-1} is not
// needed (the initial state is constant). The product runs on the tensor
// cores (WMMA 16x16x16 bf16, f32 sums): hi and lo tiles share one
// accumulator, so dh_{t-1} = sum over k of (hi + lo) * Wh^T.
//
// What bounds them on this card. Forward: per step a [B, H] x [H, 4H]
// product plus the xp read and the residual writes (B*4H + B*H f32).
// Backward: per step a [B, 4H] x [4H, H] product taken twice (hi and lo,
// 2 * 2*B*4H*H flops) plus reading the residuals gates_t (B*4H f32), c_t,
// c_{t-1} and d_out, and writing dgates (B*4H bf16) and lo. Teacher L1's
// gates residual alone is 15 * 5120 * 4096 * 4 B = 1.26 GB per layer at
// batch 256: it goes out once in the forward and comes back once in the
// backward. At B=256 (L2, and the student) every step is latency-bound.
//
// What the simple design gives up: Wh (or Wh^T) is re-read from L2 by
// every row tile on every step, the K loops overlap their loads with the
// multiplies by one tile of register prefetch only, and there is no TMA
// and no wgmma; the lo term doubles the backward's multiplies where a
// split-free f32 path (TF32 or three-term bf16 on wgmma) may be cheaper.

#include "lstm_step.cuh"

namespace {

constexpr int BBM = 64;                      // rows of dh per block
constexpr int BBU = 32;                      // units of dh per block
constexpr int BBK = 32;                      // depth of one K tile (over 4H)
constexpr int BTHREADS = 128;                // 4 warps, 2 x 2
constexpr int BWM = BBM / 2;                 // 32 rows per warp
constexpr int BWN = BBU / 2;                 // 16 units per warp
constexpr int BFM = BWM / 16;                // 2 x 1 fragments per warp
constexpr int BA_LD = BBK + 8;               // bf16 row stride of hi/lo tiles
constexpr int BB_LD = BBU + 8;               // bf16 row stride of the Wh^T tile
constexpr int BC_LD = BBU + 4;               // f32 row stride of the sums
constexpr int BA_VECS = BBM * BBK / 8 / BTHREADS;   // uint4 per thread, per operand
constexpr int BB_VECS = BBK * BBU / 8 / BTHREADS;   // uint4 per thread

static_assert(BA_VECS == 2 && BB_VECS == 1, "tile loads assume 2 + 2 + 1 vectors");

// Step tp's cell derivative for (m, u): writes the four dgates columns
// of unit u as hi (the emitted bf16 stream) and lo, and returns the dc
// carry into step tp-1. dh_in and dc_in are the carries into step tp.
__device__ __forceinline__ float cell_grad(
    int tp, int m, int u, int H, int s, float dh_in, float dc_in,
    const float* __restrict__ gates_p,     // [B, 4H] residual of step tp
    const float* __restrict__ cs_p,        // [B, H] c_tp
    const float* __restrict__ cs_pp,       // [B, H] c_{tp-1}; unused at tp == 0
    const float* __restrict__ douts_p,     // [B, H] d_out[tp]
    __nv_bfloat16* __restrict__ hi_p,      // [B, 4H]
    __nv_bfloat16* __restrict__ lo_p) {    // [B, 4H]
  const size_t G = 4 * (size_t)H;
  const float* a = gates_p + (size_t)m * G;
  const float si = a[u];
  const float tj = a[H + u];
  const float sf = a[2 * H + u];
  const float so = a[3 * H + u];
  const size_t off = (size_t)m * H + u;
  const float tc = tanhf(cs_p[off]);
  const float c_prev = tp > 0 ? cs_pp[off] : 0.0f;
  const bool valid = tp < s;
  const float dnew_h = valid ? dh_in + douts_p[off] : 0.0f;
  const float dnew_c = (valid ? dc_in : 0.0f) + dnew_h * so * (1.0f - tc * tc);
  const float d[4] = {
      dnew_c * tj * si * (1.0f - si),
      dnew_c * si * (1.0f - tj * tj),
      dnew_c * c_prev * sf * (1.0f - sf),
      dnew_h * tc * so * (1.0f - so),
  };
  __nv_bfloat16* hi_row = hi_p + (size_t)m * G;
  __nv_bfloat16* lo_row = lo_p + (size_t)m * G;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const __nv_bfloat16 hi = __float2bfloat16(d[g]);
    hi_row[g * H + u] = hi;
    lo_row[g * H + u] = __float2bfloat16(d[g] - __bfloat162float(hi));
  }
  return dnew_c * sf + (valid ? 0.0f : dc_in);
}

// Step T-1's cell derivative from dh_fin (left in dh) and dc_fin (in dc,
// replaced by the carry into step T-2). One thread per (row, unit).
__global__ void lstm_bwd_last_step_kernel(
    const float* __restrict__ gates_p, const float* __restrict__ cs_p,
    const float* __restrict__ cs_pp, const float* __restrict__ douts_p,
    const int* __restrict__ seq, const float* __restrict__ dh,
    float* __restrict__ dc, __nv_bfloat16* __restrict__ hi_p,
    __nv_bfloat16* __restrict__ lo_p, int tp, int B, int H) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * H) return;
  const int m = idx / H;
  const int u = idx % H;
  dc[idx] = cell_grad(tp, m, u, H, seq[m], dh[idx], dc[idx], gates_p, cs_p,
                      cs_pp, douts_p, hi_p, lo_p);
}

// dh_{t-1} = (hi_t + lo_t) @ Wh^T for a tile of BBM rows x BBU units,
// then step t-1's cell derivative for that tile.
__global__ void __launch_bounds__(BTHREADS) lstm_bwd_step_kernel(
    const __nv_bfloat16* __restrict__ hi_t,   // [B, 4H] dgates[t]
    const __nv_bfloat16* __restrict__ lo_t,   // [B, 4H]
    const __nv_bfloat16* __restrict__ wht,    // [4H, H]
    const float* __restrict__ gates_p,        // [B, 4H] residual of step t-1
    const float* __restrict__ cs_p,           // [B, H] c_{t-1}
    const float* __restrict__ cs_pp,          // [B, H] c_{t-2}; unused at t == 1
    const float* __restrict__ douts_p,        // [B, H] d_out[t-1]
    const int* __restrict__ seq,              // [B]
    float* __restrict__ dh,                   // [B, H] carry, in place
    float* __restrict__ dc,                   // [B, H] carry, in place
    __nv_bfloat16* __restrict__ hi_p,         // [B, 4H] dgates[t-1]
    __nv_bfloat16* __restrict__ lo_p,         // [B, 4H]
    int t, int B, int H) {
  __shared__ __align__(128) __nv_bfloat16 hi_s[BBM * BA_LD];
  __shared__ __align__(128) __nv_bfloat16 lo_s[BBM * BA_LD];
  __shared__ __align__(128) __nv_bfloat16 w_s[BBK * BB_LD];
  __shared__ __align__(128) float c_s[BBM * BC_LD];

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * BBU;
  const int m0 = blockIdx.y * BBM;
  const int G = 4 * H;

  uint4 hi_reg[BA_VECS], lo_reg[BA_VECS], w_reg[BB_VECS];

  // Global -> registers for the K tile starting at k0 (G % BBK == 0 since
  // H % 8 == 0); rows past B and units past H read as zero.
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < BA_VECS; ++v) {
      const int idx = tid + v * BTHREADS;
      const int m = m0 + idx / (BBK / 8);
      const int k = k0 + (idx % (BBK / 8)) * 8;
      hi_reg[v] = make_uint4(0u, 0u, 0u, 0u);
      lo_reg[v] = make_uint4(0u, 0u, 0u, 0u);
      if (m < B) {
        hi_reg[v] = *reinterpret_cast<const uint4*>(hi_t + (size_t)m * G + k);
        lo_reg[v] = *reinterpret_cast<const uint4*>(lo_t + (size_t)m * G + k);
      }
    }
#pragma unroll
    for (int v = 0; v < BB_VECS; ++v) {
      const int idx = tid + v * BTHREADS;
      const int k = k0 + idx / (BBU / 8);
      const int u = u0 + (idx % (BBU / 8)) * 8;
      w_reg[v] = make_uint4(0u, 0u, 0u, 0u);
      if (u < H) {
        w_reg[v] = *reinterpret_cast<const uint4*>(wht + (size_t)k * H + u);
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < BA_VECS; ++v) {
      const int idx = tid + v * BTHREADS;
      const int row = idx / (BBK / 8);
      const int kq = (idx % (BBK / 8)) * 8;
      *reinterpret_cast<uint4*>(hi_s + row * BA_LD + kq) = hi_reg[v];
      *reinterpret_cast<uint4*>(lo_s + row * BA_LD + kq) = lo_reg[v];
    }
#pragma unroll
    for (int v = 0; v < BB_VECS; ++v) {
      const int idx = tid + v * BTHREADS;
      const int kl = idx / (BBU / 8);
      const int q = (idx % (BBU / 8)) * 8;
      *reinterpret_cast<uint4*>(w_s + kl * BB_LD + q) = w_reg[v];
    }
  };

  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BFM];
#pragma unroll
  for (int i = 0; i < BFM; ++i) wmma::fill_fragment(acc[i], 0.0f);

  const int num_k = G / BBK;
  load_tile(0);
  for (int kt = 0; kt < num_k; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < num_k) load_tile((kt + 1) * BBK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, w_s + (kk * 16) * BB_LD + wn * BWN, BB_LD);
#pragma unroll
      for (int i = 0; i < BFM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        const int a_off = (wm * BWM + i * 16) * BA_LD + kk * 16;
        wmma::load_matrix_sync(af, hi_s + a_off, BA_LD);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
        wmma::load_matrix_sync(af, lo_s + a_off, BA_LD);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BFM; ++i)
    wmma::store_matrix_sync(c_s + (wm * BWM + i * 16) * BC_LD + wn * BWN,
                            acc[i], BC_LD, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: one (row, unit) per thread per pass, a warp on 32
  // neighbouring units of one row.
  const int uu = tid % BBU;
  const int u = u0 + uu;
  if (u >= H) return;
  for (int r = tid / BBU; r < BBM; r += BTHREADS / BBU) {
    const int m = m0 + r;
    if (m >= B) break;
    const size_t off = (size_t)m * H + u;
    const int s = seq[m];
    const float dh_prev = c_s[r * BC_LD + uu] + (t < s ? 0.0f : dh[off]);
    dh[off] = dh_prev;
    dc[off] = cell_grad(t - 1, m, u, H, s, dh_prev, dc[off], gates_p, cs_p,
                        cs_pp, douts_p, hi_p, lo_p);
  }
}

}  // namespace

extern "C" {

// Runs the T forward steps of one layer on `stream`, writing outs
// [T, B, H] bf16 and the residuals gates [T, B, 4H] and cs [T, B, H] f32.
// `h` holds two [B, H] f32 buffers; h[0] must be zero on entry and the
// final h ends in h[T % 2]. `c` must be zero on entry and holds the final
// c on return. Returns the first launch error (a cudaError_t), or 0.
// Does not synchronise.
int lstm_train_fwd_bf16(const void* xp, const void* wh, const void* bias,
                        const void* seq, void* outs, void* gates, void* cs,
                        void* c, void* h, int T, int B, int H,
                        float forget_bias, void* stream) {
  const dim3 grid((H + BU - 1) / BU, (B + BM - 1) / BM);
  const size_t bh = (size_t)B * H;
  const auto* xp_bf = static_cast<const __nv_bfloat16*>(xp);
  auto* outs_bf = static_cast<__nv_bfloat16*>(outs);
  auto* gates_f = static_cast<float*>(gates);
  auto* cs_f = static_cast<float*>(cs);
  auto* h_f = static_cast<float*>(h);
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        xp_bf + (size_t)t * 4 * bh, static_cast<const __nv_bfloat16*>(wh),
        static_cast<const float*>(bias), static_cast<const int*>(seq),
        h_f + (t % 2) * bh, h_f + ((t + 1) % 2) * bh, static_cast<float*>(c),
        outs_bf + (size_t)t * bh, gates_f + (size_t)t * 4 * bh,
        cs_f + (size_t)t * bh, t, B, H, forget_bias);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Runs the T backward steps of one layer on `stream`, writing dgates
// [T, B, 4H] bf16 (the hi part). `wht` is Wh^T [4H, H] bf16; `gates`,
// `cs` and `douts` are f32 [T, B, 4H], [T, B, H], [T, B, H]. On entry `dh`
// and `dc` hold dh_fin and dc_fin ([B, H] f32); they are overwritten.
// `lo` is a [2, B, 4H] bf16 scratch. Returns the first launch error (a
// cudaError_t), or 0. Does not synchronise.
int lstm_train_bwd_bf16(const void* wht, const void* gates, const void* cs,
                        const void* douts, const void* seq, void* dh,
                        void* dc, void* dgates, void* lo, int T, int B,
                        int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t bh = (size_t)B * H;
  const auto* gates_f = static_cast<const float*>(gates);
  const auto* cs_f = static_cast<const float*>(cs);
  const auto* douts_f = static_cast<const float*>(douts);
  const auto* seq_i = static_cast<const int*>(seq);
  auto* dh_f = static_cast<float*>(dh);
  auto* dc_f = static_cast<float*>(dc);
  auto* hi_bf = static_cast<__nv_bfloat16*>(dgates);
  auto* lo_bf = static_cast<__nv_bfloat16*>(lo);
  auto c_at = [&](int t) { return t > 0 ? cs_f + (size_t)(t - 1) * bh : nullptr; };

  const int tl = T - 1;
  const int threads = 256;
  lstm_bwd_last_step_kernel<<<(unsigned)((bh + threads - 1) / threads), threads, 0, st>>>(
      gates_f + (size_t)tl * 4 * bh, cs_f + (size_t)tl * bh, c_at(tl),
      douts_f + (size_t)tl * bh, seq_i, dh_f, dc_f, hi_bf + (size_t)tl * 4 * bh,
      lo_bf + (size_t)(tl % 2) * 4 * bh, tl, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((H + BBU - 1) / BBU, (B + BBM - 1) / BBM);
  for (int t = tl; t >= 1; --t) {
    const int tp = t - 1;
    lstm_bwd_step_kernel<<<grid, BTHREADS, 0, st>>>(
        hi_bf + (size_t)t * 4 * bh, lo_bf + (size_t)(t % 2) * 4 * bh,
        static_cast<const __nv_bfloat16*>(wht), gates_f + (size_t)tp * 4 * bh,
        cs_f + (size_t)tp * bh, c_at(tp), douts_f + (size_t)tp * bh, seq_i,
        dh_f, dc_f, hi_bf + (size_t)tp * 4 * bh, lo_bf + (size_t)(tp % 2) * 4 * bh,
        t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
