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
// BM rows x BN units of dh_{t-1} finishes step t-1's cell derivative for
// those units in its epilogue: it adds d_out[t-1], applies the mask,
// computes dnew_c and the four dgates columns u, H+u, 2H+u, 3H+u, writes
// hi to the bf16 stream (which the next launch reads back as its A
// operand) and lo to a ping-ponged bf16 scratch. dh and dc are carried in
// place in f32 [B, H] (each (row, unit) has one owner). A prologue launch
// does step T-1's cell derivative from dh_fin and dc_fin. So T launches
// per layer: the prologue and T-1 products; step 0's dh_{-1} is not
// needed (the initial state is constant).
//
// The product is a TMA-fed wgmma pipeline like the forward's
// (lstm_step.cuh): one producer warp keeps a ring of kStages = 4 stages in
// flight, each holding the 64-deep K tiles of hi and lo (BM rows each)
// and the matching tile of Wh (BN rows of units; Wh [H, 4H] read as it
// is, since it is K-major for this product), completed on mbarriers;
// WGS = BM/64 consumer warpgroups run two wgmmas a k16 slice into the
// same f32 accumulator, so dh_{t-1} = sum over k of (hi + lo) * Wh^T
// keeps the split's precision. The epilogue runs on the registers: a
// thread holds units u, u+1 of rows m and m+8 for each 8-unit block. The
// host picks the tile (ops/kernels/layout.backward_tile): 64 x 128 units
// where that gives every SM two blocks (teacher L1), else 64 x 32 (student
// L1 and the B=256 layers). A stage holds the 64-deep tiles of hi and lo
// (BM rows each) and of Wh (BN units): 32 KiB at 64 x 128.
//
// What bounds them on this card (ops/kernels/bounds.py). Forward: see
// lstm_step.cuh (memory, 30 KiB a row-step). Backward: a row-step is a
// [4H] x [4H, H] product taken twice (hi and lo), 16*H^2 flops (16.8
// MFLOP at H=1024), against 32*H bytes of residuals, cotangents and
// dgates: bound by the tensor cores, over T-1 steps 1.216 ms at teacher
// L1 (T=15, B=5120), 0.083 at teacher L2 (20 x 256), 0.109 at student L1
// (6 x 1280), 0.017 at student L2 (5 x 256). Teacher L1's gates residual
// alone is 15 * 5120 * 4096 * 4 B = 1.26 GB per layer at batch 256: it
// goes out once in the forward and comes back once in the backward.
//
// What the design still gives up: Wh is re-read from L2 by every row
// tile on every step and hi/lo by every unit tile (sharing hi and lo
// across a cluster by TMA multicast was no faster); the host time loop
// pays a launch and a pipeline fill every step; the epilogue does not
// overlap the next tile's products; the lo term doubles the backward's
// multiplies where a split-free f32 path would change the dh chain's
// precision; and at B=256 no persistent Wh-resident design yet.

#include "lstm_step.cuh"

namespace {

// Step tp's cell derivative for one (row, unit) from its residuals: the
// four dgates values into d, and the dc carry into step tp-1 returned.
// dh_in and dc_in are the carries into step tp.
__device__ __forceinline__ float cell_grad_math(float si, float tj, float sf, float so,
                                                float c_t, float c_prev, float dout, bool valid,
                                                float dh_in, float dc_in, float (&d)[4]) {
  const float tc = tanhf(c_t);
  const float dnew_h = valid ? dh_in + dout : 0.0f;
  const float dnew_c = (valid ? dc_in : 0.0f) + dnew_h * so * (1.0f - tc * tc);
  d[0] = dnew_c * tj * si * (1.0f - si);
  d[1] = dnew_c * si * (1.0f - tj * tj);
  d[2] = dnew_c * c_prev * sf * (1.0f - sf);
  d[3] = dnew_h * tc * so * (1.0f - so);
  return dnew_c * sf + (valid ? 0.0f : dc_in);
}

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
  const size_t off = (size_t)m * H + u;
  float d[4];
  const float dc_out = cell_grad_math(a[u], a[H + u], a[2 * H + u], a[3 * H + u], cs_p[off],
                                      tp > 0 ? cs_pp[off] : 0.0f, douts_p[off], tp < s, dh_in,
                                      dc_in, d);
  __nv_bfloat16* hi_row = hi_p + (size_t)m * G;
  __nv_bfloat16* lo_row = lo_p + (size_t)m * G;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const __nv_bfloat16 hi = __float2bfloat16(d[g]);
    hi_row[g * H + u] = hi;
    lo_row[g * H + u] = __float2bfloat16(d[g] - __bfloat162float(hi));
  }
  return dc_out;
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

template <int WGS, int BN>
struct BwdTile {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS + 32;   // consumers, then the producer warp
  static constexpr int A_BYTES = BM * kRowBytes;   // one of hi, lo
  static constexpr int B_BYTES = BN * kRowBytes;
  static constexpr int STAGE_BYTES = 2 * A_BYTES + B_BYTES;
  static constexpr int SMEM = 1024 + kStages * STAGE_BYTES + 2 * kStages * 8;
  static constexpr int MIN_BLOCKS = SMEM <= kTwoBlockSmem ? 2 : 1;
};

// The consumer warpgroups of lstm_bwd_step_kernel: warpgroup wg multiplies
// rows 64*wg .. 64*wg + 63 of the tile by the whole N, releasing each
// stage once the wgmmas that read it have retired, then finishes step
// t-1's cell derivative on its registers: a thread holds units u, u+1 of
// rows m and m+8 for each 8-unit block j.
template <int WGS, int BN>
__device__ __forceinline__ void consume_backward(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, int num_k,
    const float* __restrict__ gates_p, const float* __restrict__ cs_p,
    const float* __restrict__ cs_pp, const float* __restrict__ douts_p,
    const int* __restrict__ seq, float* __restrict__ dh, float* __restrict__ dc,
    __nv_bfloat16* __restrict__ hi_p, __nv_bfloat16* __restrict__ lo_p, int t, int B, int H) {
  using Tile = BwdTile<WGS, BN>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* stage = ring + s * Tile::STAGE_BYTES;
    const uint8_t* hi = stage + wg * 64 * kRowBytes;
    const uint8_t* lo = hi + Tile::A_BYTES;
    const uint8_t* w = stage + 2 * Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t wd = sw128_desc(w + kk * 32);
      wgmma<BN>(acc, sw128_desc(hi + kk * 32), wd);
      wgmma<BN>(acc, sw128_desc(lo + kk * 32), wd);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have retired
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const size_t G = 4 * (size_t)H;
  const int tp = t - 1;
  const int u_lane = blockIdx.x * BN + 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = blockIdx.y * Tile::BM + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * half;
    if (m >= B) continue;
    const int len = seq[m];
    const bool carry = t >= len;   // step t was masked: its dh passes through
    const bool valid = tp < len;   // step t-1 is inside the sequence
    const float* a = gates_p + (size_t)m * G;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int u = u_lane + 8 * j;
      if (u >= H) continue;  // H % 8 == 0, so u + 1 < H too
      const size_t off = (size_t)m * H + u;
      const float2 dh_old = carry ? *reinterpret_cast<const float2*>(dh + off)
                                  : make_float2(0.0f, 0.0f);
      const float dh_new[2] = {acc[4 * j + 2 * half] + dh_old.x,
                               acc[4 * j + 2 * half + 1] + dh_old.y};
      *reinterpret_cast<float2*>(dh + off) = make_float2(dh_new[0], dh_new[1]);
      const float2 dc_in = *reinterpret_cast<const float2*>(dc + off);
      const float2 gi = *reinterpret_cast<const float2*>(a + u);
      const float2 gj = *reinterpret_cast<const float2*>(a + H + u);
      const float2 gf = *reinterpret_cast<const float2*>(a + 2 * H + u);
      const float2 go = *reinterpret_cast<const float2*>(a + 3 * H + u);
      const float2 c_t = *reinterpret_cast<const float2*>(cs_p + off);
      const float2 c_prev = tp > 0 ? *reinterpret_cast<const float2*>(cs_pp + off)
                                   : make_float2(0.0f, 0.0f);
      const float2 dout = *reinterpret_cast<const float2*>(douts_p + off);
      float d0[4], d1[4];
      const float dc0 = cell_grad_math(gi.x, gj.x, gf.x, go.x, c_t.x, c_prev.x, dout.x, valid,
                                       dh_new[0], dc_in.x, d0);
      const float dc1 = cell_grad_math(gi.y, gj.y, gf.y, go.y, c_t.y, c_prev.y, dout.y, valid,
                                       dh_new[1], dc_in.y, d1);
      *reinterpret_cast<float2*>(dc + off) = make_float2(dc0, dc1);
      __nv_bfloat16* hi_row = hi_p + (size_t)m * G;
      __nv_bfloat16* lo_row = lo_p + (size_t)m * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(d0[g], d1[g]);
        const float2 hf = __bfloat1622float2(hi2);
        *reinterpret_cast<__nv_bfloat162*>(hi_row + g * H + u) = hi2;
        *reinterpret_cast<__nv_bfloat162*>(lo_row + g * H + u) =
            __floats2bfloat162_rn(d0[g] - hf.x, d1[g] - hf.y);
      }
    }
  }
}

// dh_{t-1} = (hi_t + lo_t) @ Wh^T for a tile of BM rows x BN units, then
// step t-1's cell derivative for that tile.
template <int WGS, int BN>
__global__ void __launch_bounds__(BwdTile<WGS, BN>::THREADS,
                                  BwdTile<WGS, BN>::MIN_BLOCKS) lstm_bwd_step_kernel(
    const __grid_constant__ CUtensorMap hi_map,  // dgates bf16 [T, B, 4H], slice t
    const __grid_constant__ CUtensorMap lo_map,  // lo bf16 [2, B, 4H], slice t % 2
    const __grid_constant__ CUtensorMap w_map,   // Wh bf16 [H, 4H]
    const float* __restrict__ gates_p,           // [B, 4H] residual of step t-1
    const float* __restrict__ cs_p,              // [B, H] c_{t-1}
    const float* __restrict__ cs_pp,             // [B, H] c_{t-2}; unused at t == 1
    const float* __restrict__ douts_p,           // [B, H] d_out[t-1]
    const int* __restrict__ seq,                 // [B]
    float* __restrict__ dh,                      // [B, H] carry, in place
    float* __restrict__ dc,                      // [B, H] carry, in place
    __nv_bfloat16* __restrict__ hi_p,            // [B, 4H] dgates[t-1]
    __nv_bfloat16* __restrict__ lo_p,            // [B, 4H]
    int t, int B, int H) {
  using Tile = BwdTile<WGS, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);  // kStages x {hi [BM][64], lo [BM][64], Wh [BN][64]}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * Tile::STAGE_BYTES);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_k = (4 * H + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // Producer: one lane keeps the ring full.
    if (lane == 0) {
      prefetch_map(&hi_map);
      prefetch_map(&lo_map);
      prefetch_map(&w_map);
      const int m0 = blockIdx.y * Tile::BM;
      const int n0 = blockIdx.x * BN;
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        uint8_t* stage = ring + s * Tile::STAGE_BYTES;
        mbar_expect_tx(&full[s], Tile::STAGE_BYTES);
        tma_load(stage, &hi_map, &full[s], kt * kBK, m0, t);
        tma_load(stage + Tile::A_BYTES, &lo_map, &full[s], kt * kBK, m0, t & 1);
        tma_load(stage + 2 * Tile::A_BYTES, &w_map, &full[s], kt * kBK, n0, 0);
      }
    }
    return;
  }
  consume_backward<WGS, BN>(ring, full, empty, num_k, gates_p, cs_p, cs_pp, douts_p, seq, dh, dc,
                            hi_p, lo_p, t, B, H);
}

template <int WGS, int BN>
int run_backward_tile(const __nv_bfloat16* wh, const float* gates, const float* cs,
                      const float* douts, const int* seq, float* dh, float* dc,
                      __nv_bfloat16* dgates, __nv_bfloat16* lo, int T, int B, int H,
                      cudaStream_t stream) {
  using Tile = BwdTile<WGS, BN>;
  const size_t bh = (size_t)B * H;
  auto c_at = [&](int t) { return t > 0 ? cs + (size_t)(t - 1) * bh : nullptr; };

  const int tl = T - 1;
  const int threads = 256;
  lstm_bwd_last_step_kernel<<<(unsigned)((bh + threads - 1) / threads), threads, 0, stream>>>(
      gates + (size_t)tl * 4 * bh, cs + (size_t)tl * bh, c_at(tl), douts + (size_t)tl * bh,
      seq, dh, dc, dgates + (size_t)tl * 4 * bh, lo + (size_t)(tl % 2) * 4 * bh, tl, B, H);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess || tl == 0) return static_cast<int>(cerr);

  CUtensorMap hi_map, lo_map, w_map;
  int err = make_map(&hi_map, dgates, 4 * (uint64_t)H, B, T, Tile::BM);
  if (err == 0) err = make_map(&lo_map, lo, 4 * (uint64_t)H, B, 2, Tile::BM);
  if (err == 0) err = make_map(&w_map, wh, 4 * (uint64_t)H, H, 1, BN);
  if (err != 0) return err;
  auto kernel = lstm_bwd_step_kernel<WGS, BN>;
  cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((H + BN - 1) / BN, (B + Tile::BM - 1) / Tile::BM);
  for (int t = tl; t >= 1; --t) {
    const int tp = t - 1;
    kernel<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(
        hi_map, lo_map, w_map, gates + (size_t)tp * 4 * bh, cs + (size_t)tp * bh, c_at(tp),
        douts + (size_t)tp * bh, seq, dh, dc, dgates + (size_t)tp * 4 * bh,
        lo + (size_t)(tp % 2) * 4 * bh, t, B, H);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return 0;
}

}  // namespace

extern "C" {

// Runs the T forward steps of one layer on `stream` with the tile (bm
// rows, bu units) of ops/kernels/layout.forward_tile, writing outs
// [T, B, H] bf16 and the residuals gates [T, B, 4H] and cs [T, B, H] f32.
// `wpk` is Wh packed by ops/kernels/layout.pack_wh for bu. `h` holds two
// [B, H] f32 buffers and `hb` two [B, H] bf16 ones; h[0] and hb[0] must
// be zero on entry and the final h ends in h[T % 2]. `c` must be zero on
// entry and holds the final c on return. Returns the first error (see
// lstm_train_error_string), or 0. Does not synchronise.
int lstm_train_fwd_bf16(const void* xp, const void* wpk, const void* bias,
                        const void* seq, void* outs, void* gates, void* cs,
                        void* c, void* h, void* hb, int T, int B, int H, int bm, int bu,
                        float forget_bias, void* stream) {
  return run_forward<true>(bm, bu, xp, wpk, bias, seq, outs, gates, cs, c, h, hb, T, B, H,
                           forget_bias, stream);
}

// Runs the T backward steps of one layer on `stream` with the tile (bm
// rows, bn units) of ops/kernels/layout.backward_tile, writing dgates
// [T, B, 4H] bf16 (the hi part). `wh` is Wh [H, 4H] bf16; `gates`, `cs`
// and `douts` are f32 [T, B, 4H], [T, B, H], [T, B, H]. On entry `dh` and
// `dc` hold dh_fin and dc_fin ([B, H] f32); they are overwritten. `lo` is
// a [2, B, 4H] bf16 scratch. Returns the first error (see
// lstm_train_error_string), or 0. Does not synchronise.
int lstm_train_bwd_bf16(const void* wh, const void* gates, const void* cs,
                        const void* douts, const void* seq, void* dh,
                        void* dc, void* dgates, void* lo, int T, int B,
                        int H, int bm, int bn, void* stream) {
  const auto* wh_bf = static_cast<const __nv_bfloat16*>(wh);
  const auto* gates_f = static_cast<const float*>(gates);
  const auto* cs_f = static_cast<const float*>(cs);
  const auto* douts_f = static_cast<const float*>(douts);
  const auto* seq_i = static_cast<const int*>(seq);
  auto* dh_f = static_cast<float*>(dh);
  auto* dc_f = static_cast<float*>(dc);
  auto* hi_bf = static_cast<__nv_bfloat16*>(dgates);
  auto* lo_bf = static_cast<__nv_bfloat16*>(lo);
  auto st = static_cast<cudaStream_t>(stream);
  // The tiles the library is built for (ops/kernels/layout.BWD_TILES):
  // (rows, units) -> (consumer warpgroups, units).
#define LSTM_BWD_TILE(BM_, BN_)                                                              \
  if (bm == BM_ && bn == BN_) {                                                              \
    return run_backward_tile<BM_ / 64, BN_>(wh_bf, gates_f, cs_f, douts_f, seq_i, dh_f, dc_f, \
                                            hi_bf, lo_bf, T, B, H, st);                       \
  }
  LSTM_BWD_TILE(64, 128)
  LSTM_BWD_TILE(64, 32)
#undef LSTM_BWD_TILE
  return hopper::kErrTile;
}

const char* lstm_train_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
