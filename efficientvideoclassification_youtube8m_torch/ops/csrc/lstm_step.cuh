// One step of the bf16 LSTM recurrence of one layer, for Hopper (sm_90a),
// shared by the forward-only scan (lstm_chunk_scan.cu, replacing the TPU
// kernel `_lstm_chunk_kernel`) and the train forward (lstm_train.cu,
// replacing `_lstm_chunk_kernel_train_fwd`), both of
// efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py.
// Same math and masking as the TPU kernels:
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
// What bounds it on this card (ops/kernels/bounds.py): a row-step is
// 8*H^2 flops (8.39 MFLOP at H=1024) against 10*H bytes of xp and outs;
// the train forward adds 20*H bytes of residuals (30 KiB a row-step in
// all). So the forward-only scan is bound by the tensor cores (819
// FLOP/B) and the train forward by memory (273 FLOP/B): at the flagship
// train shapes 0.707 ms (teacher L1, T=15, B=5120), 0.050 (teacher L2,
// 20 x 256), 0.073 (student L1, 6 x 1280), 0.014 (student L2, 5 x 256).
//
// Design. The time loop runs on the host, one launch a step, all on the
// caller's stream. A block owns BM = 64*WGS batch rows x BU hidden units
// and all four gate columns of those units (N = 4*BU), so the cell
// update is a fused epilogue. The wrapper packs Wh once per call as
// K-major slabs (ops/kernels/layout.pack_wh): rows tile*4BU + g*BU + uu
// of the packed [tiles*4BU, H] hold column g*H + tile*BU + uu of Wh, so a
// block's B operand is one contiguous box. The epilogue writes h_t also
// as bf16, rounded to nearest even as the TPU kernel's astype, into a
// [2, B, H] ping-pong that the next step reads as its A operand. One
// producer warp keeps a ring of kStages = 4 stages of 64-deep K tiles
// (h and Wh) in flight with TMA (128B-swizzled boxes, completion on mbarriers;
// rows past B and depths past H read as zero); WGS consumer warpgroups
// each multiply their 64 rows by the whole N on wgmma (m64 x N x k16, f32
// sums in registers) and release a stage once the wgmma that read it has
// retired. In the wgmma layout a thread holds the same (row, unit) pairs
// of all four gates, so the epilogue runs on the registers: no shared
// memory round trip. Before its first product each thread loads what its
// epilogue reads (xp + bias as the accumulator's start, c and the rows'
// lengths), so those loads wait behind the pipeline fill, not after the
// products. The host picks the tile (ops/kernels/layout.py): 128 x 32
// units (two consumer warpgroups) where that gives every SM two blocks
// (student and teacher L1), else 64 x 32 (the B=256 layers).
//
// What it still gives up: Wh is re-read from L2 by every row tile on
// every step and h by every unit tile (sharing Wh across a cluster by TMA
// multicast was no faster); the host time loop pays a launch and a
// pipeline fill every step; the epilogue's stores do not overlap the next
// tile's products; and there is no persistent design that keeps Wh
// resident across SMs for the B=256 layers, where a step is a few
// microseconds of work.

#pragma once

#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int WGS, int BU>
struct FwdTile {
  static constexpr int BM = 64 * WGS;
  static constexpr int BN = 4 * BU;
  static constexpr int THREADS = 128 * WGS + 32;   // consumers, then the producer warp
  static constexpr int A_BYTES = BM * kRowBytes;
  static constexpr int B_BYTES = BN * kRowBytes;
  static constexpr int SMEM = 1024 + kStages * (A_BYTES + B_BYTES) + 2 * kStages * 8;
  // Two blocks an SM where their rings fit, so that one block's epilogue
  // can overlap the other's products.
  static constexpr int MIN_BLOCKS = SMEM <= kTwoBlockSmem ? 2 : 1;
};

// The consumer warpgroups of lstm_step_kernel: warpgroup wg multiplies
// rows 64*wg .. 64*wg + 63 of the tile by the whole N, releasing each
// stage once the wgmma that read it has retired, then runs the gate
// epilogue on its registers. A thread holds
// units u, u+1 of rows m and m+8 for each 8-unit block j, in all four
// gates. What the epilogue reads besides the products is loaded before
// the first product, so that its latency hides behind the pipeline fill:
// the accumulator starts at f32(xp) + bias and the products add into it,
// and c and the rows' lengths wait in registers.
template <int WGS, int BU, bool kTrain>
__device__ __forceinline__ void consume_forward(
    const uint8_t* a_s, const uint8_t* b_s, uint64_t* full, uint64_t* empty, int num_k,
    const __nv_bfloat16* __restrict__ xp_t, const float* __restrict__ bias,
    const int* __restrict__ seq, const float* __restrict__ h_prev, float* __restrict__ h_next,
    __nv_bfloat16* __restrict__ hb_next, float* __restrict__ c,
    __nv_bfloat16* __restrict__ out_t, float* __restrict__ gates_t, float* __restrict__ cs_t,
    int t, int B, int H, float forget_bias) {
  using Tile = FwdTile<WGS, BU>;
  constexpr int BN = Tile::BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const size_t G = 4 * (size_t)H;
  const int u_lane = blockIdx.x * BU + 2 * (lane % 4);
  const int m_lane = blockIdx.y * Tile::BM + wg * 64 + (warp % 4) * 16 + lane / 4;

  float acc[BN / 2];
  float2 c_old[2][BU / 8];
  int len[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m_lane + 8 * half;
    len[half] = m < B ? seq[m] : 0;
#pragma unroll
    for (int j = 0; j < BU / 8; ++j) {
      const int u = u_lane + 8 * j;
      const bool in = m < B && u < H;  // H % 8 == 0, so u + 1 < H too
      c_old[half][j] = in ? *reinterpret_cast<const float2*>(c + (size_t)m * H + u)
                          : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int idx = 4 * (g * (BU / 8) + j) + 2 * half;
        float2 xb = make_float2(0.0f, 0.0f);
        if (in) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xp_t + (size_t)m * G + g * H + u));
          const float2 bv = *reinterpret_cast<const float2*>(bias + g * H + u);
          xb = make_float2(xv.x + bv.x, xv.y + bv.y);
        }
        acc[idx] = xb.x;
        acc[idx + 1] = xb.y;
      }
    }
  }

  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* a = a_s + s * Tile::A_BYTES + wg * 64 * kRowBytes;
    const uint8_t* b = b_s + s * Tile::B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma<BN>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products have retired
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m_lane + 8 * half;
    if (m >= B) continue;
    const bool valid = t < len[half];
#pragma unroll
    for (int j = 0; j < BU / 8; ++j) {
      const int u = u_lane + 8 * j;
      if (u >= H) continue;
      float act[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int idx = 4 * (g * (BU / 8) + j) + 2 * half;
        act[g][0] = acc[idx];
        act[g][1] = acc[idx + 1];
      }
      const size_t off = (size_t)m * H + u;
      const float2 h_old = valid ? make_float2(0.0f, 0.0f)
                                 : *reinterpret_cast<const float2*>(h_prev + off);
      float c_new[2], h_new[2], out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float si = sigmoid_f32(act[0][e]);
        const float tj = tanhf(act[1][e]);
        const float sf = sigmoid_f32(act[2][e] + forget_bias);
        const float so = sigmoid_f32(act[3][e]);
        act[0][e] = si;
        act[1][e] = tj;
        act[2][e] = sf;
        act[3][e] = so;
        const float co = e == 0 ? c_old[half][j].x : c_old[half][j].y;
        const float nc = co * sf + si * tj;
        const float nh = tanhf(nc) * so;
        c_new[e] = valid ? nc : co;
        h_new[e] = valid ? nh : (e == 0 ? h_old.x : h_old.y);
        out[e] = valid ? nh : 0.0f;
      }
      *reinterpret_cast<float2*>(c + off) = make_float2(c_new[0], c_new[1]);
      *reinterpret_cast<float2*>(h_next + off) = make_float2(h_new[0], h_new[1]);
      *reinterpret_cast<__nv_bfloat162*>(hb_next + off) = __floats2bfloat162_rn(h_new[0], h_new[1]);
      *reinterpret_cast<__nv_bfloat162*>(out_t + off) = __floats2bfloat162_rn(out[0], out[1]);
      if constexpr (kTrain) {
        // 8-byte stores: a warp's store covers whole 32-byte sectors of 8
        // rows (a lane swap for 16-byte stores was slower on an H100)
        float* g_row = gates_t + (size_t)m * G;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          *reinterpret_cast<float2*>(g_row + g * H + u) = make_float2(act[g][0], act[g][1]);
        }
        *reinterpret_cast<float2*>(cs_t + off) = make_float2(c_new[0], c_new[1]);
      }
    }
  }
}

template <int WGS, int BU, bool kTrain>
__global__ void __launch_bounds__(FwdTile<WGS, BU>::THREADS,
                                  FwdTile<WGS, BU>::MIN_BLOCKS) lstm_step_kernel(
    const __grid_constant__ CUtensorMap h_map,   // h bf16 [2, B, H], slice t % 2
    const __grid_constant__ CUtensorMap w_map,   // packed Wh [tiles * 4BU, H]
    const __nv_bfloat16* __restrict__ xp_t,      // [B, 4H]
    const float* __restrict__ bias,              // [4H]
    const int* __restrict__ seq,                 // [B]
    const float* __restrict__ h_prev,            // [B, H]
    float* __restrict__ h_next,                  // [B, H]
    __nv_bfloat16* __restrict__ hb_next,         // [B, H], bf16 h_t
    float* __restrict__ c,                       // [B, H], updated in place
    __nv_bfloat16* __restrict__ out_t,           // [B, H]
    float* __restrict__ gates_t,                 // [B, 4H], kTrain only
    float* __restrict__ cs_t,                    // [B, H], kTrain only
    int t, int B, int H, float forget_bias) {
  using Tile = FwdTile<WGS, BU>;
  constexpr int BN = Tile::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align_1024(smem_raw);          // kStages x [BM][64]
  uint8_t* b_s = a_s + kStages * Tile::A_BYTES;  // kStages x [BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * Tile::B_BYTES);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_k = (H + kBK - 1) / kBK;

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
      prefetch_map(&h_map);
      prefetch_map(&w_map);
      const int m0 = blockIdx.y * Tile::BM;
      const int n0 = blockIdx.x * BN;
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], Tile::A_BYTES + Tile::B_BYTES);
        tma_load(a_s + s * Tile::A_BYTES, &h_map, &full[s], kt * kBK, m0, t & 1);
        tma_load(b_s + s * Tile::B_BYTES, &w_map, &full[s], kt * kBK, n0, 0);
      }
    }
    return;
  }
  consume_forward<WGS, BU, kTrain>(a_s, b_s, full, empty, num_k, xp_t, bias, seq, h_prev, h_next,
                                   hb_next, c, out_t, gates_t, cs_t, t, B, H, forget_bias);
}

// The T steps of one layer on `stream` with tile (bm, bu); see
// lstm_chunk_scan_bf16 and lstm_train_fwd_bf16 for the buffers. Returns
// the first error (a cudaError_t or a hopper:: code), or 0.
template <int WGS, int BU, bool kTrain>
int run_forward_tile(const __nv_bfloat16* xp, const void* wpk, const float* bias,
                     const int* seq, __nv_bfloat16* outs, float* gates, float* cs, float* c,
                     float* h, __nv_bfloat16* hb, int T, int B, int H, float forget_bias,
                     cudaStream_t stream) {
  using Tile = FwdTile<WGS, BU>;
  const int tiles = (H + BU - 1) / BU;
  CUtensorMap h_map, w_map;
  int err = make_map(&h_map, hb, H, B, 2, Tile::BM);
  if (err == 0) err = make_map(&w_map, wpk, H, (uint64_t)tiles * Tile::BN, 1, Tile::BN);
  if (err != 0) return err;
  auto kernel = lstm_step_kernel<WGS, BU, kTrain>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          Tile::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(tiles, (B + Tile::BM - 1) / Tile::BM);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    kernel<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(
        h_map, w_map, xp + (size_t)t * 4 * bh, bias, seq, h + (t % 2) * bh,
        h + ((t + 1) % 2) * bh, hb + ((t + 1) % 2) * bh, c, outs + (size_t)t * bh,
        kTrain ? gates + (size_t)t * 4 * bh : nullptr, kTrain ? cs + (size_t)t * bh : nullptr,
        t, B, H, forget_bias);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return 0;
}

// The tiles the libraries are built for (ops/kernels/layout.FWD_TILES):
// (rows, units) -> (consumer warpgroups, units).
template <bool kTrain>
int run_forward(int bm, int bu, const void* xp, const void* wpk, const void* bias,
                const void* seq, void* outs, void* gates, void* cs, void* c, void* h, void* hb,
                int T, int B, int H, float forget_bias, void* stream) {
  const auto* xp_bf = static_cast<const __nv_bfloat16*>(xp);
  const auto* bias_f = static_cast<const float*>(bias);
  const auto* seq_i = static_cast<const int*>(seq);
  auto* outs_bf = static_cast<__nv_bfloat16*>(outs);
  auto* gates_f = static_cast<float*>(gates);
  auto* cs_f = static_cast<float*>(cs);
  auto* c_f = static_cast<float*>(c);
  auto* h_f = static_cast<float*>(h);
  auto* hb_bf = static_cast<__nv_bfloat16*>(hb);
  auto st = static_cast<cudaStream_t>(stream);
#define LSTM_FWD_TILE(BM_, BU_)                                                              \
  if (bm == BM_ && bu == BU_) {                                                              \
    return run_forward_tile<BM_ / 64, BU_, kTrain>(                                          \
        xp_bf, wpk, bias_f, seq_i, outs_bf, gates_f, cs_f, c_f, h_f, hb_bf, T, B, H,         \
        forget_bias, st);                                                                    \
  }
  LSTM_FWD_TILE(128, 32)
  LSTM_FWD_TILE(64, 32)
#undef LSTM_FWD_TILE
  return kErrTile;
}

}  // namespace
