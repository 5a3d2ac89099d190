// Forward-only bf16 LSTM recurrence of one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lstm_chunk_kernel`
// (efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py,
// called through `lstm_chunk_scan_pallas`). Same math, same layouts:
//   xp   [T, B, 4H] bf16, time-major (x @ Wx, no bias)
//   Wh   [H, 4H]    bf16, bias [4H] f32, seq [B] int32
// Outputs: outs [T, B, H] bf16, final c and h [B, H] f32.
//
// The step kernel, its design and what bounds it are in lstm_step.cuh,
// which the train forward (lstm_train.cu) shares; here it runs without
// the train residuals.

#include "lstm_step.cuh"

extern "C" {

// Runs all T steps of one layer on `stream`. `h` holds two [B, H] f32
// buffers; h[0] must be zero on entry and the final h ends in h[T % 2].
// `c` must be zero on entry and holds the final c on return. Returns the
// first launch error (a cudaError_t), or 0. Does not synchronise.
int lstm_chunk_scan_bf16(const void* xp, const void* wh, const void* bias,
                         const void* seq, void* outs, void* c, void* h,
                         int T, int B, int H, float forget_bias,
                         void* stream) {
  const dim3 grid((H + BU - 1) / BU, (B + BM - 1) / BM);
  const size_t bh = (size_t)B * H;
  const auto* xp_bf = static_cast<const __nv_bfloat16*>(xp);
  auto* outs_bf = static_cast<__nv_bfloat16*>(outs);
  auto* h_f = static_cast<float*>(h);
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        xp_bf + (size_t)t * B * 4 * (size_t)H, static_cast<const __nv_bfloat16*>(wh),
        static_cast<const float*>(bias), static_cast<const int*>(seq),
        h_f + (t % 2) * bh, h_f + ((t + 1) % 2) * bh, static_cast<float*>(c),
        outs_bf + (size_t)t * bh, nullptr, nullptr, t, B, H, forget_bias);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* lstm_chunk_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
