// Forward-only bf16 LSTM recurrence of one layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lstm_chunk_kernel`
// (efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py,
// called through `lstm_chunk_scan_pallas`). Same math, same layouts:
//   xp   [T, B, 4H] bf16, time-major (x @ Wx, no bias)
//   Wh   [H, 4H]    bf16, bias [4H] f32, seq [B] int32
// Outputs: outs [T, B, H] bf16, final c and h [B, H] f32.
//
// The step kernel (TMA-fed wgmma with a fused gate epilogue), its bound
// and what it gives up are in lstm_step.cuh, which the train forward
// (lstm_train.cu) shares; here it runs without the train residuals. At
// the flagship's serving shapes it is bound by the tensor cores: student
// L1 (T=6, B=1280) 0.065 ms, L2 (5 x 256) 0.011 ms.

#include "lstm_step.cuh"

extern "C" {

// Runs all T steps of one layer on `stream` with the tile (bm rows, bu
// units) of ops/kernels/layout.forward_tile. `wpk` is Wh packed by
// ops/kernels/layout.pack_wh for bu. `h` holds two [B, H] f32 buffers and
// `hb` two [B, H] bf16 ones; h[0] and hb[0] must be zero on entry and the
// final h ends in h[T % 2]. `c` must be zero on entry and holds the final
// c on return. Returns the first error (see lstm_chunk_scan_error_string),
// or 0. Does not synchronise.
int lstm_chunk_scan_bf16(const void* xp, const void* wpk, const void* bias,
                         const void* seq, void* outs, void* c, void* h, void* hb,
                         int T, int B, int H, int bm, int bu,
                         float forget_bias, void* stream) {
  return run_forward<false>(bm, bu, xp, wpk, bias, seq, outs, nullptr, nullptr, c, h, hb, T, B,
                            H, forget_bias, stream);
}

const char* lstm_chunk_scan_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
