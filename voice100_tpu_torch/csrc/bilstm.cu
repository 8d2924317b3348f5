// Bidirectional LSTM inference recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel voice100_tpu/ops/lstm_pallas.py::_kernel
// (reached through _bilstm_pallas_call and bilstm_pallas) in both its
// modes: bilstm_f32 reads a float32 xg (VOICE100_TPU_LSTM_XG_DTYPE=float32),
// bilstm_bf16 a bf16 one (the mode's default, lstm_pallas.py:140-146),
// widened to float32 as it is loaded; the recurrence and out are float32
// in both. The input projections xg = x @ W_ih^T + b_ih + b_hh are one
// float32 matmul outside the kernel, as in the JAX wrapper
// (lstm_pallas.py:134-139), rounded to bf16 there for the bf16 mode; the
// recurrence of both directions is one persistent cooperative launch a
// layer, the kernel of bilstm_persistent.cuh without the state saves. What
// bounds it and what its design does about it are noted there.

#include "bilstm_persistent.cuh"

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block of the launch.
extern "C" int bilstm_smem_bytes(int batch, int hidden) {
  return persistent::smem_bytes(batch, hidden);
}

// 0 if the launch can run with all 2 * hidden / 8 blocks resident on the
// current device, else a CUDA error (see persistent::check).
extern "C" int bilstm_check(int batch, int hidden) {
  return persistent::check<false, float>(batch, hidden);
}

// The same for the bf16 variant's launch.
extern "C" int bilstm_check_bf16(int batch, int hidden) {
  return persistent::check<false, __nv_bfloat16>(batch, hidden);
}

// The whole layer: xg [2, B, T, 4H] (source time in both directions),
// w_hh [2, 4H, H], lengths [B] and order [B] (the rows by descending
// length, int32), the scratch xchg [2, 2, B, H] (float32) and ready
// [2 * hidden / 8] (int32), any contents, and out [B, T, 2H], all
// contiguous on the device; hidden a multiple of 32. Returns bilstm_check's
// error without launching, else the launch's.
extern "C" int bilstm_f32(const float* xg, const float* w_hh, const int* lengths,
                          const int* order, float* xchg, int* ready, float* out, int batch,
                          int time, int hidden, void* stream) {
  return persistent::launch<false, float>(xg, w_hh, lengths, order, xchg, ready, out, nullptr,
                                          nullptr, batch, time, hidden, stream);
}

// bilstm_f32 with xg [2, B, T, 4H] in bf16; everything else as there.
// Returns bilstm_check_bf16's error without launching, else the launch's.
extern "C" int bilstm_bf16(const __nv_bfloat16* xg, const float* w_hh, const int* lengths,
                           const int* order, float* xchg, int* ready, float* out, int batch,
                           int time, int hidden, void* stream) {
  return persistent::launch<false, __nv_bfloat16>(xg, w_hh, lengths, order, xchg, ready, out,
                                                  nullptr, nullptr, batch, time, hidden, stream);
}
