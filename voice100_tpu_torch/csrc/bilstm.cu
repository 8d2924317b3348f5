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
// layer without the state saves: for float32 the kernel of
// bilstm_persistent.cuh (kernel 1), for bf16 the tensor-core kernel of
// bilstm_fwd_mma.cuh (kernel 1b). What bounds each and what its design
// does about it are noted there.

#include "bilstm_persistent.cuh"
#include "bilstm_fwd_mma.cuh"

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
  return persistent::check<false>(batch, hidden);
}

// The bf16 variant's launch (bilstm_fwd_mma.cuh): its dynamic shared
// memory a block, and 0 if all its blocks can be resident on the current
// device, else a CUDA error (see fwd_mma::check).
extern "C" int bilstm_smem_bytes_bf16(int batch, int hidden) {
  return fwd_mma::smem_bytes(batch, hidden);
}
extern "C" int bilstm_check_bf16(int batch, int hidden) {
  return fwd_mma::check<false>(batch, hidden);
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
  return persistent::launch<false>(xg, w_hh, lengths, order, xchg, ready, out, nullptr,
                                   nullptr, batch, time, hidden, stream);
}

// The bf16 variant (bilstm_fwd_mma.cuh): xg [2, B, T, 4H] in bf16, and the
// scratch xchg of 2 * 2 * ceil(B / 16) * 16 * H floats' bytes, holding h
// split in bf16 halves in the mma's fragment order, and ready (the flags
// are zeroed on the stream first), any contents; everything else as
// bilstm_f32. Returns bilstm_check_bf16's error without launching, else
// the memset's or the launch's.
extern "C" int bilstm_bf16(const __nv_bfloat16* xg, const float* w_hh, const int* lengths,
                           const int* order, float* xchg, int* ready, float* out, int batch,
                           int time, int hidden, void* stream) {
  return fwd_mma::launch<false>(xg, w_hh, lengths, order, xchg, ready, out, nullptr, nullptr,
                                batch, time, hidden, stream);
}
