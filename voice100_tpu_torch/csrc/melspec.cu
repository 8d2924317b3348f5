// Fused log-mel spectrogram for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel voice100_tpu/ops/melspec_pallas.py::_kernel
// (reached through log_mel_spectrogram_pallas). For each frame row it
// computes
//
//     re_f = frame . cos_w[:, f],  im_f = frame . sin_w[:, f]
//     out_m = log(sum_f fb[f, m] * (re_f^2 + im_f^2) + log_offset)
//
// with the Hann window folded into the DFT constants cos_w / sin_w
// (built in numpy by voice100_tpu_torch/ops/melspec_cuda.py). The frames
// are cut from the waveform (reflect pad + gather) in PyTorch before the
// launch, as the JAX wrapper does.
//
// Bound on the H100. The function itself is bound by its bytes: the
// waveform read and 64 values a frame written once (an FFT would need
// only ~12k flops a frame, and each bin falls in at most two mel
// filters). This design does the DFT as dense products, as the TPU kernel
// does on its MXU, so as written it is bound by its float32 operations,
// about 2 * rows * 512 * 257 * 2 for the two DFT products plus
// 2 * rows * 257 * 64 for the mel product, some 40 times the work an FFT
// needs. They run in full float32 on the CUDA cores, as the reference
// runs them at Precision.HIGHEST; tensor cores would need TF32 or bf16.
//
// What the design does about it: one block owns TILE frame rows, held in
// shared memory, and one thread per frequency bin runs the two dot
// products for all TILE rows at once, so each cos/sin constant read from
// L2 feeds 2 * TILE fused multiply-adds and each shared-memory frame load
// is a broadcast of four taps. The [rows, 257] power spectrum never
// reaches device memory: it is written over the frame tile in shared
// memory and reduced to the 64 mel bins there, which was what the TPU
// kernel was for.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 512;
constexpr int N_FREQ = N_FFT / 2 + 1;  // 257
constexpr int N_MELS = 64;
constexpr int TILE = 16;               // frame rows per block
constexpr int THREADS = 288;           // 9 warps: one thread per bin (257 used)

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ frames,  // [rows, N_FFT]
               const float* __restrict__ cos_w,   // [N_FFT, N_FREQ]
               const float* __restrict__ sin_w,   // [N_FFT, N_FREQ]
               const float* __restrict__ fb,      // [N_FREQ, N_MELS]
               float* __restrict__ out,           // [rows, N_MELS]
               int rows, float log_offset) {
  // The frame tile; after the DFT has read it, the power spectrum
  // [TILE, N_FREQ] is written over it.
  __shared__ __align__(16) float buf[TILE * N_FFT];
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE;

  const float4* src = reinterpret_cast<const float4*>(frames);
  float4* dst = reinterpret_cast<float4*>(buf);
  for (int i = tid; i < TILE * N_FFT / 4; i += THREADS) {
    const int r = i / (N_FFT / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = src[(row0 + r) * (N_FFT / 4) + i % (N_FFT / 4)];
    dst[i] = v;
  }
  __syncthreads();

  const int f = tid;
  float re[TILE], im[TILE];
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    re[r] = 0.f;
    im[r] = 0.f;
  }
  if (f < N_FREQ) {
    for (int n = 0; n < N_FFT; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = __ldg(cos_w + (n + k) * N_FREQ + f);
        s[k] = __ldg(sin_w + (n + k) * N_FREQ + f);
      }
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(buf + r * N_FFT + n);
        re[r] = fmaf(x.x, c[0], re[r]);
        re[r] = fmaf(x.y, c[1], re[r]);
        re[r] = fmaf(x.z, c[2], re[r]);
        re[r] = fmaf(x.w, c[3], re[r]);
        im[r] = fmaf(x.x, s[0], im[r]);
        im[r] = fmaf(x.y, s[1], im[r]);
        im[r] = fmaf(x.z, s[2], im[r]);
        im[r] = fmaf(x.w, s[3], im[r]);
      }
    }
  }
  __syncthreads();  // every thread is done reading the frame tile
  if (f < N_FREQ) {
#pragma unroll
    for (int r = 0; r < TILE; ++r) buf[r * N_FREQ + f] = re[r] * re[r] + im[r] * im[r];
  }
  __syncthreads();

  for (int o = tid; o < TILE * N_MELS; o += THREADS) {
    const int r = o / N_MELS;
    const int m = o % N_MELS;
    if (row0 + r >= rows) continue;
    const float* power = buf + r * N_FREQ;
    float acc = 0.f;
    for (int k = 0; k < N_FREQ; ++k) acc = fmaf(power[k], __ldg(fb + k * N_MELS + m), acc);
    out[(row0 + r) * N_MELS + m] = logf(acc + log_offset);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// frames, cos_w, sin_w, fb and out are contiguous float32 device arrays of
// the shapes above; frames is 16-byte aligned. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int log_mel_f32(const float* frames, const float* cos_w, const float* sin_w,
                           const float* fb, float* out, int rows, float log_offset,
                           void* stream) {
  if (rows > 0) {
    const int blocks = (rows + TILE - 1) / TILE;
    log_mel_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        frames, cos_w, sin_w, fb, out, rows, log_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
