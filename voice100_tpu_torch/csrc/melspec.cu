// Fused log-mel spectrogram for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel voice100_tpu/ops/melspec_pallas.py::_kernel
// (reached through log_mel_spectrogram_pallas). For each frame of the
// centred, reflect-padded waveform it computes
//
//     X_f = sum_n window[n] frame[n] e^{-2 pi i f n / 512},  f = 0 .. 256
//     out_m = log(sum_f fb[f, m] |X_f|^2 + log_offset)
//
// The TPU kernel does the DFT as two dense [512, 257] products on its
// matrix unit, on frames cut in XLA. Here the whole function is one launch
// on the waveform itself.
//
// Bound on the H100: its bytes (the waveform read and 64 values a frame
// written once); a real FFT needs ~12k flops a frame, the mel projection
// only the filters' nonzeros (each bin falls in at most two filters).
//
// What the design does about it. A block owns TILE consecutive frames of
// one signal. It stages their span of samples, hop * (TILE - 1) + 512,
// into shared memory with coalesced loads, the centred reflect padding
// done by index arithmetic (x < 0 -> -x, x >= L -> 2 (L - 1) - x), so no
// [rows, 512] frame tensor ever exists. Each frame's 512-point real DFT is
// a 256-point complex FFT of z[n] = x[2n] + i x[2n+1] (the windowed even
// and odd samples), loaded in base-4 digit-reversed order and transformed
// in place by four radix-4 decimation-in-time stages in shared memory, then
// split into the 257 real-input bins:
//
//     E_k = (Z_k + conj Z_{256-k}) / 2,  O_k = (Z_k - conj Z_{256-k}) / 2i
//     X_k = E_k + W^k O_k,  X_{256-k} = conj E_k + W^{256-k} conj O_k
//
// with W = e^{-2 pi i / 512} from a twiddle table built on the host in
// float64 and rounded to float32. The power spectrum stays in shared
// memory; each of the 64 filters sums only over its own contiguous bin
// range (first bin, count and offset into a packed weight array, built on
// the host from the filterbank), then log, written once. Float32
// throughout, as the reference runs at Precision.HIGHEST.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 512;
constexpr int HALF = N_FFT / 2;        // complex FFT length, and the centring pad
constexpr int N_FREQ = N_FFT / 2 + 1;  // 257
constexpr int N_MELS = 64;
constexpr int TILE = 8;                // frames per block
constexpr int THREADS = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// reverse the four base-4 digits of j < 256
__device__ __forceinline__ int digit_reverse4(int j) {
  return ((j & 3) << 6) | (((j >> 2) & 3) << 4) | (((j >> 4) & 3) << 2) | ((j >> 6) & 3);
}

// floats of a tile's staged samples, rounded up to keep the complex
// buffer after them 8-byte aligned
__host__ __device__ constexpr int span_floats(int hop) {
  return (hop * (TILE - 1) + N_FFT + 1) & ~1;
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ wav,       // [N, length]
               const float* __restrict__ window,    // [N_FFT], zero outside the centred taps
               const float2* __restrict__ tw,       // [N_FFT]: W^k = e^{-2 pi i k / N_FFT}
               const int* __restrict__ bands,       // [3, N_MELS]: first bin, count, offset
               const float* __restrict__ weights,   // packed filter weights
               float* __restrict__ out,             // [N, frames, N_MELS]
               int length, int frames, int hop, float log_offset) {
  extern __shared__ __align__(16) float smem[];
  const int span_pad = span_floats(hop);
  float* xs = smem;                                            // the tile's samples
  float2* zs = reinterpret_cast<float2*>(smem + span_pad);     // [TILE, HALF]
  float* ps = reinterpret_cast<float*>(zs + TILE * HALF);      // [TILE, N_FREQ]
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * TILE;
  const int nf = min(TILE, frames - f0);
  const float* x = wav + static_cast<long long>(blockIdx.y) * length;

  // samples start .. start + span of the padded signal, reflected into range
  const int start = f0 * hop - HALF;
  const int span = hop * (nf - 1) + N_FFT;
  for (int i = tid; i < span; i += THREADS) {
    int p = start + i;
    p = p < 0 ? -p : p;
    p = p >= length ? 2 * (length - 1) - p : p;
    xs[i] = x[p];
  }
  __syncthreads();

  // windowed even/odd samples as one complex sequence, digit-reversed
  for (int e = tid; e < nf * HALF; e += THREADS) {
    const int r = e / HALF;
    const int n = 2 * (e % HALF);
    const float* fr = xs + r * hop;
    zs[r * HALF + digit_reverse4(e % HALF)] =
        make_float2(fr[n] * __ldg(window + n), fr[n + 1] * __ldg(window + n + 1));
  }
  __syncthreads();

  // four radix-4 DIT stages, in place; span L, butterfly k of group g
#pragma unroll
  for (int len = 4; len <= HALF; len *= 4) {
    const int quarter = len / 4;
    const int stride = N_FFT / len;  // W_len^j = W^(j * stride)
    for (int e = tid; e < nf * (HALF / 4); e += THREADS) {
      const int r = e / (HALF / 4);
      const int b = e % (HALF / 4);
      const int k = b % quarter;
      float2* z = zs + r * HALF + (b / quarter) * len + k;
      const float2 a0 = z[0];
      const float2 a1 = cmul(z[quarter], __ldg(tw + k * stride));
      const float2 a2 = cmul(z[2 * quarter], __ldg(tw + 2 * k * stride));
      const float2 a3 = cmul(z[3 * quarter], __ldg(tw + 3 * k * stride));
      const float2 s02 = make_float2(a0.x + a2.x, a0.y + a2.y);
      const float2 d02 = make_float2(a0.x - a2.x, a0.y - a2.y);
      const float2 s13 = make_float2(a1.x + a3.x, a1.y + a3.y);
      const float2 d13 = make_float2(a1.x - a3.x, a1.y - a3.y);
      z[0] = make_float2(s02.x + s13.x, s02.y + s13.y);
      z[quarter] = make_float2(d02.x + d13.y, d02.y - d13.x);         // d02 - i d13
      z[2 * quarter] = make_float2(s02.x - s13.x, s02.y - s13.y);
      z[3 * quarter] = make_float2(d02.x - d13.y, d02.y + d13.x);     // d02 + i d13
    }
    __syncthreads();
  }

  // split into the real input's bins k and 256 - k, and their power
  for (int e = tid; e < nf * (HALF / 2 + 1); e += THREADS) {
    const int r = e / (HALF / 2 + 1);
    const int k = e % (HALF / 2 + 1);
    const float2 zk = zs[r * HALF + k];
    const float2 zn = zs[r * HALF + ((HALF - k) & (HALF - 1))];
    const float2 ev = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
    const float2 od = make_float2(0.5f * (zk.y + zn.y), -0.5f * (zk.x - zn.x));
    float* p = ps + r * N_FREQ;
    const float2 lo = cmul(__ldg(tw + k), od);
    p[k] = (ev.x + lo.x) * (ev.x + lo.x) + (ev.y + lo.y) * (ev.y + lo.y);
    if (k == 0) {
      p[HALF] = (ev.x - od.x) * (ev.x - od.x);   // E and O are real at k = 0
    } else {
      const float2 hi = cmul(__ldg(tw + HALF - k), make_float2(od.x, -od.y));
      p[HALF - k] = (ev.x + hi.x) * (ev.x + hi.x) + (hi.y - ev.y) * (hi.y - ev.y);
    }
  }
  __syncthreads();

  float* dst = out + (static_cast<long long>(blockIdx.y) * frames + f0) * N_MELS;
  for (int e = tid; e < nf * N_MELS; e += THREADS) {
    const int r = e / N_MELS;
    const int m = e % N_MELS;
    const int first = __ldg(bands + m);
    const int count = __ldg(bands + N_MELS + m);
    const float* w = weights + __ldg(bands + 2 * N_MELS + m);
    const float* p = ps + r * N_FREQ + first;
    float acc = 0.f;
    for (int c = 0; c < count; ++c) acc = fmaf(p[c], __ldg(w + c), acc);
    dst[e] = logf(acc + log_offset);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block for a hop of `hop` samples.
extern "C" int log_mel_smem_bytes(int hop) {
  return static_cast<int>(span_floats(hop) * sizeof(float) + TILE * HALF * sizeof(float2) +
                          TILE * N_FREQ * sizeof(float));
}

// wav [n, length] and out [n, frames, 64], frames = length / hop + 1,
// window [512], twiddles [512] (float2), bands [3, 64] (int32) and the
// packed weights are contiguous device arrays; length > 256 (reflect
// padding) and log_mel_smem_bytes(hop) <= 48 KB. Launches one grid on
// `stream` and returns cudaGetLastError().
extern "C" int log_mel_f32(const float* wav, const float* window, const void* twiddles,
                           const int* bands, const float* weights, float* out, int n,
                           int length, int frames, int hop, float log_offset, void* stream) {
  if (n > 0 && frames > 0) {
    const dim3 grid((frames + TILE - 1) / TILE, n);
    log_mel_kernel<<<grid, THREADS, log_mel_smem_bytes(hop), static_cast<cudaStream_t>(stream)>>>(
        wav, window, static_cast<const float2*>(twiddles), bands, weights, out, length, frames,
        hop, log_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
