// CTC loss lattice for Hopper (sm_90a), float32: the log-semiring alpha
// forward and its exact adjoint.
//
// Replaces the TPU kernels voice100_tpu/ops/ctc_pallas.py::_fwd_kernel (via
// _ctc_fwd_call) and ::_bwd_kernel (via _ctc_bwd_call), which ctc_ll_pallas
// wraps. Lattice of one sample: S = 2L + 1 states over the blank-interleaved
// labels z (blank 0); can_skip(s) = z_s != 0 and z_s != z_{s-2};
// valid(s) = s < 2 * target_length + 1.
//
// Forward (ctc_alpha_kernel):
//     alpha[0](s) = (s < 2 and valid(s)) ? lp[b, 0, z_s] : NEG
//     t >= 1, t < input_length:
//         alpha[t](s) = valid(s) ? LSE(alpha[t-1](s), alpha[t-1](s-1),
//                                      can_skip(s) ? alpha[t-1](s-2) : NEG) + lp[b, t, z_s]
//                                : NEG
//     t >= input_length: alpha[t] = alpha[t-1]   (the row holds)
// Adjoint (ctc_adjoint_kernel), g = dLL/d alpha[t], seeded with g_seed at
// t = T-1, walking t down:
//     t >= 1, active: grad[t](s) = ge(s) = valid(s) ? g(s) : 0,
//         g(s) <- sum_k ge(s+k) exp(min(alpha[t-1](s) - pre(s+k), 0)), k = 0, 1, 2
//         (k = 2 only where can_skip(s+2)), pre = the step's LSE recomputed
//     t >= 1, held: grad[t] = 0, g unchanged;  t = 0: grad[0](s) = (s < 2 and valid(s)) ? g(s) : 0
// NEG = -1e30 and the LSE's max is clamped at NEG, as in the JAX kernels:
// with -inf, (-inf) - (-inf) would give NaN.
//
// What is hard on Hopper. The TPU kernels carry the [B, S] lattice in VMEM
// across a sequential grid over time; Hopper's blocks run in no order and
// share nothing. But rows of the batch do not depend on each other, so one
// block owns one sample and runs the whole time loop inside one launch,
// its threads over s, the lattice row in shared memory and one
// __syncthreads() a step (the forward double-buffers the row; the adjoint
// stages pre, ge and alpha[t-1] before any thread reads pre(s+1) and
// pre(s+2), then updates g). Each step is a few hundred flops a sample and
// a dependent chain of T steps, so the kernel is bound by the latency of
// that chain (global reads of the emissions or of alpha[t-1], a barrier, a
// global write), not by bytes or flops; 64 blocks use half the SMs.
//
// Emissions: the forward gathers lp[b, t, z_s] itself from log_probs
// [B, T, V] (a row of V floats is read by every thread of the block, from
// L1). The JAX package gathers them outside with a one-hot matmul, a
// workaround for a slow XLA gather on the TPU; here the [B, T, S] emission
// tensor is never written. The adjoint needs no emissions at all: its
// weights come from alpha[t-1] alone. Its output, dLL/d lp_z [T, B, S], is
// scattered to the vocabulary outside. Accurate expf/logf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float ms = fmaxf(m, NEG);
  return ms + logf(expf(a0 - ms) + expf(a1 - ms) + expf(a2 - ms));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,      // [B, T, V]
                                 const int* __restrict__ z,         // [B, S]
                                 const int* __restrict__ skip,      // [B, S]
                                 const int* __restrict__ valid,     // [B, S]
                                 const int* __restrict__ in_len,    // [B]
                                 float* __restrict__ alpha,         // [T, B, S]
                                 int batch, int time, int vocab, int S) {
  extern __shared__ float rows[];              // [2, S]: alpha[t-1], alpha[t]
  const int b = blockIdx.x;
  const int len = in_len[b];
  const float* lpb = lp + static_cast<size_t>(b) * time * vocab;
  const int* zb = z + static_cast<size_t>(b) * S;
  const int* sk = skip + static_cast<size_t>(b) * S;
  const int* va = valid + static_cast<size_t>(b) * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float a = (s < 2 && va[s]) ? lpb[zb[s]] : NEG;
    rows[s] = a;
    alpha[static_cast<size_t>(b) * S + s] = a;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < time; ++t) {
    float* out = alpha + (static_cast<size_t>(t) * batch + b) * S;
    if (t < len) {                             // the same for every thread of the block
      const float* prev = rows + cur * S;
      float* next = rows + (1 - cur) * S;
      const float* lpt = lpb + static_cast<size_t>(t) * vocab;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        float a = NEG;
        if (va[s]) {
          const float a1 = s >= 1 ? prev[s - 1] : NEG;
          const float a2 = (s >= 2 && sk[s]) ? prev[s - 2] : NEG;
          a = lse3(prev[s], a1, a2) + lpt[zb[s]];
        }
        next[s] = a;
        out[s] = a;
      }
      __syncthreads();
      cur = 1 - cur;
    } else {
      for (int s = threadIdx.x; s < S; s += blockDim.x) out[s] = rows[cur * S + s];
    }
  }
}

__global__ void ctc_adjoint_kernel(const float* __restrict__ alpha,    // [T, B, S]
                                   const float* __restrict__ g_seed,   // [B, S]
                                   const int* __restrict__ skip,       // [B, S]
                                   const int* __restrict__ valid,      // [B, S]
                                   const int* __restrict__ in_len,     // [B]
                                   float* __restrict__ grad,           // [T, B, S]
                                   int batch, int time, int S) {
  extern __shared__ float smem[];
  float* g = smem;                 // dLL/d alpha[t]
  float* pre = smem + S;           // the step's LSE, clamped at NEG
  float* ge = smem + 2 * S;        // g masked to the valid states
  float* ap = smem + 3 * S;        // alpha[t-1]
  const int b = blockIdx.x;
  const int len = in_len[b];
  const int* sk = skip + static_cast<size_t>(b) * S;
  const int* va = valid + static_cast<size_t>(b) * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) g[s] = g_seed[static_cast<size_t>(b) * S + s];
  __syncthreads();
  for (int t = time - 1; t >= 1; --t) {
    float* out = grad + (static_cast<size_t>(t) * batch + b) * S;
    if (t < len) {                             // the same for every thread of the block
      const float* a_prev = alpha + (static_cast<size_t>(t - 1) * batch + b) * S;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float a0 = a_prev[s];
        const float a1 = s >= 1 ? a_prev[s - 1] : NEG;
        const float a2 = (s >= 2 && sk[s]) ? a_prev[s - 2] : NEG;
        pre[s] = fmaxf(lse3(a0, a1, a2), NEG);
        ap[s] = a0;
        const float gv = va[s] ? g[s] : 0.f;
        ge[s] = gv;
        out[s] = gv;
      }
      __syncthreads();
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float a0 = ap[s];
        float gn = ge[s] * expf(fminf(a0 - pre[s], 0.f));
        if (s + 1 < S) gn += ge[s + 1] * expf(fminf(a0 - pre[s + 1], 0.f));
        if (s + 2 < S && sk[s + 2]) gn += ge[s + 2] * expf(fminf(a0 - pre[s + 2], 0.f));
        g[s] = gn;
      }
      __syncthreads();
    } else {
      for (int s = threadIdx.x; s < S; s += blockDim.x) out[s] = 0.f;
    }
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    grad[static_cast<size_t>(b) * S + s] = (s < 2 && va[s]) ? g[s] : 0.f;
}

int threads_for(int S) {
  const int warps = (S + 31) / 32;
  return warps > 32 ? 1024 : 32 * warps;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of each launch for S lattice states.
extern "C" int ctc_alpha_smem_bytes(int S) { return static_cast<int>(2 * S * sizeof(float)); }
extern "C" int ctc_adjoint_smem_bytes(int S) { return static_cast<int>(4 * S * sizeof(float)); }

// alpha [T, B, S] of the batch, one block per sample. Contiguous device
// arrays of the shapes above (float32; z, skip, valid and in_len int32);
// ctc_alpha_smem_bytes(S) <= 48 KB. Returns cudaGetLastError().
extern "C" int ctc_alpha_f32(const float* lp, const int* z, const int* skip, const int* valid,
                             const int* in_len, float* alpha, int batch, int time, int vocab,
                             int S, void* stream) {
  ctc_alpha_kernel<<<batch, threads_for(S), ctc_alpha_smem_bytes(S),
                     static_cast<cudaStream_t>(stream)>>>(lp, z, skip, valid, in_len, alpha,
                                                          batch, time, vocab, S);
  return static_cast<int>(cudaGetLastError());
}

// dLL/d lp_z [T, B, S] from alpha and the seed dLL/d alpha[T-1] [B, S],
// one block per sample. Same conditions, with ctc_adjoint_smem_bytes(S).
extern "C" int ctc_adjoint_f32(const float* alpha, const float* g_seed, const int* skip,
                               const int* valid, const int* in_len, float* grad, int batch,
                               int time, int S, void* stream) {
  ctc_adjoint_kernel<<<batch, threads_for(S), ctc_adjoint_smem_bytes(S),
                       static_cast<cudaStream_t>(stream)>>>(alpha, g_seed, skip, valid, in_len,
                                                            grad, batch, time, S);
  return static_cast<int>(cudaGetLastError());
}
