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
// Adjoint (ctc_adjoint_kernel), g_t = dLL/d alpha[t], seeded with g_seed at
// t = T-1, walking t down; ge_t(s) = valid(s) ? g_t(s) : 0:
//     t >= 1, active: grad[t] = ge_t,
//         g_{t-1}(s) = sum_k ge_t(s+k) w_k(s), k = 0, 1, 2 (k = 2 only where can_skip(s+2)),
//         w_k(s) = exp(min(alpha[t-1](s) - pre_t(s+k), 0)), pre_t = the step's LSE
//         recomputed from alpha[t-1] and clamped at NEG
//     t >= 1, held: grad[t] = 0, g unchanged;  t = 0: grad[0](s) = (s < 2 and valid(s)) ? g_0(s) : 0
// NEG = -1e30 and the LSE's max is clamped at NEG, as in the JAX kernels:
// with -inf, (-inf) - (-inf) would give NaN.
//
// What bounds them on Hopper. The TPU kernels carry the [B, S] lattice in
// VMEM across a sequential grid over time; Hopper's blocks run in no order
// and share nothing. Rows of the batch are independent, so one block owns
// one sample and walks its time inside one launch, a thread per state (up
// to four states a thread of the forward's 1024, eight a thread of each of
// the adjoint's two groups of 512), the lattice row in shared memory. Each step does a few hundred flops a sample and depends on the
// step before: a chain of T steps whose length is latency, not bytes or
// flops. So both kernels keep on the chain only what truly depends on the
// step before, and load or compute the rest ahead:
//
// * Forward: a thread's z_s, can_skip(s) and valid(s) sit in registers for
//   the whole loop. The lp rows of the next chunk of up to 32 steps (one
//   contiguous run of floats of the sample) are copied into shared memory
//   with cp.async while the current chunk is used (double-buffered; the
//   copies are spread over all threads and waited for before the last
//   step's barrier of a chunk), and each thread gathers lp[b, t, z_s] from
//   there. A step's chain is three neighbour reads of the double-buffered
//   row, lse3, one add, one store to shared memory and the one barrier; the
//   store of alpha[t] to device memory is fire-and-forget.
// * Adjoint: the weights of step t need alpha[t-1] alone, not g. The rows
//   of alpha stream in descending t through a ring of ALPHA_RING rows
//   (cp.async, issued ALPHA_RING - 2 iterations ahead), and the work is a
//   three-stage pipeline, one barrier an iteration. Iteration t propagates
//   g through step t with weights already in registers (three FMAs and the
//   neighbours ge_t(s+1), ge_t(s+2) from a double-buffered row) and turns
//   pre_{t-1} (shared an iteration earlier) into the weights of step t-1:
//   that is one warp group. A second warp group streams the ring and
//   computes pre_{t-2} from it. The two groups double the warps that hide
//   the latency of the exponentials, which is what bounds a step on one SM.
//   The chain is the FMAs, one store to shared memory and the barrier; pre
//   and the weights are the same expressions, in the same association, as
//   the JAX kernel's.
//
// Emissions: the forward gathers lp[b, t, z_s] itself from log_probs
// [B, T, V]; the [B, T, S] emission tensor is never written (the JAX
// package gathers with a one-hot matmul outside, a workaround for a slow
// XLA gather on the TPU). The adjoint needs no emissions. Its output,
// dLL/d lp_z [T, B, S], is scattered to the vocabulary outside. Accurate
// expf/logf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_STATES = 4 * MAX_THREADS;
constexpr int ALPHA_RING = 8;    // adjoint: rows of alpha in the ring
constexpr int PAD = 2;           // NEG entries in front of a row: s - 1 and s - 2 of s = 0

__device__ __forceinline__ float lse3(float a0, float a1, float a2) {
  const float m = fmaxf(fmaxf(a0, a1), a2);
  const float ms = fmaxf(m, NEG);
  return ms + logf(expf(a0 - ms) + expf(a1 - ms) + expf(a2 - ms));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Thread x owns states s = x + j * blockDim.x, j < N.
template <int N>
__global__ void __launch_bounds__(MAX_THREADS)
ctc_alpha_kernel(const float* __restrict__ lp,      // [B, T, V]
                 const int* __restrict__ z,         // [B, S]
                 const int* __restrict__ skip,      // [B, S]
                 const int* __restrict__ valid,     // [B, S]
                 const int* __restrict__ in_len,    // [B]
                 float* __restrict__ alpha,         // [T, B, S]
                 int batch, int time, int vocab, int S, int chunk) {
  extern __shared__ float smem[];
  float* prev = smem + PAD;                     // [2][PAD + S]: alpha[t-1], alpha[t]
  float* next = smem + (PAD + S) + PAD;
  float* rows = smem + 2 * (PAD + S);           // [2][chunk * V]: lp rows of two chunks of steps
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int len = max(1, min(in_len[b], time));
  const float* lpb = lp + static_cast<size_t>(b) * time * vocab;
  float* ab = alpha + static_cast<size_t>(b) * S;
  const size_t row = static_cast<size_t>(batch) * S;

  int zs[N];
  bool on[N], sk[N];
  float a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = threadIdx.x + j * nt;
    const bool in = s < S;
    zs[j] = in ? z[static_cast<size_t>(b) * S + s] : 0;
    on[j] = in && valid[static_cast<size_t>(b) * S + s] != 0;
    sk[j] = in && s >= 2 && skip[static_cast<size_t>(b) * S + s] != 0;
    a[j] = (s < 2 && on[j]) ? lpb[zs[j]] : NEG;
    if (in) {
      prev[s] = a[j];
      ab[s] = a[j];
    }
  }
  if (threadIdx.x < PAD) {
    prev[static_cast<int>(threadIdx.x) - PAD] = NEG;
    next[static_cast<int>(threadIdx.x) - PAD] = NEG;
  }
  // chunk c holds the lp rows of steps 1 + c * chunk .. (c + 1) * chunk, contiguous
  // in device memory, in buffer c & 1; every thread copies a share of its floats
  auto issue_chunk = [&](int c) {
    const int u0 = 1 + c * chunk;
    const int n = (min(u0 + chunk, len) - u0) * vocab;
    float* buf = rows + (c & 1) * chunk * vocab;
    const float* src = lpb + static_cast<size_t>(u0) * vocab;
    for (int i = threadIdx.x; i < n; i += nt) cp_async4(buf + i, src + i);
    cp_async_commit();
  };
  issue_chunk(0);
  cp_async_wait<0>();
  __syncthreads();

  for (int t = 1, c = 0, k = 0; t < len; ++t) {  // step t is row k of chunk c
    // the next chunk into the buffer the chunk before this one used
    if (k == 0 && 1 + (c + 1) * chunk < len) issue_chunk(c + 1);
    const float* e = rows + (c & 1) * chunk * vocab + k * vocab;
    float* out = ab + t * row;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int s = threadIdx.x + j * nt;
      if (s < S) {
        float v = NEG;
        if (on[j]) v = lse3(prev[s], prev[s - 1], sk[j] ? prev[s - 2] : NEG) + e[zs[j]];
        next[s] = v;
        out[s] = v;
        a[j] = v;
      }
    }
    if (k == chunk - 1) cp_async_wait<0>();     // this thread's share of the next chunk
    __syncthreads();                            // the step barrier
    float* swap = prev;
    prev = next;
    next = swap;
    if (++k == chunk) {
      k = 0;
      ++c;
    }
  }
  cp_async_wait<0>();
  for (int t = len; t < time; ++t) {            // held rows
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int s = threadIdx.x + j * nt;
      if (s < S) ab[t * row + s] = a[j];
    }
  }
}

// Two warp groups of `group` threads: thread x of the first owns states
// s = x + j * group (j < N) for the chain and the weights; thread x of the
// second the same states for the alpha stream and pre.
template <int N>
__global__ void __launch_bounds__(MAX_THREADS)
ctc_adjoint_kernel(const float* __restrict__ alpha,    // [T, B, S]
                   const float* __restrict__ g_seed,   // [B, S]
                   const int* __restrict__ skip,       // [B, S]
                   const int* __restrict__ valid,      // [B, S]
                   const int* __restrict__ in_len,     // [B]
                   float* __restrict__ grad,           // [T, B, S]
                   int batch, int time, int S) {
  extern __shared__ float smem[];
  const int width = PAD + S;
  float* ring = smem + PAD;                     // [ALPHA_RING][PAD + S] rows of alpha
  float* gbuf = smem + ALPHA_RING * width;      // [2][S]: ge_t by parity of t
  float* pbuf = gbuf + 2 * S;                   // [2][S]: pre_t by parity of t
  const int b = blockIdx.x;
  const int group = blockDim.x / 2;
  const bool chain = threadIdx.x < group;       // the same for every thread of a warp
  const int x = chain ? threadIdx.x : threadIdx.x - group;
  const int len = max(1, min(in_len[b], time));
  const float* ab = alpha + static_cast<size_t>(b) * S;
  float* gb = grad + static_cast<size_t>(b) * S;
  const size_t row = static_cast<size_t>(batch) * S;

  bool on[N], sk[N], m1[N], m2[N];
  float ge[N], w0[N], w1[N], w2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = x + j * group;
    const size_t i = static_cast<size_t>(b) * S + s;
    on[j] = s < S && valid[i] != 0;
    sk[j] = s < S && s >= 2 && skip[i] != 0;
    m1[j] = s + 1 < S;
    m2[j] = s + 2 < S && skip[i + 2] != 0;
    ge[j] = chain && on[j] ? g_seed[i] : 0.f;
    w0[j] = w1[j] = w2[j] = 0.f;
  }
  if (!chain) {                                 // held steps: no gradient
    for (int t = len; t < time; ++t) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int s = x + j * group;
        if (s < S) gb[t * row + s] = 0.f;
      }
    }
  }
  if (len == 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int s = x + j * group;
      if (chain && s < S) gb[s] = s < 2 ? ge[j] : 0.f;
    }
    return;
  }
  if (chain) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int s = x + j * group;
      if (s < S) {
        gb[(len - 1) * row + s] = ge[j];
        gbuf[((len - 1) & 1) * S + s] = ge[j];
      }
    }
  } else {
    for (int k = x; k < ALPHA_RING * PAD; k += group)
      ring[(k / PAD) * width - PAD + k % PAD] = NEG;
  }
  // row q of the stream is alpha[len - 2 - q], into slot q % ALPHA_RING;
  // the stream group copies its own states' entries
  auto issue_row = [&](int q) {
    const int r = len - 2 - q;
    if (!chain && r >= 0) {
      float* slot = ring + (q % ALPHA_RING) * width;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int s = x + j * group;
        if (s < S) cp_async4(slot + s, ab + r * row + s);
      }
    }
    cp_async_commit();
  };
  for (int q = 0; q < ALPHA_RING - 2; ++q) issue_row(q);
  cp_async_wait<ALPHA_RING - 3>();
  __syncthreads();

  // iteration t: the chain of step t and the weights of step t - 1 (first
  // group), pre of step t - 2 (second group)
  for (int t = len + 1; t >= 1; --t) {
    const int q = len + 1 - t;                  // the row pre reads: alpha[t - 3]
    // into the slot the weights read an iteration ago
    issue_row(q + ALPHA_RING - 2);
    if (chain) {
      if (t <= len - 1) {
        const float* gin = gbuf + (t & 1) * S;
        float* gout = gbuf + ((t - 1) & 1) * S;
        float* out = gb + (t - 1) * row;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int s = x + j * group;
          if (s < S) {
            float g = ge[j] * w0[j];
            if (m1[j]) g = fmaf(gin[s + 1], w1[j], g);
            if (m2[j]) g = fmaf(gin[s + 2], w2[j], g);
            ge[j] = on[j] ? g : 0.f;
            gout[s] = ge[j];
            out[s] = (t > 1 || s < 2) ? ge[j] : 0.f;
          }
        }
      }
      if (t >= 2 && t <= len) {                 // the weights of step t - 1, from alpha[t - 2]
        const float* pre = pbuf + ((t - 1) & 1) * S;
        const float* ar = ring + ((q + ALPHA_RING - 1) % ALPHA_RING) * width;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int s = x + j * group;
          if (s < S) {
            const float a = ar[s];
            w0[j] = expf(fminf(a - pre[s], 0.f));
            w1[j] = m1[j] ? expf(fminf(a - pre[s + 1], 0.f)) : 0.f;
            w2[j] = m2[j] ? expf(fminf(a - pre[s + 2], 0.f)) : 0.f;
          }
        }
      }
    } else if (t >= 3) {                        // pre of step t - 2, from alpha[t - 3]
      const float* ar = ring + (q % ALPHA_RING) * width;
      float* pre = pbuf + ((t - 2) & 1) * S;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int s = x + j * group;
        if (s < S) pre[s] = fmaxf(lse3(ar[s], ar[s - 1], sk[j] ? ar[s - 2] : NEG), NEG);
      }
    }
    cp_async_wait<ALPHA_RING - 3>();            // this thread's part of the next row
    __syncthreads();                            // the iteration barrier
  }
}

// States a thread owns: the smallest power of two for which `threads`
// threads cover S (0 where S is out of range).
int per_thread(int S, int threads) {
  if (S < 1 || S > MAX_STATES) return 0;
  int n = 1;
  while (n * threads < S) n *= 2;
  return n;
}

int warps32(int S, int n) { return 32 * (((S + n - 1) / n + 31) / 32); }

// Steps of lp rows a forward chunk holds: up to 4096 floats, at most 32 steps.
int alpha_chunk(int vocab) {
  const int steps = 4096 / (vocab > 0 ? vocab : 1);
  return steps < 1 ? 1 : (steps > 32 ? 32 : steps);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The largest S the kernels take: four states for each of the forward's
// 1024 threads, eight for each of the adjoint's two groups of 512.
extern "C" int ctc_max_states() { return MAX_STATES; }

// Dynamic shared memory of each launch for S lattice states (and V classes).
extern "C" int ctc_alpha_smem_bytes(int S, int vocab) {
  return static_cast<int>((2 * (PAD + S) + 2 * alpha_chunk(vocab) * vocab) * sizeof(float));
}
extern "C" int ctc_adjoint_smem_bytes(int S) {
  return static_cast<int>((ALPHA_RING * (PAD + S) + 4 * S) * sizeof(float));
}

// alpha [T, B, S] of the batch, one block per sample. Contiguous device
// arrays of the shapes above (float32; z, skip, valid and in_len int32);
// 1 <= S <= ctc_max_states(), ctc_alpha_smem_bytes(S, V) within the card's
// opt-in shared memory. Returns cudaGetLastError().
extern "C" int ctc_alpha_f32(const float* lp, const int* z, const int* skip, const int* valid,
                             const int* in_len, float* alpha, int batch, int time, int vocab,
                             int S, void* stream) {
  const int n = per_thread(S, MAX_THREADS);
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ctc_alpha_smem_bytes(S, vocab);
  const int threads = warps32(S, n);
  const int chunk = alpha_chunk(vocab);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n) {
#define CTC_ALPHA(N)                                                                         \
  case N:                                                                                    \
    err = prepare(ctc_alpha_kernel<N>, smem);                                                \
    if (err == cudaSuccess)                                                                  \
      ctc_alpha_kernel<N><<<batch, threads, smem, st>>>(lp, z, skip, valid, in_len, alpha,   \
                                                        batch, time, vocab, S, chunk);       \
    break;
    CTC_ALPHA(1)
    CTC_ALPHA(2)
    CTC_ALPHA(4)
#undef CTC_ALPHA
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dLL/d lp_z [T, B, S] from alpha and the seed dLL/d alpha[T-1] [B, S],
// one block per sample, two warp groups. Same conditions, with
// ctc_adjoint_smem_bytes(S).
extern "C" int ctc_adjoint_f32(const float* alpha, const float* g_seed, const int* skip,
                               const int* valid, const int* in_len, float* grad, int batch,
                               int time, int S, void* stream) {
  const int n = per_thread(S, MAX_THREADS / 2);
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ctc_adjoint_smem_bytes(S);
  const int threads = 2 * warps32(S, n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n) {
#define CTC_ADJOINT(N)                                                                       \
  case N:                                                                                    \
    err = prepare(ctc_adjoint_kernel<N>, smem);                                              \
    if (err == cudaSuccess)                                                                  \
      ctc_adjoint_kernel<N><<<batch, threads, smem, st>>>(alpha, g_seed, skip, valid, in_len, \
                                                          grad, batch, time, S);             \
    break;
    CTC_ADJOINT(1)
    CTC_ADJOINT(2)
    CTC_ADJOINT(4)
    CTC_ADJOINT(8)
#undef CTC_ADJOINT
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
