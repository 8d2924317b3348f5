// CTC Viterbi forced alignment for Hopper (sm_90a): the max-semiring
// forward that records a move into every lattice state, and the backtrace.
//
// Replaces the TPU kernels voice100_tpu/ops/ctc_pallas.py::_vit_fwd_kernel
// and ::_vit_bt_kernel, which ctc_viterbi_pallas wraps. Lattice of one
// sample: S = 2L + 1 states over the blank-interleaved labels z (blank 0);
// valid(s) = s < 2 * target_length + 1.
//
// Forward (viterbi_fwd_kernel):
//     alpha[0](s) = (s < 2 and valid(s)) ? lp[b, 0, z_s] : NEG,  moves[0] = 0
//     t >= 1, t < input_length:
//         c0 = alpha[t-1](s), c1 = alpha[t-1](s-1), c2 = z_s != 0 ? alpha[t-1](s-2) : NEG
//         (NEG where s - k < 0); best, move = c0, 0; then c1, c2 replace it only
//         when strictly greater, so ties go to the smallest move
//         alpha[t](s) = valid(s) ? best + lp[b, t, z_s] : NEG,  moves[t](s) = move
//     t >= input_length: alpha[t] = alpha[t-1], moves[t] = 0
// The 2-move gate is "may not land on a blank" (the reference's max_move=3
// rule), not the loss's skip gate: a 2-move between equal labels is allowed.
// NEG = -1e30, finite, as in the JAX kernels: in float32 -1e30 + lp == -1e30,
// so unreachable states tie exactly and the tie-break decides their moves;
// max and one float32 add are exact, so this kernel and the plain PyTorch
// version give the same moves bit for bit.
// Backtrace (viterbi_bt_kernel): from the final state at t = len - 1,
// pos_{t-1} = pos_t - moves[t](pos_t); path[t] = pos_t, labels[t] = z[pos_t],
// both 0 for t >= len. The final state (the last blank only on a strictly
// greater score) is chosen in PyTorch between the two launches.
//
// What is hard on Hopper, and what the design does about it. The TPU kernels
// carry the [B, S] row across a sequential grid over blocks of 8 steps, and
// write the whole alpha lattice [T, B, S] out; only its last row is read.
// Here rows of the batch are independent, so one block owns one sample and
// runs the whole time loop in one launch, threads over s, the row
// double-buffered in shared memory with one barrier a step. Each step is a
// few compares a state, so the forward is bound by the latency of the chain
// of T steps, not by bytes or operations. To keep global latency off that
// chain, the block stages the emissions of `chunk` steps at once (a sample's
// log_probs rows are contiguous) into shared memory and gathers lp[t, z_s]
// there; the JAX one-hot matmul that gathers them on the TPU is not needed.
// Moves are bytes (0/1/2), [T, B, S], written once; alpha stays on chip except
// its last row. The backtrace is a chain of T dependent reads a sample: one
// block a sample stages 64 steps of its moves into shared memory with all its
// threads, then one thread walks them, so each dependent read is a
// shared-memory read, and the block writes the positions and labels of the
// chunk together. A position falls at most 2 a step, so a chunk's walk from
// state p visits only states [p - 126, p]: the block stages that window of
// each row, not the whole row, with loads unrolled so that eight are in
// flight a thread; shared memory does not grow with S. No fast math: nothing
// here rounds differently from the plain version.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int BT_THREADS = 256;
constexpr int BT_ROWS = 64;                  // steps of a backtrace chunk
constexpr int BT_WIDTH = 2 * BT_ROWS - 1;    // states a chunk's walk can visit
constexpr int BT_UNROLL = 8;

__global__ void viterbi_fwd_kernel(const float* __restrict__ lp,       // [B, T, V]
                                   const int* __restrict__ z,          // [B, S]
                                   const int* __restrict__ valid,      // [B, S]
                                   const int* __restrict__ in_len,     // [B]
                                   unsigned char* __restrict__ moves,  // [T, B, S]
                                   float* __restrict__ alpha_last,     // [B, S]
                                   int batch, int time, int vocab, int S, int chunk) {
  extern __shared__ float smem[];
  float* rows = smem;                                   // [2, S]: alpha[t-1], alpha[t]
  int* zs = reinterpret_cast<int*>(smem + 2 * S);       // [S]
  int* vs = zs + S;                                     // [S]
  float* lpc = smem + 4 * S;                            // [chunk, V] emissions
  const int b = blockIdx.x;
  const int len = in_len[b];
  const float* lpb = lp + static_cast<size_t>(b) * time * vocab;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int zv = z[static_cast<size_t>(b) * S + s];
    const int vv = valid[static_cast<size_t>(b) * S + s];
    zs[s] = zv;
    vs[s] = vv;
    rows[s] = (s < 2 && vv) ? lpb[zv] : NEG;
    moves[static_cast<size_t>(b) * S + s] = 0;
  }
  __syncthreads();
  int cur = 0;
  for (int t0 = 1; t0 < time; t0 += chunk) {
    const int n = min(chunk, time - t0);
    if (t0 < len) {                            // the same for every thread of the block
      for (int i = threadIdx.x; i < n * vocab; i += blockDim.x)
        lpc[i] = lpb[static_cast<size_t>(t0) * vocab + i];
      __syncthreads();
    }
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      unsigned char* mrow = moves + (static_cast<size_t>(t) * batch + b) * S;
      if (t < len) {
        const float* prev = rows + cur * S;
        float* next = rows + (1 - cur) * S;
        const float* e = lpc + k * vocab;
        for (int s = threadIdx.x; s < S; s += blockDim.x) {
          float best = prev[s];
          unsigned char m = 0;
          const float c1 = s >= 1 ? prev[s - 1] : NEG;
          if (c1 > best) { best = c1; m = 1; }
          const float c2 = (s >= 2 && zs[s] != 0) ? prev[s - 2] : NEG;
          if (c2 > best) { best = c2; m = 2; }
          next[s] = vs[s] ? best + e[zs[s]] : NEG;
          mrow[s] = m;
        }
        __syncthreads();
        cur = 1 - cur;
      } else {
        for (int s = threadIdx.x; s < S; s += blockDim.x) mrow[s] = 0;
      }
    }
    // every thread is past its reads of lpc before the next chunk is staged
    __syncthreads();
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    alpha_last[static_cast<size_t>(b) * S + s] = rows[cur * S + s];
}

__global__ void viterbi_bt_kernel(const unsigned char* __restrict__ moves,  // [T, B, S]
                                  const int* __restrict__ final_pos,        // [B]
                                  const int* __restrict__ in_len,           // [B]
                                  const int* __restrict__ z,                // [B, S]
                                  int* __restrict__ path,                   // [B, T]
                                  int* __restrict__ labels,                 // [B, T]
                                  int batch, int time, int S) {
  __shared__ int posbuf[BT_ROWS];
  __shared__ int top;                                    // the position at a chunk's top
  __shared__ unsigned char stage[BT_ROWS * BT_WIDTH];   // [n, 2n - 1] window of moves
  const int b = blockIdx.x;
  const int len = max(0, min(in_len[b], time));
  int* pb = path + static_cast<size_t>(b) * time;
  int* lb = labels + static_cast<size_t>(b) * time;
  const int* zb = z + static_cast<size_t>(b) * S;

  for (int t = len + threadIdx.x; t < time; t += blockDim.x) {
    pb[t] = 0;
    lb[t] = 0;
  }
  // the final state is at most 2L; the clamp only keeps a bad input in bounds
  if (threadIdx.x == 0) top = max(0, min(final_pos[b], S - 1));
  __syncthreads();
  for (int hi = len; hi > 0; hi -= BT_ROWS) {
    const int lo = max(hi - BT_ROWS, 0);
    const int n = hi - lo;
    // n steps back from `top` the walk stays in states [top - 2(n-1), top]
    const int width = 2 * n - 1;
    const int c0 = max(0, top - (width - 1));
    const int total = n * width;
    for (int i0 = threadIdx.x; i0 < total; i0 += BT_UNROLL * blockDim.x) {
      unsigned char v[BT_UNROLL];
#pragma unroll
      for (int u = 0; u < BT_UNROLL; ++u) {   // loads first, so they are in flight together
        const int i = i0 + u * blockDim.x;
        const int r = i / width;
        const int c = c0 + i - r * width;
        v[u] = (i < total && c < S) ? moves[(static_cast<size_t>(lo + r) * batch + b) * S + c] : 0;
      }
#pragma unroll
      for (int u = 0; u < BT_UNROLL; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) stage[i] = v[u];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int pos = top;
      for (int t = hi - 1; t >= lo; --t) {
        posbuf[t - lo] = pos;
        pos = max(pos - static_cast<int>(stage[(t - lo) * width + pos - c0]), 0);
      }
      top = pos;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = posbuf[i];
      pb[lo + i] = p;
      lb[lo + i] = zb[p];
    }
    __syncthreads();
  }
}

int threads_for(int S) {
  const int warps = (S + 31) / 32;
  return warps > 32 ? 1024 : 32 * warps;
}

// Steps of emissions the forward stages at once: at most 32, and at most
// 16 KB of them.
int fwd_chunk(int vocab) {
  const int steps = 4096 / (vocab > 0 ? vocab : 1);
  return steps < 1 ? 1 : (steps > 32 ? 32 : steps);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of a forward launch.
extern "C" int viterbi_fwd_smem_bytes(int S, int vocab) {
  return static_cast<int>((4 * S + fwd_chunk(vocab) * vocab) * sizeof(float));
}

// moves [T, B, S] (uint8) and the last lattice row [B, S] of the batch, one
// block per sample. Contiguous device arrays of the shapes above (log_probs
// float32; z, valid and in_len int32; z < vocab); viterbi_fwd_smem_bytes <=
// 48 KB. Returns cudaGetLastError().
extern "C" int viterbi_fwd_f32(const float* lp, const int* z, const int* valid, const int* in_len,
                               unsigned char* moves, float* alpha_last, int batch, int time,
                               int vocab, int S, void* stream) {
  if (batch > 0 && time > 0) {
    viterbi_fwd_kernel<<<batch, threads_for(S), viterbi_fwd_smem_bytes(S, vocab),
                         static_cast<cudaStream_t>(stream)>>>(
        lp, z, valid, in_len, moves, alpha_last, batch, time, vocab, S, fwd_chunk(vocab));
  }
  return static_cast<int>(cudaGetLastError());
}

// path and labels [B, T] (int32) from the moves, the final states [B] and
// the input lengths, one block per sample. Contiguous device arrays; any S.
extern "C" int viterbi_backtrace_i32(const unsigned char* moves, const int* final_pos,
                                     const int* in_len, const int* z, int* path, int* labels,
                                     int batch, int time, int S, void* stream) {
  if (batch > 0 && time > 0) {
    viterbi_bt_kernel<<<batch, BT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        moves, final_pos, in_len, z, path, labels, batch, time, S);
  }
  return static_cast<int>(cudaGetLastError());
}
