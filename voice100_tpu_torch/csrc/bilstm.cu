// Bidirectional LSTM inference recurrence for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel voice100_tpu/ops/lstm_pallas.py::_kernel
// (reached through _bilstm_pallas_call and bilstm_pallas) with its float32
// semantics (VOICE100_TPU_LSTM_XG_DTYPE=float32). One launch advances both
// directions by one step:
//
//     gates = xg[t] + h_prev @ W_hh^T            (torch gate order i, f, g, o)
//     c = sig(f) * c_prev + sig(i) * tanh(g),  h = sig(o) * tanh(c)
//     valid = t_src < length:  (h, c) = valid ? (h, c) : (h_prev, c_prev)
//     out[b, t_src, d*H:(d+1)*H] = valid ? h : 0
//
// where t_src = t for the forward direction and T-1-t for the backward
// one, so the backward direction starts from each sequence's true end.
// The input projections xg = x @ W_ih^T + b_ih + b_hh are one matmul
// outside the kernel, as in the JAX wrapper (lstm_pallas.py:134-139).
//
// Bound on the H100: reading W_hh every step. The TPU kernel keeps both
// directions' W_hh ([2, 512, 2048] float32, 8 MB) and the state in VMEM
// across a sequential grid; 8 MB is far beyond one SM's 227 KB of shared
// memory and blocks run in no order, so here every step reads the whole
// 8 MB again from L2 (it fits in the 50 MB L2): 8 MB x T x layers a
// batch. At T = 501 the ~1000 launches a batch cost more than that.
//
// What the design does about it: blocks split the hidden units, UNITS per
// block, and each block owns the 4 * UNITS gate rows of its units, so it
// computes i, f, g and o of those units itself and updates their cell
// with no reduction across blocks. grid = (H / UNITS, 2 directions,
// ceil(B / BATCH_TILE)): 128 blocks for H = 512, B <= 8, about one for
// each of the 132 SMs, so the 8 MB of W_hh is read by the whole card in
// parallel. Each block reads h_prev into shared memory; lanes of a warp
// split the H-long dot products so W_hh rows load coalesced. The state
// ping-pongs between two buffers, ordered by the stream from one launch
// to the next. A persistent kernel that keeps each block's 64 KB slice of
// W_hh in shared memory and syncs the grid once a step would read W_hh
// once and launch once; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 8;                      // hidden units per block
constexpr int ROWS = 4 * UNITS;               // gate rows per block
constexpr int BATCH_TILE = 8;                 // batch rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(THREADS)
bilstm_step_kernel(const float* __restrict__ xg,       // [2, B, T, 4H]
                   const float* __restrict__ w_hh,     // [2, 4H, H]
                   const int* __restrict__ lengths,    // [B]
                   const float* __restrict__ h_in,     // [2, B, H]
                   const float* __restrict__ c_in,     // [2, B, H]
                   float* __restrict__ h_out,          // [2, B, H]
                   float* __restrict__ c_out,          // [2, B, H]
                   float* __restrict__ out,            // [B, T, 2H]
                   int batch, int time, int hidden, int t) {
  extern __shared__ float smem[];
  float* hs = smem;                          // [BATCH_TILE, H]: h_prev
  float* gs = smem + BATCH_TILE * hidden;    // [BATCH_TILE, ROWS]: h_prev @ W_hh^T
  const int u0 = blockIdx.x * UNITS;
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BATCH_TILE;
  const int nb = min(BATCH_TILE, batch - b0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* hp = h_in + (static_cast<size_t>(d) * batch + b0) * hidden;
  for (int i = tid; i < BATCH_TILE * hidden; i += THREADS) hs[i] = i < nb * hidden ? hp[i] : 0.f;
  __syncthreads();

  for (int q = warp * ROWS_PER_WARP; q < (warp + 1) * ROWS_PER_WARP; ++q) {
    // gate row q of this block: gate q / UNITS of unit u0 + q % UNITS
    const int row = (q / UNITS) * hidden + u0 + q % UNITS;
    const float* w = w_hh + (static_cast<size_t>(d) * 4 * hidden + row) * hidden;
    float acc[BATCH_TILE];
#pragma unroll
    for (int b = 0; b < BATCH_TILE; ++b) acc[b] = 0.f;
    for (int k = lane; k < hidden; k += 32) {
      const float wk = __ldg(w + k);
#pragma unroll
      for (int b = 0; b < BATCH_TILE; ++b) acc[b] = fmaf(wk, hs[b * hidden + k], acc[b]);
    }
#pragma unroll
    for (int b = 0; b < BATCH_TILE; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < BATCH_TILE; ++b) gs[b * ROWS + q] = acc[b];
    }
  }
  __syncthreads();

  if (tid < nb * UNITS) {
    const int bl = tid / UNITS;
    const int j = tid % UNITS;
    const int b = b0 + bl;
    const int u = u0 + j;
    const int ts = d == 0 ? t : time - 1 - t;
    const float* x = xg + ((static_cast<size_t>(d) * batch + b) * time + ts) * 4 * hidden;
    const float* g = gs + bl * ROWS;
    const float gi = sigmoid(x[u] + g[j]);
    const float gf = sigmoid(x[hidden + u] + g[UNITS + j]);
    const float gg = tanhf(x[2 * hidden + u] + g[2 * UNITS + j]);
    const float go = sigmoid(x[3 * hidden + u] + g[3 * UNITS + j]);
    const size_t s = (static_cast<size_t>(d) * batch + b) * hidden + u;
    const float c_prev = c_in[s];
    const float h_prev = hs[bl * hidden + u];
    const float c = gf * c_prev + gi * gg;
    const float h = go * tanhf(c);
    const bool valid = ts < lengths[b];
    h_out[s] = valid ? h : h_prev;
    c_out[s] = valid ? c : c_prev;
    out[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u] = valid ? h : 0.f;
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory a launch needs for this hidden size.
extern "C" int bilstm_step_smem_bytes(int hidden) {
  return static_cast<int>((BATCH_TILE * hidden + BATCH_TILE * ROWS) * sizeof(float));
}

// Step t of both directions. All arrays are contiguous device arrays of
// the shapes above (float32, lengths int32); hidden is a multiple of
// UNITS and bilstm_step_smem_bytes(hidden) <= 48 KB. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int bilstm_step_f32(const float* xg, const float* w_hh, const int* lengths,
                               const float* h_in, const float* c_in, float* h_out,
                               float* c_out, float* out, int batch, int time, int hidden,
                               int t, void* stream) {
  const dim3 grid(hidden / UNITS, 2, (batch + BATCH_TILE - 1) / BATCH_TILE);
  bilstm_step_kernel<<<grid, THREADS, bilstm_step_smem_bytes(hidden),
                       static_cast<cudaStream_t>(stream)>>>(
      xg, w_hh, lengths, h_in, c_in, h_out, c_out, out, batch, time, hidden, t);
  return static_cast<int>(cudaGetLastError());
}
