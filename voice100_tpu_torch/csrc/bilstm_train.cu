// Bidirectional LSTM training recurrences for Hopper (sm_90a), float32:
// the state-saving forward and the reverse-time adjoint.
//
// Replaces the TPU kernels voice100_tpu/ops/lstm_pallas.py::_kernel_train_fwd
// (via _lstm_train_fwd_pair) and ::_kernel_train_bwd (via
// _lstm_train_bwd_pair), float32 variants (no bf16 streaming or state
// storage). Both directions are kept in natural (source) time: loop step s
// touches source time ts = s for the forward direction and T-1-s for the
// backward one, so every [2, B, T, *] array below is indexed by source time.
//
// Forward, one launch a step (lstm_train_fwd_step_kernel):
//     h_prev[d, b, ts] = h,  c_prev[d, b, ts] = c       (state entering the step)
//     gates = xg[d, b, ts] + h @ W_hh[d]^T              (gate order i, f, g, o)
//     c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//     v = ts < length[b]:  (h, c) = v ? (h', c') : (h, c),  out[b, ts, dH + u] = v ? h' : 0
//
// Backward, two launches a step, walking s from T-1 down to 0:
//   (a) lstm_train_bwd_gates_kernel recomputes the gates from the saved
//       (h_prev, c_prev), and for each unit
//           dh~ = v (dh + dout),  dc~ = dh~ sig(o) (1 - tanh^2 c') + v dc
//           dG  = (dc~ g i(1-i), dc~ c f(1-f), dc~ i (1-g^2), dh~ tanh(c') o(1-o))
//           dc  = dc~ f + (1 - v) dc
//       writing dG[d, b, ts] and the new dc of its own units;
//   (b) lstm_train_bwd_dh_kernel: dh = dG[d, b, ts] @ W_hh[d] + (1 - v) dh.
// dW_ih, dW_hh, db and dx are plain products over (B, T) outside (cuBLAS),
// as the JAX package computes them outside its kernel.
//
// What is hard on Hopper. The TPU kernels keep both directions' W_hh
// (8 MB float32 at H = 512) in VMEM and walk time on a sequential grid.
// Here 8 MB is far beyond an SM's 227 KB and blocks run in no order, so a
// step is a launch, ordered after the previous one by the stream, and W_hh
// is read from the 50 MB L2 every step. The backward step has two products
// with opposite contraction axes: the gate recompute h_prev W_hh^T splits
// by gate rows, but dh = dG W_hh contracts over all 4H gate rows, so every
// block needs every other block's dG of the same step. Hence the two
// launches: (a) partitions gate rows like the forward, (b) partitions the H
// output columns, reading W_hh [4H, H] row-major so that a warp's 32 lanes
// load 32 neighbouring columns.
//
// What the design does. In the forward and in (a) a block owns the
// 4 * UNITS gate rows of UNITS hidden units, so the cell update needs no
// reduction across blocks; grid = (H / UNITS, 2, ceil(B / BATCH_TILE)).
// The train batch is 64. BATCH_TILE = 16 keeps h_prev of the tile
// (16 x 512 x 4 B = 32 KB) within the default 48 KB of shared memory and
// gives 512 blocks at B = 64, about four on each of the 132 SMs, to hide
// the L2 latency of the W_hh rows; each block reads its 64 KB of W_hh rows
// once per 16 batch rows, so a step reads W_hh 4 times from L2 (32 MB). A
// 64-row tile would read W_hh once, but it needs 128 KB of dynamic shared
// memory and leaves one block of 8 warps per SM, every FMA waiting on a
// shared-memory read of h. (b) uses the same batch tile, 32 columns a
// block (one per lane) and the 8 warps splitting the 4H rows, reduced
// through shared memory. The (dh, dc) carries are updated in place: every
// element is read and written by the one thread that owns it. A
// persistent kernel with W_hh slices resident in shared memory and one
// grid sync a step would read W_hh once and launch once; that is later
// work. Accurate expf/tanhf, no fast math: the JAX kernels run float32 at
// Precision.HIGHEST.

#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 8;                      // hidden units per block
constexpr int ROWS = 4 * UNITS;               // gate rows per block
constexpr int BATCH_TILE = 16;                // batch rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr int DH_COLS = 32;                   // (b): output columns per block
constexpr int DH_CHUNK = 128;                 // (b): gate rows staged per pass

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ int source_time(int d, int s, int time) {
  return d == 0 ? s : time - 1 - s;
}

// gs[b * ROWS + q] = (hs[b] . W_hh[d, row(q)]) for the block's gate rows q,
// where hs holds BATCH_TILE rows of h in shared memory.
__device__ __forceinline__ void gate_products(const float* __restrict__ w_hh, const float* hs,
                                              float* gs, int d, int u0, int hidden) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
}

__global__ void __launch_bounds__(THREADS)
lstm_train_fwd_step_kernel(const float* __restrict__ xg,       // [2, B, T, 4H]
                           const float* __restrict__ w_hh,     // [2, 4H, H]
                           const int* __restrict__ lengths,    // [B]
                           const float* __restrict__ h_in,     // [2, B, H]
                           const float* __restrict__ c_in,     // [2, B, H]
                           float* __restrict__ h_out,          // [2, B, H]
                           float* __restrict__ c_out,          // [2, B, H]
                           float* __restrict__ out,            // [B, T, 2H]
                           float* __restrict__ h_prev,         // [2, B, T, H]
                           float* __restrict__ c_prev,         // [2, B, T, H]
                           int batch, int time, int hidden, int s) {
  extern __shared__ float smem[];
  float* hs = smem;                          // [BATCH_TILE, H]: h entering the step
  float* gs = smem + BATCH_TILE * hidden;    // [BATCH_TILE, ROWS]
  const int u0 = blockIdx.x * UNITS;
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BATCH_TILE;
  const int nb = min(BATCH_TILE, batch - b0);
  const int tid = threadIdx.x;

  const float* hp = h_in + (static_cast<size_t>(d) * batch + b0) * hidden;
  for (int i = tid; i < BATCH_TILE * hidden; i += THREADS) hs[i] = i < nb * hidden ? hp[i] : 0.f;
  __syncthreads();
  gate_products(w_hh, hs, gs, d, u0, hidden);
  __syncthreads();

  if (tid < nb * UNITS) {
    const int bl = tid / UNITS;
    const int j = tid % UNITS;
    const int b = b0 + bl;
    const int u = u0 + j;
    const int ts = source_time(d, s, time);
    const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;   // [2, B, T] index
    const float* x = xg + row * 4 * hidden;
    const float* g = gs + bl * ROWS;
    const float gi = sigmoid(x[u] + g[j]);
    const float gf = sigmoid(x[hidden + u] + g[UNITS + j]);
    const float gg = tanhf(x[2 * hidden + u] + g[2 * UNITS + j]);
    const float go = sigmoid(x[3 * hidden + u] + g[3 * UNITS + j]);
    const size_t st = (static_cast<size_t>(d) * batch + b) * hidden + u;
    const float hp_u = hs[bl * hidden + u];
    const float cp_u = c_in[st];
    const float c = gf * cp_u + gi * gg;
    const float h = go * tanhf(c);
    const bool valid = ts < lengths[b];
    h_prev[row * hidden + u] = hp_u;
    c_prev[row * hidden + u] = cp_u;
    h_out[st] = valid ? h : hp_u;
    c_out[st] = valid ? c : cp_u;
    out[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u] = valid ? h : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_train_bwd_gates_kernel(const float* __restrict__ xg,      // [2, B, T, 4H]
                            const float* __restrict__ w_hh,    // [2, 4H, H]
                            const int* __restrict__ lengths,   // [B]
                            const float* __restrict__ h_prev,  // [2, B, T, H]
                            const float* __restrict__ c_prev,  // [2, B, T, H]
                            const float* __restrict__ dout,    // [B, T, 2H]
                            const float* __restrict__ dh,      // [2, B, H]
                            float* __restrict__ dc,            // [2, B, H], in place
                            float* __restrict__ dg,            // [2, B, T, 4H]
                            int batch, int time, int hidden, int s) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* gs = smem + BATCH_TILE * hidden;
  const int u0 = blockIdx.x * UNITS;
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BATCH_TILE;
  const int nb = min(BATCH_TILE, batch - b0);
  const int tid = threadIdx.x;
  const int ts = source_time(d, s, time);

  for (int i = tid; i < BATCH_TILE * hidden; i += THREADS) {
    const int bl = i / hidden;
    hs[i] = bl < nb
        ? h_prev[((static_cast<size_t>(d) * batch + b0 + bl) * time + ts) * hidden + i % hidden]
        : 0.f;
  }
  __syncthreads();
  gate_products(w_hh, hs, gs, d, u0, hidden);
  __syncthreads();

  if (tid < nb * UNITS) {
    const int bl = tid / UNITS;
    const int j = tid % UNITS;
    const int b = b0 + bl;
    const int u = u0 + j;
    const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;
    const float* x = xg + row * 4 * hidden;
    const float* g = gs + bl * ROWS;
    const float gi = sigmoid(x[u] + g[j]);
    const float gf = sigmoid(x[hidden + u] + g[UNITS + j]);
    const float gg = tanhf(x[2 * hidden + u] + g[2 * UNITS + j]);
    const float go = sigmoid(x[3 * hidden + u] + g[3 * UNITS + j]);
    const float cp_u = c_prev[row * hidden + u];
    const float tanh_c = tanhf(gf * cp_u + gi * gg);
    const float v = ts < lengths[b] ? 1.f : 0.f;
    const size_t st = (static_cast<size_t>(d) * batch + b) * hidden + u;
    const float dc_u = dc[st];
    const float d_hcand =
        v * (dh[st] + dout[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u]);
    const float d_ccand = d_hcand * go * (1.f - tanh_c * tanh_c) + v * dc_u;
    float* dgr = dg + row * 4 * hidden;
    dgr[u] = d_ccand * gg * gi * (1.f - gi);
    dgr[hidden + u] = d_ccand * cp_u * gf * (1.f - gf);
    dgr[2 * hidden + u] = d_ccand * gi * (1.f - gg * gg);
    dgr[3 * hidden + u] = d_hcand * tanh_c * go * (1.f - go);
    dc[st] = d_ccand * gf + (1.f - v) * dc_u;
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_train_bwd_dh_kernel(const float* __restrict__ w_hh,      // [2, 4H, H]
                         const int* __restrict__ lengths,     // [B]
                         const float* __restrict__ dg,        // [2, B, T, 4H]
                         float* __restrict__ dh,              // [2, B, H], in place
                         int batch, int time, int hidden, int s) {
  __shared__ float dgs[BATCH_TILE * DH_CHUNK];          // dG rows of the tile, one chunk
  __shared__ float red[WARPS * BATCH_TILE * DH_COLS];   // per-warp partial sums
  const int j0 = blockIdx.x * DH_COLS;
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BATCH_TILE;
  const int nb = min(BATCH_TILE, batch - b0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ts = source_time(d, s, time);
  const int gates4 = 4 * hidden;
  const float* w = w_hh + static_cast<size_t>(d) * gates4 * hidden + j0 + lane;

  float acc[BATCH_TILE];
#pragma unroll
  for (int b = 0; b < BATCH_TILE; ++b) acc[b] = 0.f;
  for (int q0 = 0; q0 < gates4; q0 += DH_CHUNK) {
    for (int i = tid; i < BATCH_TILE * DH_CHUNK; i += THREADS) {
      const int bl = i / DH_CHUNK;
      dgs[i] = bl < nb
          ? dg[((static_cast<size_t>(d) * batch + b0 + bl) * time + ts) * gates4 + q0 + i % DH_CHUNK]
          : 0.f;
    }
    __syncthreads();
    constexpr int PER_WARP = DH_CHUNK / WARPS;
    for (int q = warp * PER_WARP; q < (warp + 1) * PER_WARP; ++q) {
      const float wq = __ldg(w + static_cast<size_t>(q0 + q) * hidden);
#pragma unroll
      for (int b = 0; b < BATCH_TILE; ++b) acc[b] = fmaf(dgs[b * DH_CHUNK + q], wq, acc[b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < BATCH_TILE; ++b) red[(warp * BATCH_TILE + b) * DH_COLS + lane] = acc[b];
  __syncthreads();
  for (int i = tid; i < nb * DH_COLS; i += THREADS) {
    const int bl = i / DH_COLS;
    const int l = i % DH_COLS;
    float sum = 0.f;
    for (int k = 0; k < WARPS; ++k) sum += red[(k * BATCH_TILE + bl) * DH_COLS + l];
    const int b = b0 + bl;
    const float v = ts < lengths[b] ? 1.f : 0.f;
    const size_t st = (static_cast<size_t>(d) * batch + b) * hidden + j0 + l;
    dh[st] = sum + (1.f - v) * dh[st];
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the forward and gate-recompute launches.
extern "C" int lstm_train_smem_bytes(int hidden) {
  return static_cast<int>((BATCH_TILE * hidden + BATCH_TILE * ROWS) * sizeof(float));
}

// Forward loop step s of both directions: reads the state (h_in, c_in),
// writes the new state (h_out, c_out), the outputs and the pre-update
// states at source time. Arrays are contiguous device arrays of the shapes
// above (float32, lengths int32); hidden is a multiple of 32 and
// lstm_train_smem_bytes(hidden) <= 48 KB. Returns cudaGetLastError().
extern "C" int lstm_train_fwd_step_f32(const float* xg, const float* w_hh, const int* lengths,
                                       const float* h_in, const float* c_in, float* h_out,
                                       float* c_out, float* out, float* h_prev, float* c_prev,
                                       int batch, int time, int hidden, int s, void* stream) {
  const dim3 grid(hidden / UNITS, 2, (batch + BATCH_TILE - 1) / BATCH_TILE);
  lstm_train_fwd_step_kernel<<<grid, THREADS, lstm_train_smem_bytes(hidden),
                               static_cast<cudaStream_t>(stream)>>>(
      xg, w_hh, lengths, h_in, c_in, h_out, c_out, out, h_prev, c_prev, batch, time, hidden, s);
  return static_cast<int>(cudaGetLastError());
}

// Backward loop step s of both directions: launches (a), then (b), on
// `stream`. dh and dc carry the state adjoints between steps (zero before
// step T-1) and are updated in place; dg receives dG at source time.
// Same conditions as the forward. Returns the first cudaGetLastError()
// that is not 0, checked after each launch.
extern "C" int lstm_train_bwd_step_f32(const float* xg, const float* w_hh, const int* lengths,
                                       const float* h_prev, const float* c_prev,
                                       const float* dout, float* dh, float* dc, float* dg,
                                       int batch, int time, int hidden, int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (batch + BATCH_TILE - 1) / BATCH_TILE;
  lstm_train_bwd_gates_kernel<<<dim3(hidden / UNITS, 2, tiles), THREADS,
                                lstm_train_smem_bytes(hidden), st>>>(
      xg, w_hh, lengths, h_prev, c_prev, dout, dh, dc, dg, batch, time, hidden, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_train_bwd_dh_kernel<<<dim3(hidden / DH_COLS, 2, tiles), THREADS, 0, st>>>(
      w_hh, lengths, dg, dh, batch, time, hidden, s);
  return static_cast<int>(cudaGetLastError());
}
