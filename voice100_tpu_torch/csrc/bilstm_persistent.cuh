// The biLSTM forward recurrence as one persistent cooperative launch a
// layer, for Hopper (sm_90a), float32; and the cp.async helpers the biLSTM
// kernels share. Included by bilstm.cu (inference, kernel 1) and
// bilstm_train.cu (state-saving train forward, kernel 2).
//
// Replaces the TPU kernels voice100_tpu/ops/lstm_pallas.py::_kernel (via
// _bilstm_pallas_call) and ::_kernel_train_fwd (via _lstm_train_fwd_pair),
// float32 variants. Both directions, in natural (source) time: loop step s
// touches ts = s for the forward direction and T-1-s for the backward one.
// Each step, for each row b and direction d:
//
//     gates = xg[d, b, ts] + h @ W_hh[d]^T            (gate order i, f, g, o)
//     c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//     v = ts < length[b]:  (h, c) = v ? (h', c') : (h, c),  out[b, ts, dH + u] = v ? h' : 0
//     SAVE_STATES: h_prev[d, b, ts] = h, c_prev[d, b, ts] = c   (the state entering the step)
//
// What bounds it on the H100: the recurrence is sequential in T and its
// work a step is small (8 H^2 flops a valid row), so the step's latency
// does: W_hh of both directions (8 MB at H = 512) is far beyond one SM's
// 227 KB, and every unit's next step needs every unit's h.
//
// What the design does. One cooperative launch a layer of 2 H / 8 blocks,
// one an SM (128 at H = 512), both directions in one grid. Block (d, u0)
// owns the 32 gate rows i, f, g, o of units u0..u0+7, so the cell update
// needs no reduction across blocks, and keeps for the whole launch in
// shared memory: its rows of W_hh[d] (32 x H, 64 KB at H = 512, stored
// k-major so one float4 holds 4 gate rows), and its units' c and h for
// all B rows. Each step the block writes its units' new h to a ping-pong
// exchange buffer [2, 2, B, H] in device memory (L2) and then, after a
// fence, releases its flag in ready[] (the steps it has finished). Before
// its next product a block acquires the flags of all the blocks of its own
// direction: a barrier among the H / 8 blocks of one direction, not the
// whole grid, so at ragged lengths each direction runs at its own pace
// (their valid rows differ: one shrinks as the other grows). Then every
// block reads h[d] of the rows it needs back through per-warp cp.async.cg
// double buffers in 16-column k chunks (the warps take the chunks in turn,
// so the stream overlaps the arithmetic) and sums the warps' partial
// products in shared memory. What the launch writes is read through
// cp.async.cg only, never through __ldg or the non-coherent L1; step s
// reads buffer s % 2 and writes 1 - s % 2, and a block writes only after
// the barrier, when every block of its direction has finished reading that
// buffer at the step before. The grid syncs once, after resetting the
// flags; all blocks are resident (cooperative launch), so the waits end.
//
// Frozen rows cost nothing: the wrapper passes the batch rows ordered by
// descending length, so the rows valid at a step are a prefix of that
// order in both directions (forward: length > s; backward: length >
// T-1-s), and the block loops over the prefix only. The product reads
// only the rows valid at the step before too (the others' h is 0, or the
// row is not needed), in passes of at most 64 rows whose lane mapping
// shrinks with the rows (8, 16, 32 or 64), so a serve batch of 8 does not
// pay for 64. Past a row's length the state passes through, out is 0 and
// kernel 2 still saves the frozen state. The next step's xg slices of the
// block's gate columns are prefetched into L2 while the step runs, and each
// thread loads its cells' xg into registers before the product.
//
// Accurate expf/tanhf and float32 FMA, no fast math, no TF32: the JAX
// kernels run float32 at Precision.HIGHEST.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ int source_time(int d, int s, int time) {
  return d == 0 ? s : time - 1 - s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(gmem));
}

__device__ __forceinline__ int ld_acquire(const int* gmem) {
  int value;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(value) : "l"(gmem) : "memory");
  return value;
}

__device__ __forceinline__ void st_release(int* gmem, int value) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(gmem), "r"(value) : "memory");
}

namespace persistent {


constexpr int UNITS = 8;                  // hidden units per block
constexpr int ROWS = 4 * UNITS;           // gate rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PASS = 64;                  // batch rows per pass of the product
constexpr int KC = 16;                    // columns of h per staged chunk
constexpr int KC_PAD = KC + 4;            // row stride: conflict-free float4 reads
constexpr int STAGE = PASS * KC_PAD;      // floats of one chunk buffer
constexpr int RED_LD = ROWS + 1;          // row stride of the warps' partial sums
static_assert(WARPS * PASS * RED_LD <= WARPS * 2 * STAGE, "the sums reuse the chunk buffers");
constexpr int CELLS = PASS * UNITS / THREADS;  // cells of a pass a thread updates
static_assert(CELLS * THREADS == PASS * UNITS, "the threads split a pass's cells evenly");

// Partial products of one pass: for the pass's rows r < live (in sorted
// order, from h_src, the exchange buffer at the pass's first row) and the
// block's gate rows q, this warp's share of the k chunks,
//     red[(warp * PASS + r) * RED_LD + q] = sum_k h[r, k] wt[k, q].
// P rows are mapped onto the lanes: P >= 32, each lane P / 32 rows and all
// 32 gate rows; P < 32, 32 / P lanes a row, P gate rows each. Rows from
// live to P are zero-filled and read nothing.
template <int P>
__device__ __forceinline__ void product_pass(const float* h_src, int live, int hidden,
                                             const float* wt, float* stage, float* red) {
  constexpr int RL = P >= 32 ? P / 32 : 1;   // batch rows a lane
  constexpr int QL = P >= 32 ? ROWS : P;     // gate rows a lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = P >= 32 ? lane : lane % P;
  const int q0 = P >= 32 ? 0 : (lane / P) * QL;
  float* buf = stage + warp * 2 * STAGE;
  const int chunks = hidden / KC;

  auto issue = [&](int chunk, int slot) {
    float* dst = buf + slot * STAGE;
    for (int i = lane; i < P * KC / 4; i += 32) {
      const int r = i / (KC / 4);
      const int col = (i % (KC / 4)) * 4;
      const bool fill = r < live;
      cp_async16(dst + r * KC_PAD + col,
                 h_src + static_cast<size_t>(fill ? r : 0) * hidden + chunk * KC + col, fill);
    }
    cp_async_commit();
  };

  float acc[RL][QL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
#pragma unroll
    for (int q = 0; q < QL; ++q) acc[i][q] = 0.f;
  }
  int slot = 0;
  if (warp < chunks) issue(warp, 0);
  for (int chunk = warp; chunk < chunks; chunk += WARPS, slot ^= 1) {
    if (chunk + WARPS < chunks) {
      issue(chunk + WARPS, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float* x = buf + slot * STAGE;
    const float* w = wt + chunk * KC * ROWS;
#pragma unroll 2
    for (int kq = 0; kq < KC; kq += 4) {
      float4 hv[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i)
        hv[i] = *reinterpret_cast<const float4*>(x + (r0 + 32 * i) * KC_PAD + kq);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int q = 0; q < QL; q += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(w + (kq + c) * ROWS + q0 + q);
#pragma unroll
          for (int i = 0; i < RL; ++i) {
            const float hk = c == 0 ? hv[i].x : c == 1 ? hv[i].y : c == 2 ? hv[i].z : hv[i].w;
            acc[i][q] = fmaf(hk, wv.x, acc[i][q]);
            acc[i][q + 1] = fmaf(hk, wv.y, acc[i][q + 1]);
            acc[i][q + 2] = fmaf(hk, wv.z, acc[i][q + 2]);
            acc[i][q + 3] = fmaf(hk, wv.w, acc[i][q + 3]);
          }
        }
      }
    }
    __syncwarp();  // the buffer is refilled by the next issue
  }
  __syncthreads();  // every warp is done with its buffers: reuse them for the sums
#pragma unroll
  for (int i = 0; i < RL; ++i) {
#pragma unroll
    for (int q = 0; q < QL; ++q) red[(warp * PASS + r0 + 32 * i) * RED_LD + q0 + q] = acc[i][q];
  }
}

template <bool SAVE_STATES>
__global__ void __launch_bounds__(THREADS, 1)
bilstm_persistent_kernel(const float* __restrict__ xg,      // [2, B, T, 4H]
                         const float* __restrict__ w_hh,    // [2, 4H, H]
                         const int* __restrict__ lengths,   // [B]
                         const int* __restrict__ order,     // [B]: rows by descending length
                         float* xchg,  // [2, 2, B, H]: h by sorted position, ping-pong; written
                                       // here, so never read through the read-only path
                         int* ready,   // [2 * H / UNITS]: steps each block has finished
                         float* __restrict__ out,           // [B, T, 2H]
                         float* __restrict__ h_prev,        // [2, B, T, H] (SAVE_STATES)
                         float* __restrict__ c_prev,        // [2, B, T, H] (SAVE_STATES)
                         int batch, int time, int hidden) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                          // [H, ROWS]: wt[k * ROWS + q] = W_hh[d][row(q)][k]
  float* stage = wt + hidden * ROWS;         // [WARPS, 2, STAGE]; after a pass, the sums
  float* c_s = stage + WARPS * 2 * STAGE;    // [B, UNITS] by sorted position
  float* h_s = c_s + batch * UNITS;          // [B, UNITS] (SAVE_STATES)
  int* len_s = reinterpret_cast<int*>(h_s + batch * UNITS);  // [B]: lengths, sorted
  int* row_s = len_s + batch;                // [B]: the batch row at each sorted position
  const int groups = hidden / UNITS;
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x % groups) * UNITS;
  const int tid = threadIdx.x;
  const int gates4 = 4 * hidden;

  // gate row q of the block: gate q / UNITS of unit u0 + q % UNITS
  for (int i = tid; i < ROWS * hidden; i += THREADS) {
    const int q = i / hidden;
    const int k = i % hidden;
    const int row = (q / UNITS) * hidden + u0 + q % UNITS;
    wt[k * ROWS + q] = __ldg(w_hh + (static_cast<size_t>(d) * gates4 + row) * hidden + k);
  }
  for (int i = tid; i < batch * UNITS; i += THREADS) c_s[i] = h_s[i] = 0.f;
  for (int r = tid; r < batch; r += THREADS) {
    row_s[r] = __ldg(order + r);
    len_s[r] = __ldg(lengths + row_s[r]);
  }
  if (tid == 0) ready[blockIdx.x] = 0;
  grid.sync();  // every flag is reset

  int n_prev = 0;  // rows valid at the step before: their h is in the exchange buffer
  for (int s = 0; s < time; ++s) {
    const int ts = source_time(d, s, time);
    int n = 0;  // rows valid at this step: a prefix of the sorted order
    for (int r0 = 0; r0 < batch; r0 += THREADS)
      n += __syncthreads_count(r0 + tid < batch && len_s[r0 + tid] > ts);
    // forward: n <= n_prev (0 at s = 0); backward: the rows from n_prev on
    // start this step from h = 0
    const int n_live = min(n, n_prev);

    // the next step's xg slices of the block's gate columns, into L2
    if (s + 1 < time) {
      const int tn = source_time(d, s + 1, time);
      for (int r = tid; r < batch; r += THREADS) {
        if (len_s[r] <= tn) continue;
        const float* x = xg + ((static_cast<size_t>(d) * batch + row_s[r]) * time + tn) * gates4
                         + u0;
#pragma unroll
        for (int g = 0; g < 4; ++g) prefetch_l2(x + g * hidden);
      }
    }

    const float* h_src = xchg + (static_cast<size_t>(s & 1) * 2 + d) * batch * hidden;
    float* h_dst = xchg + (static_cast<size_t>((s & 1) ^ 1) * 2 + d) * batch * hidden;
    for (int b0 = 0; b0 < n; b0 += PASS) {
      const int nb = min(PASS, n - b0);
      const int live = max(0, min(nb, n_live - b0));  // rows of the pass with h != 0
      // the gate inputs of this thread's cells (pass row p / UNITS, unit
      // p % UNITS), loaded now so that their latency hides behind the product
      float xv[CELLS][4];
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int p = tid + k * THREADS;
        if (p < nb * UNITS) {
          const float* x = xg + ((static_cast<size_t>(d) * batch + row_s[b0 + p / UNITS]) * time
                                 + ts) * gates4 + u0 + p % UNITS;
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[k][g] = __ldg(x + g * hidden);
        }
      }
      if (b0 == 0 && s > 0) {  // the barrier of this direction: every block's h of step s - 1
        if (tid < groups) {
          // a wait of seconds is a fault, not a slow step: end the launch with an error
          for (int spins = 0; ld_acquire(ready + d * groups + tid) < s; ++spins)
            if (spins > (1 << 22)) __trap();
        }
        __syncthreads();
      }
      const float* src = h_src + static_cast<size_t>(b0) * hidden;
      if (live > 32) product_pass<64>(src, live, hidden, wt, stage, stage);
      else if (live > 16) product_pass<32>(src, live, hidden, wt, stage, stage);
      else if (live > 8) product_pass<16>(src, live, hidden, wt, stage, stage);
      else if (live > 0) product_pass<8>(src, live, hidden, wt, stage, stage);
      __syncthreads();  // the sums are in place

#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int p = tid + k * THREADS;
        if (p >= nb * UNITS) continue;
        const int r = p / UNITS;
        const int j = p % UNITS;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < live) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
#pragma unroll
            for (int g = 0; g < 4; ++g) sum[g] += stage[(w * PASS + r) * RED_LD + g * UNITS + j];
          }
        }
        const int pos = b0 + r;
        const int b = row_s[pos];
        const int u = u0 + j;
        const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;  // [2, B, T] index
        const float gi = sigmoid(xv[k][0] + sum[0]);
        const float gf = sigmoid(xv[k][1] + sum[1]);
        const float gg = tanhf(xv[k][2] + sum[2]);
        const float go = sigmoid(xv[k][3] + sum[3]);
        const float c_in = c_s[pos * UNITS + j];
        const float c = gf * c_in + gi * gg;
        const float h = go * tanhf(c);
        if constexpr (SAVE_STATES) {
          h_prev[row * hidden + u] = h_s[pos * UNITS + j];
          c_prev[row * hidden + u] = c_in;
          h_s[pos * UNITS + j] = h;
        }
        c_s[pos * UNITS + j] = c;
        __stcg(h_dst + static_cast<size_t>(pos) * hidden + u, h);
        out[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u] = h;
      }
      __syncthreads();  // the sums' buffers are free for the next pass
    }

    // frozen rows: the state passes through, out is 0
    for (int p = tid; p < (batch - n) * UNITS; p += THREADS) {
      const int pos = n + p / UNITS;
      const int j = p % UNITS;
      const int b = row_s[pos];
      const int u = u0 + j;
      const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;
      if constexpr (SAVE_STATES) {
        h_prev[row * hidden + u] = h_s[pos * UNITS + j];
        c_prev[row * hidden + u] = c_s[pos * UNITS + j];
      }
      out[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u] = 0.f;
    }
    n_prev = n;
    __syncthreads();  // the block's h of this step is written
    if (tid == 0) {
      __threadfence();
      st_release(ready + blockIdx.x, s + 1);
    }
  }
}

// Dynamic shared memory of one block: the resident W_hh rows, the chunk
// buffers, the (c, h) carry and the sorted lengths and rows.
inline int smem_bytes(int batch, int hidden) {
  return static_cast<int>((hidden * ROWS + WARPS * 2 * STAGE + 2 * batch * UNITS) * sizeof(float)
                          + 2 * batch * sizeof(int));
}

// 0 if the launch can run with all 2 * hidden / UNITS blocks resident on the
// current device; else cudaErrorInvalidValue (hidden not a multiple of KC),
// cudaErrorNotSupported (no cooperative launch), an error of setting the
// shared-memory limit, or cudaErrorCooperativeLaunchTooLarge (too few SMs
// for the grid at this shared memory).
template <bool SAVE_STATES>
int check(int batch, int hidden) {
  if (hidden <= 0 || hidden % KC || batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = smem_bytes(batch, hidden);
  err = cudaFuncSetAttribute(bilstm_persistent_kernel<SAVE_STATES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bilstm_persistent_kernel<SAVE_STATES>, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm * sms < 2 * hidden / UNITS)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

// One cooperative launch for the whole layer; check's error without
// launching when the grid cannot be resident, else the launch's error.
template <bool SAVE_STATES>
int launch(const float* xg, const float* w_hh, const int* lengths, const int* order, float* xchg,
           int* ready, float* out, float* h_prev, float* c_prev, int batch, int time, int hidden,
           void* stream) {
  const int status = check<SAVE_STATES>(batch, hidden);
  if (status != 0) return status;
  void* args[] = {&xg, &w_hh, &lengths, &order, &xchg, &ready, &out, &h_prev, &c_prev,
                  &batch, &time, &hidden};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bilstm_persistent_kernel<SAVE_STATES>),
      dim3(2 * hidden / UNITS), dim3(THREADS), args, smem_bytes(batch, hidden),
      static_cast<cudaStream_t>(stream)));
}

}  // namespace persistent
}  // namespace
