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
// Forward, one persistent cooperative launch a layer (the kernel of
// bilstm_persistent.cuh with the state saves):
//     h_prev[d, b, ts] = h,  c_prev[d, b, ts] = c       (state entering the step)
//     gates = xg[d, b, ts] + h @ W_hh[d]^T              (gate order i, f, g, o)
//     c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//     v = ts < length[b]:  (h, c) = v ? (h', c') : (h, c),  out[b, ts, dH + u] = v ? h' : 0
//
// Backward, two launches a layer, split as the data dependencies split:
//   (1) lstm_train_bwd_gates_kernel, the gate pass: for every valid row
//       (ts < length[b]) of both directions, gates = xg + h_prev W_hh^T.
//       It needs no sequential carry: the pre-update states are saved.
//       The result is written into the dg buffer, which (2) overwrites in
//       place with dG, so no second [2, B, T, 4H] tensor is allocated.
//   (2) lstm_train_bwd_recurrence_kernel, one cooperative launch walking
//       s from T-1 down to 0; each step, for each unit,
//           dh~ = v (dh + dout),  dc~ = dh~ sig(o) (1 - tanh^2 c') + v dc
//           dG  = (dc~ g i(1-i), dc~ c f(1-f), dc~ i (1-g^2), dh~ tanh(c') o(1-o))
//           dc  = dc~ f + (1 - v) dc
//       then a grid sync, then dh = dG[d, :, ts] @ W_hh[d] + (1 - v) dh.
// dW_ih, dW_hh, db and dx are plain products over (B, T) outside (cuBLAS),
// as the JAX package computes them outside its kernel.
//
// What is hard on Hopper. The TPU kernels keep both directions' W_hh
// (8 MB float32 at H = 512) in VMEM and walk time on a sequential grid.
// Here 8 MB is far beyond an SM's 227 KB and blocks run in no order. The
// backward step has two products with opposite contraction axes: the gate
// recompute h_prev W_hh^T splits by gate rows, but dh = dG W_hh contracts
// over all 4H gate rows, so every block needs every other block's dG of
// the same step.
//
// What the design does. Forward: see bilstm_persistent.cuh.
// Backward: the gate recompute leaves the sequential loop altogether and
// becomes one tiled product over all valid rows (bound by its float32
// operations, 8 H^2 flops a row): 128 x 128 output tiles, 8 x 8 a thread
// in registers, so each shared-memory float4 feeds 32 FMAs, and cp.async
// double-buffered 16-deep k tiles; a tile past its row's length exits.
// The recurrence is one persistent cooperative launch: one block per
// (direction, group of REC_UNITS = 8 units), 128 blocks at H = 512, at
// most one per SM. Each block keeps its units' columns W_hh[d][:, u0:u0+8]
// (4H x 8 float32, 64 KB at H = 512) and their (dh, dc) carry for all B
// rows in shared memory for the whole loop, and owns its units' dG and dh:
// dG of the step is the only thing blocks exchange, through L2, once a
// step (grid.sync). The dh product streams each valid row's dG[d, b, ts]
// (4H floats) through per-warp cp.async double buffers in 32-row chunks,
// the 8 warps taking the chunks in turn, each lane two batch rows x 8 units
// of accumulators, reduced across warps in shared memory. Its limit is L2
// traffic: every block reads the step's whole dG[d] (B x 4H floats).
// Everything written during the launch (dg) is read through ld.global.cg
// and cp.async.cg, which bypass the SMs' non-coherent L1, never through
// __ldg. Accurate expf/tanhf, no fast math: the JAX kernels run float32 at
// Precision.HIGHEST.

#include "bilstm_persistent.cuh"

namespace {

// ---- backward (1): the gate pass, a tiled float32 product ----

constexpr int GM = 128;              // time rows per tile (of one batch row)
constexpr int GN = 128;              // gate columns per tile
constexpr int GK = 16;               // k depth per staged tile
constexpr int GK_PAD = GK + 4;       // row stride: conflict-free float4 reads
constexpr int GEMM_THREADS = 256;    // 16 x 16 threads, 8 x 8 outputs each
static_assert(GM == GN, "one loop stages both tiles");

// ---- backward (2): the persistent recurrence ----

constexpr int REC_UNITS = 8;         // hidden units per block
constexpr int REC_THREADS = 256;
constexpr int REC_WARPS = REC_THREADS / 32;
constexpr int REC_BT = 64;           // batch rows per pass of the dh product: two a lane
constexpr int REC_Q = 32;            // gate rows of dG per staged chunk
constexpr int REC_Q_PAD = REC_Q + 4;
constexpr int REC_STAGE = REC_BT * REC_Q_PAD;  // floats of one chunk buffer

__global__ void __launch_bounds__(GEMM_THREADS)
lstm_train_bwd_gates_kernel(const float* __restrict__ xg,       // [2, B, T, 4H]
                            const float* __restrict__ w_hh,     // [2, 4H, H]
                            const int* __restrict__ lengths,    // [B]
                            const float* __restrict__ h_prev,   // [2, B, T, H]
                            float* __restrict__ gates,          // [2, B, T, 4H] (the dg buffer)
                            int batch, int time, int hidden) {
  __shared__ __align__(16) float as[2][GM * GK_PAD];   // h_prev rows, k-contiguous
  __shared__ __align__(16) float bs[2][GN * GK_PAD];   // W_hh rows, k-contiguous
  const int t_tiles = (time + GM - 1) / GM;
  const int b = blockIdx.y / t_tiles;
  const int t0 = (blockIdx.y % t_tiles) * GM;
  const int n0 = blockIdx.x * GN;
  const int d = blockIdx.z;
  const int len = min(lengths[b], time);
  if (t0 >= len) return;                 // every row of the tile is past the length: dG = 0
  const int rows = len - t0;             // valid rows of the tile (may exceed GM)
  const int gates4 = 4 * hidden;
  const size_t row0 = (static_cast<size_t>(d) * batch + b) * time + t0;
  const float* a_src = h_prev + row0 * hidden;
  const float* b_src = w_hh + (static_cast<size_t>(d) * gates4 + n0) * hidden;
  const int tid = threadIdx.x;
  const int tx = tid % 16;               // output columns tx + 16 j
  const int ty = tid / 16;               // output rows ty + 16 i

  auto load = [&](int stage, int k0) {
    for (int i = tid; i < GM * GK / 4; i += GEMM_THREADS) {
      const int r = i / (GK / 4);
      const int c = (i % (GK / 4)) * 4;
      const bool valid = r < rows;
      cp_async16(&as[stage][r * GK_PAD + c],
                 a_src + static_cast<size_t>(valid ? r : 0) * hidden + k0 + c, valid);
      cp_async16(&bs[stage][r * GK_PAD + c], b_src + static_cast<size_t>(r) * hidden + k0 + c,
                 true);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int k_tiles = hidden / GK;
  load(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load((kt + 1) & 1, (kt + 1) * GK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a_tile = as[kt & 1];
    const float* b_tile = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < GK; kk += 4) {
      float4 a[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_tile + (ty + 16 * i) * GK_PAD + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = *reinterpret_cast<const float4*>(b_tile + (tx + 16 * j) * GK_PAD + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (ty + 16 * i >= rows) continue;
    const size_t off = (row0 + ty + 16 * i) * gates4 + n0 + tx;
#pragma unroll
    for (int j = 0; j < 8; ++j) gates[off + 16 * j] = acc[i][j] + xg[off + 16 * j];
  }
}

__global__ void __launch_bounds__(REC_THREADS, 1)
lstm_train_bwd_recurrence_kernel(const float* __restrict__ w_hh,     // [2, 4H, H]
                                 const int* __restrict__ lengths,    // [B]
                                 const float* __restrict__ c_prev,   // [2, B, T, H]
                                 const float* __restrict__ dout,     // [B, T, 2H]
                                 float* dg,  // [2, B, T, 4H]: gates in, dG out; written here,
                                             // so never read through the read-only path
                                 int batch, int time, int hidden) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int gates4 = 4 * hidden;
  float* wcol = smem;                                   // [4H, REC_UNITS]: W_hh[d][:, u0:u0+8]
  float* stage = wcol + gates4 * REC_UNITS;             // [REC_WARPS, 2, REC_STAGE]
  float* dh_s = stage + REC_WARPS * 2 * REC_STAGE;      // [B, REC_UNITS]
  float* dc_s = dh_s + batch * REC_UNITS;               // [B, REC_UNITS]
  const int groups = hidden / REC_UNITS;
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x % groups) * REC_UNITS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < gates4 * 2; i += REC_THREADS) {
    const float4* src = reinterpret_cast<const float4*>(
        w_hh + (static_cast<size_t>(d) * gates4 + i / 2) * hidden + u0) + i % 2;
    reinterpret_cast<float4*>(wcol)[i] = __ldg(src);
  }
  for (int i = tid; i < batch * REC_UNITS; i += REC_THREADS) dh_s[i] = dc_s[i] = 0.f;
  __syncthreads();

  float* buf = stage + warp * 2 * REC_STAGE;
  const int chunks = gates4 / REC_Q;
  for (int s = time - 1; s >= 0; --s) {
    const int ts = source_time(d, s, time);

    // dG of the block's units, over the gates the first launch left in dg
    for (int p = tid; p < batch * REC_UNITS; p += REC_THREADS) {
      const int b = p / REC_UNITS;
      const int u = u0 + p % REC_UNITS;
      const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;
      float* g = dg + row * gates4 + u;
      if (ts < __ldg(lengths + b)) {
        const float gi = sigmoid(__ldcg(g));
        const float gf = sigmoid(__ldcg(g + hidden));
        const float gg = tanhf(__ldcg(g + 2 * hidden));
        const float go = sigmoid(__ldcg(g + 3 * hidden));
        const float cp_u = __ldg(c_prev + row * hidden + u);
        const float tanh_c = tanhf(gf * cp_u + gi * gg);
        const float d_hcand =
            dh_s[p] + __ldg(dout + (static_cast<size_t>(b) * time + ts) * 2 * hidden
                            + d * hidden + u);
        const float d_ccand = d_hcand * go * (1.f - tanh_c * tanh_c) + dc_s[p];
        __stcg(g, d_ccand * gg * gi * (1.f - gi));
        __stcg(g + hidden, d_ccand * cp_u * gf * (1.f - gf));
        __stcg(g + 2 * hidden, d_ccand * gi * (1.f - gg * gg));
        __stcg(g + 3 * hidden, d_hcand * tanh_c * go * (1.f - go));
        dc_s[p] = d_ccand * gf;
      } else {  // a frozen step: dG = 0, (dh, dc) pass through
#pragma unroll
        for (int k = 0; k < 4; ++k) __stcg(g + k * hidden, 0.f);
      }
    }
    grid.sync();  // every block's dG at ts is in L2

    // the next step's dG-phase inputs of the valid rows, from device memory
    // into L2 while the dh product runs (own gate columns: no other block
    // writes them)
    if (s > 0) {
      const int tn = source_time(d, s - 1, time);
      for (int b = tid; b < batch; b += REC_THREADS) {
        if (tn >= __ldg(lengths + b)) continue;
        const size_t row = (static_cast<size_t>(d) * batch + b) * time + tn;
#pragma unroll
        for (int k = 0; k < 4; ++k) prefetch_l2(dg + row * gates4 + k * hidden + u0);
        prefetch_l2(c_prev + row * hidden + u0);
        prefetch_l2(dout + (static_cast<size_t>(b) * time + tn) * 2 * hidden + d * hidden + u0);
      }
    }

    // dh[:, own units] = dG[d, :, ts] @ W_hh[d][:, u0:u0+8] for the valid rows
    for (int b0 = 0; b0 < batch; b0 += REC_BT) {
      const int nb = min(REC_BT, batch - b0);
      auto issue = [&](int chunk, int slot) {
        float* dst = buf + slot * REC_STAGE;
        for (int i = lane; i < REC_BT * REC_Q / 4; i += 32) {
          const int r = i / (REC_Q / 4);
          const int col = (i % (REC_Q / 4)) * 4;
          const bool live = r < nb && ts < __ldg(lengths + b0 + r);  // else zeros
          const size_t row = (static_cast<size_t>(d) * batch + b0 + (live ? r : 0)) * time + ts;
          cp_async16(dst + r * REC_Q_PAD + col, dg + row * gates4 + chunk * REC_Q + col, live);
        }
        cp_async_commit();
      };
      float acc0[REC_UNITS], acc1[REC_UNITS];  // batch rows b0 + lane and b0 + lane + 32
#pragma unroll
      for (int j = 0; j < REC_UNITS; ++j) acc0[j] = acc1[j] = 0.f;
      int slot = 0;
      if (warp < chunks) issue(warp, 0);
      for (int chunk = warp; chunk < chunks; chunk += REC_WARPS, slot ^= 1) {
        if (chunk + REC_WARPS < chunks) {
          issue(chunk + REC_WARPS, slot ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const float* x = buf + slot * REC_STAGE;
        const float* w = wcol + chunk * REC_Q * REC_UNITS;
#pragma unroll 2
        for (int kq = 0; kq < REC_Q; kq += 4) {
          const float4 x0 = *reinterpret_cast<const float4*>(x + lane * REC_Q_PAD + kq);
          const float4 x1 = *reinterpret_cast<const float4*>(x + (lane + 32) * REC_Q_PAD + kq);
          const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
          const float xb[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 wl = *reinterpret_cast<const float4*>(w + (kq + c) * REC_UNITS);
            const float4 wh = *reinterpret_cast<const float4*>(w + (kq + c) * REC_UNITS + 4);
            const float wv[REC_UNITS] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
            for (int j = 0; j < REC_UNITS; ++j) {
              acc0[j] = fmaf(xa[c], wv[j], acc0[j]);
              acc1[j] = fmaf(xb[c], wv[j], acc1[j]);
            }
          }
        }
        __syncwarp();  // the buffer is refilled by the next issue
      }
      __syncthreads();  // every warp is done with its buffers: reuse them for the sums
      float* red = stage;  // [REC_WARPS, REC_BT, REC_UNITS]
#pragma unroll
      for (int j = 0; j < REC_UNITS; ++j) {
        red[(warp * REC_BT + lane) * REC_UNITS + j] = acc0[j];
        red[(warp * REC_BT + lane + 32) * REC_UNITS + j] = acc1[j];
      }
      __syncthreads();
      for (int p = tid; p < nb * REC_UNITS; p += REC_THREADS) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < REC_WARPS; ++k) sum += red[k * REC_BT * REC_UNITS + p];
        // a frozen row's dG is 0: its dh passes through unchanged
        if (ts < __ldg(lengths + b0 + p / REC_UNITS)) dh_s[b0 * REC_UNITS + p] = sum;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block of the forward launch.
extern "C" int lstm_train_fwd_smem_bytes(int batch, int hidden) {
  return persistent::smem_bytes(batch, hidden);
}

// 0 if the forward launch can run with all 2 * hidden / 8 blocks resident
// on the current device, else a CUDA error (see persistent::check).
extern "C" int lstm_train_fwd_check(int batch, int hidden) {
  return persistent::check<true>(batch, hidden);
}

// The forward of the whole layer: reads xg, w_hh, lengths and order (the
// rows by descending length, int32), uses xchg [2, 2, B, H] (float32) and
// ready [2 * hidden / 8] (int32) as scratch (any contents), writes the
// outputs and the pre-update states at source time. Arrays are contiguous
// device arrays of the shapes above; hidden is a multiple of 32. Returns
// lstm_train_fwd_check's error without launching, else the launch's.
extern "C" int lstm_train_fwd_f32(const float* xg, const float* w_hh, const int* lengths,
                                  const int* order, float* xchg, int* ready, float* out,
                                  float* h_prev, float* c_prev, int batch, int time, int hidden,
                                  void* stream) {
  return persistent::launch<true>(xg, w_hh, lengths, order, xchg, ready, out, h_prev, c_prev,
                                  batch, time, hidden, stream);
}

// Dynamic shared memory of the backward recurrence launch: the resident
// W_hh columns, the per-warp dG chunk buffers and the (dh, dc) carry.
extern "C" int lstm_train_bwd_smem_bytes(int batch, int hidden) {
  return static_cast<int>((4 * hidden * REC_UNITS + REC_WARPS * 2 * REC_STAGE
                           + 2 * batch * REC_UNITS) * sizeof(float));
}

// Whether the recurrence can run as one cooperative launch of
// 2 * hidden / 8 resident blocks on the current device: 0 if it can, else
// cudaErrorNotSupported (no cooperative launch), an error of setting the
// shared-memory limit, or cudaErrorCooperativeLaunchTooLarge (too few SMs
// for the grid at this shared memory).
extern "C" int lstm_train_bwd_check(int batch, int hidden) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = lstm_train_bwd_smem_bytes(batch, hidden);
  err = cudaFuncSetAttribute(lstm_train_bwd_recurrence_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_train_bwd_recurrence_kernel,
                                                      REC_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm * sms < 2 * hidden / REC_UNITS)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

// Backward launch (1), the gate pass: gates = xg + h_prev W_hh^T into dg
// for every row with ts < length[b]; other rows of dg are left as they
// are. hidden is a multiple of 32. Returns cudaGetLastError().
extern "C" int lstm_train_bwd_gates_f32(const float* xg, const float* w_hh, const int* lengths,
                                        const float* h_prev, float* dg, int batch, int time,
                                        int hidden, void* stream) {
  const int t_tiles = (time + GM - 1) / GM;
  const dim3 grid(4 * hidden / GN, batch * t_tiles, 2);
  lstm_train_bwd_gates_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xg, w_hh, lengths, h_prev, dg, batch, time, hidden);
  return static_cast<int>(cudaGetLastError());
}

// Backward launch (2), the recurrence: one cooperative launch of
// 2 * hidden / 8 blocks that overwrites dg (the gates of launch (1)) with
// dG at every row, zero past each length. Returns lstm_train_bwd_check's
// error without launching when the grid cannot be resident, else the
// launch's error.
extern "C" int lstm_train_bwd_recurrence_f32(const float* w_hh, const int* lengths,
                                             const float* c_prev, const float* dout, float* dg,
                                             int batch, int time, int hidden, void* stream) {
  const int status = lstm_train_bwd_check(batch, hidden);
  if (status != 0) return status;
  void* args[] = {&w_hh, &lengths, &c_prev, &dout, &dg, &batch, &time, &hidden};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lstm_train_bwd_recurrence_kernel), dim3(2 * hidden / REC_UNITS),
      dim3(REC_THREADS), args, lstm_train_bwd_smem_bytes(batch, hidden),
      static_cast<cudaStream_t>(stream)));
}
