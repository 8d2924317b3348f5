// Bidirectional LSTM training recurrences for Hopper (sm_90a): the
// state-saving forward and the reverse-time adjoint.
//
// Replaces the TPU kernels voice100_tpu/ops/lstm_pallas.py::_kernel_train_fwd
// (via _lstm_train_fwd_pair) and ::_kernel_train_bwd (via
// _lstm_train_bwd_pair), in both their variants. The *_f32 entries are the
// float32 ones. The *_bf16 entries are the mixed-precision ones of the
// precision knob (lstm_pallas.py:259-264, :281-319, :437): the forward
// reads a bf16 xg and stores the saved states in bf16; the backward reads
// bf16 xg, h_prev, c_prev and dout, each widened to float32 as it is
// loaded, and writes dG in bf16. The recurrences, their carries, the
// recomputed gates and the dG that forms dh stay float32 in both.
// Both directions are kept in natural (source) time: loop step s
// touches source time ts = s for the forward direction and T-1-s for the
// backward one, so every [2, B, T, *] array below is indexed by source time.
//
// Forward, one persistent cooperative launch a layer with the state saves:
// the kernel of bilstm_persistent.cuh for float32, of bilstm_fwd_mma.cuh
// (the product on tensor cores) for bf16:
//     h_prev[d, b, ts] = h,  c_prev[d, b, ts] = c       (state entering the step)
//     gates = xg[d, b, ts] + h @ W_hh[d]^T              (gate order i, f, g, o)
//     c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//     v = ts < length[b]:  (h, c) = v ? (h', c') : (h, c),  out[b, ts, dH + u] = v ? h' : 0
//
// Backward, two launches a layer, split as the data dependencies split:
//   (1) lstm_train_bwd_gates_kernel, the gate pass: for every valid row
//       (ts < length[b]) of both directions, gates = xg + h_prev W_hh^T.
//       It needs no sequential carry: the pre-update states are saved.
//       The float32 variant writes the result into the dg buffer, which (2)
//       overwrites in place with dG, so no second [2, B, T, 4H] tensor is
//       allocated. The bf16 variant writes it into a float32 buffer of its
//       own: the gates are float32 inside the JAX kernel (lstm_pallas.py:
//       284-292), and a bf16 dg buffer would round them.
//   (2) lstm_train_bwd_recurrence_kernel, one cooperative launch walking
//       s from T-1 down to 0; each step, for each unit,
//           dh~ = v (dh + dout),  dc~ = dh~ sig(o) (1 - tanh^2 c') + v dc
//           dG  = (dc~ g i(1-i), dc~ c f(1-f), dc~ i (1-g^2), dh~ tanh(c') o(1-o))
//           dc  = dc~ f + (1 - v) dc
//       then a grid sync, then dh = dG[d, :, ts] @ W_hh[d] + (1 - v) dh.
//       The blocks exchange the float32 dG of the step for that product,
//       as JAX forms dh from its float32 da (lstm_pallas.py:315-319),
//       through the dg rows themselves. The bf16 variant's recurrence is
//       the kernel of bilstm_bwd_cluster.cuh: clusters of blocks share each
//       step's float32 dG (a ping-pong exchange by sorted row), a barrier
//       for each direction, the same arithmetic in the same order, and dG
//       stored in bf16; the template below keeps its bf16 branches, which
//       no entry instantiates.
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
// What the design does. Forward: see bilstm_persistent.cuh and
// bilstm_fwd_mma.cuh.
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

#include <type_traits>

#include "bilstm_persistent.cuh"
#include "bilstm_bwd_cluster.cuh"
#include "bilstm_fwd_mma.cuh"

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

// Four consecutive values of a staged h_prev row as float32.
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// IT, the element type of xg and h_prev: float or __nv_bfloat16 (staged in
// shared memory as it is stored, widened as it is read). The products and
// the gates are float32 either way.
template <typename IT>
__global__ void __launch_bounds__(GEMM_THREADS)
lstm_train_bwd_gates_kernel(const IT* __restrict__ xg,          // [2, B, T, 4H]
                            const float* __restrict__ w_hh,     // [2, 4H, H]
                            const int* __restrict__ lengths,    // [B]
                            const IT* __restrict__ h_prev,      // [2, B, T, H]
                            float* __restrict__ gates,          // [2, B, T, 4H]
                            int batch, int time, int hidden) {
  constexpr int A_PER_16B = 16 / sizeof(IT);           // elements of one cp.async
  constexpr int A_PAD = GK + A_PER_16B;                // 16 B of padding a row
  __shared__ __align__(16) IT as[2][GM * A_PAD];       // h_prev rows, k-contiguous
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
  const IT* a_src = h_prev + row0 * hidden;
  const float* b_src = w_hh + (static_cast<size_t>(d) * gates4 + n0) * hidden;
  const int tid = threadIdx.x;
  const int tx = tid % 16;               // output columns tx + 16 j
  const int ty = tid / 16;               // output rows ty + 16 i

  auto load = [&](int stage, int k0) {
    for (int i = tid; i < GM * GK / A_PER_16B; i += GEMM_THREADS) {
      const int r = i / (GK / A_PER_16B);
      const int c = (i % (GK / A_PER_16B)) * A_PER_16B;
      const bool valid = r < rows;
      cp_async16(&as[stage][r * A_PAD + c],
                 a_src + static_cast<size_t>(valid ? r : 0) * hidden + k0 + c, valid);
    }
    for (int i = tid; i < GN * GK / 4; i += GEMM_THREADS) {
      const int r = i / (GK / 4);
      const int c = (i % (GK / 4)) * 4;
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
    const IT* a_tile = as[kt & 1];
    const float* b_tile = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < GK; kk += 4) {
      float4 a[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = load4_f32(a_tile + (ty + 16 * i) * A_PAD + kk);
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
    for (int j = 0; j < 8; ++j) gates[off + 16 * j] = acc[i][j] + ldg_f32(xg + off + 16 * j);
  }
}

// IT, the element type of c_prev, dout and (bf16) the dG output. IT =
// float: dg holds the gates in and dG out, and is the exchange. IT =
// __nv_bfloat16: dg holds the float32 gates in, xchg [2, 2, B, 4H] is the
// exchange and dg_out [2, B, T, 4H] receives dG in bf16.
template <typename IT>
__global__ void __launch_bounds__(REC_THREADS, 1)
lstm_train_bwd_recurrence_kernel(const float* __restrict__ w_hh,     // [2, 4H, H]
                                 const int* __restrict__ lengths,    // [B]
                                 const IT* __restrict__ c_prev,      // [2, B, T, H]
                                 const IT* __restrict__ dout,        // [B, T, 2H]
                                 float* dg,  // [2, B, T, 4H]: gates in (float32 variant: dG
                                             // out); written here, so never read through the
                                             // read-only path
                                 float* xchg,                        // bf16 variant only
                                 IT* __restrict__ dg_out,            // bf16 variant only
                                 int batch, int time, int hidden) {
  constexpr bool BF16 = !std::is_same<IT, float>::value;
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
    // the float32 dG of step s of row b starts at ex + b * ex_stride
    float* ex = BF16 ? xchg + ((static_cast<size_t>(s & 1) * 2 + d) * batch) * gates4
                     : dg + (static_cast<size_t>(d) * batch * time + ts) * gates4;
    const size_t ex_stride = BF16 ? static_cast<size_t>(gates4)
                                  : static_cast<size_t>(time) * gates4;

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
        const float cp_u = ldg_f32(c_prev + row * hidden + u);
        const float tanh_c = tanhf(gf * cp_u + gi * gg);
        const float d_hcand =
            dh_s[p] + ldg_f32(dout + (static_cast<size_t>(b) * time + ts) * 2 * hidden
                              + d * hidden + u);
        const float d_ccand = d_hcand * go * (1.f - tanh_c * tanh_c) + dc_s[p];
        const float da[4] = {d_ccand * gg * gi * (1.f - gi), d_ccand * cp_u * gf * (1.f - gf),
                             d_ccand * gi * (1.f - gg * gg), d_hcand * tanh_c * go * (1.f - go)};
        float* e = ex + b * ex_stride + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          __stcg(e + k * hidden, da[k]);
          if constexpr (BF16) store_f32(dg_out + row * gates4 + u + k * hidden, da[k]);
        }
        dc_s[p] = d_ccand * gf;
      } else {  // a frozen step: dG = 0, (dh, dc) pass through
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (BF16) store_f32(dg_out + row * gates4 + u + k * hidden, 0.f);
          else __stcg(g + k * hidden, 0.f);
        }
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
          const size_t row = b0 + (live ? r : 0);
          cp_async16(dst + r * REC_Q_PAD + col, ex + row * ex_stride + chunk * REC_Q + col, live);
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

// The bf16 variant's launch (bilstm_fwd_mma.cuh): its dynamic shared
// memory a block, and 0 if all its blocks can be resident on the current
// device, else a CUDA error (see fwd_mma::check).
extern "C" int lstm_train_fwd_smem_bytes_bf16(int batch, int hidden) {
  return fwd_mma::smem_bytes(batch, hidden);
}
extern "C" int lstm_train_fwd_check_bf16(int batch, int hidden) {
  return fwd_mma::check<true>(batch, hidden);
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

// The bf16 variant (bilstm_fwd_mma.cuh): xg [2, B, T, 4H] in bf16 and the
// states h_prev, c_prev [2, B, T, H] stored in bf16; the scratch xchg of
// 2 * 2 * ceil(B / 16) * 16 * H floats' bytes (h split in bf16 halves, in
// the mma's fragment order) and ready (zeroed on the stream first), any
// contents; out as lstm_train_fwd_f32. Returns lstm_train_fwd_check_bf16's
// error without launching, else the memset's or the launch's.
extern "C" int lstm_train_fwd_bf16(const __nv_bfloat16* xg, const float* w_hh,
                                   const int* lengths, const int* order, float* xchg, int* ready,
                                   float* out, __nv_bfloat16* h_prev, __nv_bfloat16* c_prev,
                                   int batch, int time, int hidden, void* stream) {
  return fwd_mma::launch<true>(xg, w_hh, lengths, order, xchg, ready, out, h_prev, c_prev, batch,
                               time, hidden, stream);
}

// Dynamic shared memory of the float32 backward recurrence launch: the
// resident W_hh columns, the per-warp dG chunk buffers and the (dh, dc)
// carry.
extern "C" int lstm_train_bwd_smem_bytes(int batch, int hidden) {
  return static_cast<int>((4 * hidden * REC_UNITS + REC_WARPS * 2 * REC_STAGE
                           + 2 * batch * REC_UNITS) * sizeof(float));
}

namespace {

// Whether the recurrence can run as one cooperative launch of
// 2 * hidden / 8 resident blocks on the current device: 0 if it can, else
// cudaErrorNotSupported (no cooperative launch), an error of setting the
// shared-memory limit, or cudaErrorCooperativeLaunchTooLarge (too few SMs
// for the grid at this shared memory).
template <typename IT>
int bwd_check(int batch, int hidden) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = lstm_train_bwd_smem_bytes(batch, hidden);
  err = cudaFuncSetAttribute(lstm_train_bwd_recurrence_kernel<IT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_train_bwd_recurrence_kernel<IT>, REC_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm * sms < 2 * hidden / REC_UNITS)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

template <typename IT>
int bwd_gates(const IT* xg, const float* w_hh, const int* lengths, const IT* h_prev,
              float* gates, int batch, int time, int hidden, void* stream) {
  const int t_tiles = (time + GM - 1) / GM;
  const dim3 grid(4 * hidden / GN, batch * t_tiles, 2);
  lstm_train_bwd_gates_kernel<IT><<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xg, w_hh, lengths, h_prev, gates, batch, time, hidden);
  return static_cast<int>(cudaGetLastError());
}

template <typename IT>
int bwd_recurrence(const float* w_hh, const int* lengths, const IT* c_prev, const IT* dout,
                   float* dg, float* xchg, IT* dg_out, int batch, int time, int hidden,
                   void* stream) {
  const int status = bwd_check<IT>(batch, hidden);
  if (status != 0) return status;
  void* args[] = {&w_hh, &lengths, &c_prev, &dout, &dg, &xchg, &dg_out, &batch, &time, &hidden};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lstm_train_bwd_recurrence_kernel<IT>),
      dim3(2 * hidden / REC_UNITS), dim3(REC_THREADS), args,
      lstm_train_bwd_smem_bytes(batch, hidden), static_cast<cudaStream_t>(stream)));
}

}  // namespace

// 0 if the float32 recurrence can run with all 2 * hidden / 8 blocks
// resident on the current device, else a CUDA error (see bwd_check).
extern "C" int lstm_train_bwd_check(int batch, int hidden) {
  return bwd_check<float>(batch, hidden);
}

// The bf16 variant's recurrence (bilstm_bwd_cluster.cuh): its dynamic
// shared memory a block, its blocks a cluster, and 0 if all its clusters
// can be resident at once on the current device, else a CUDA error (see
// bwd_cluster::check).
extern "C" int lstm_train_bwd_cluster_smem_bytes(int batch, int hidden) {
  return bwd_cluster::smem_bytes(batch, hidden);
}
extern "C" int lstm_train_bwd_cluster_size(int hidden) {
  return bwd_cluster::cluster_size(hidden);
}
extern "C" int lstm_train_bwd_cluster_check_bf16(int batch, int hidden) {
  return bwd_cluster::check(batch, hidden);
}

// How many clusters of `cluster` blocks of that launch the current device
// holds resident at once, or minus a CUDA error (tools/probe_bilstm.py).
extern "C" int lstm_train_bwd_cluster_occupancy(int batch, int hidden, int cluster) {
  int clusters = 0;
  const cudaError_t err = bwd_cluster::max_clusters(batch, hidden, cluster, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// Backward launch (1), the gate pass: gates = xg + h_prev W_hh^T into dg
// for every row with ts < length[b]; other rows of dg are left as they
// are. hidden is a multiple of 32. Returns cudaGetLastError().
extern "C" int lstm_train_bwd_gates_f32(const float* xg, const float* w_hh, const int* lengths,
                                        const float* h_prev, float* dg, int batch, int time,
                                        int hidden, void* stream) {
  return bwd_gates<float>(xg, w_hh, lengths, h_prev, dg, batch, time, hidden, stream);
}

// The bf16 variant's gate pass: xg and h_prev in bf16, the float32 gates
// into the float32 buffer gates [2, B, T, 4H], as lstm_train_bwd_gates_f32.
extern "C" int lstm_train_bwd_gates_bf16(const __nv_bfloat16* xg, const float* w_hh,
                                         const int* lengths, const __nv_bfloat16* h_prev,
                                         float* gates, int batch, int time, int hidden,
                                         void* stream) {
  return bwd_gates<__nv_bfloat16>(xg, w_hh, lengths, h_prev, gates, batch, time, hidden,
                                  stream);
}

// Backward launch (2), the recurrence: one cooperative launch of
// 2 * hidden / 8 blocks that overwrites dg (the gates of launch (1)) with
// dG at every row, zero past each length. Returns lstm_train_bwd_check's
// error without launching when the grid cannot be resident, else the
// launch's error.
extern "C" int lstm_train_bwd_recurrence_f32(const float* w_hh, const int* lengths,
                                             const float* c_prev, const float* dout, float* dg,
                                             int batch, int time, int hidden, void* stream) {
  return bwd_recurrence<float>(w_hh, lengths, c_prev, dout, dg, nullptr, nullptr, batch, time,
                               hidden, stream);
}

// The bf16 variant's recurrence (bilstm_bwd_cluster.cuh): order (the rows
// by descending length, int32), c_prev and dout in bf16, the float32 gates
// of lstm_train_bwd_gates_bf16 (read only), the float32 scratch xchg
// [2, 2, B, 4H] and the int32 flags ready [2 * hidden / 8] (any contents:
// the flags are zeroed on the stream first), and dG in bf16 into dg
// [2, B, T, 4H], zero past each length. Returns
// lstm_train_bwd_cluster_check_bf16's error without launching when the
// grid cannot be resident, else the memset's or the launch's error.
extern "C" int lstm_train_bwd_recurrence_bf16(const float* w_hh, const int* lengths,
                                              const int* order, const __nv_bfloat16* c_prev,
                                              const __nv_bfloat16* dout, const float* gates,
                                              float* xchg, int* ready, __nv_bfloat16* dg,
                                              int batch, int time, int hidden, void* stream) {
  return bwd_cluster::launch(w_hh, lengths, order, c_prev, dout, gates, xchg, ready, dg, batch,
                             time, hidden, stream);
}
