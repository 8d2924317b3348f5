// Kernel 3b's reverse recurrence, the bf16 training adjoint, for Hopper
// (sm_90a): thread-block clusters share each step's float32 dG.
//
// Replaces the recurrence of the TPU kernel
// voice100_tpu/ops/lstm_pallas.py::_kernel_train_bwd in its bf16 mode
// (lstm_pallas.py:281-319, the dG dtype at :437; via _lstm_train_bwd_pair).
// It reads the float32 gates of the gate pass (lstm_train_bwd_gates_bf16
// in bilstm_train.cu) and the bf16 c_prev and dout, each widened to
// float32 as it is loaded; forms dh from the float32 dG, as JAX forms it
// from its float32 da (lstm_pallas.py:313-319); and writes dG in bf16
// (round to nearest even), zero past each length. Walking s from T-1 down
// to 0, for each unit of a valid row (ts < length[b]):
//     dh~ = dh + dout,  dc~ = dh~ sig(o) (1 - tanh^2 c') + dc
//     dG  = (dc~ g i(1-i), dc~ c f(1-f), dc~ i (1-g^2), dh~ tanh(c') o(1-o))
//     dc  = dc~ f,  dh = dG[d, :, ts] @ W_hh[d]
// and a frozen row's dG is 0 while its (dh, dc) pass through.
//
// Same arithmetic as the float32 recurrence of bilstm_train.cu
// (lstm_train_bwd_recurrence_kernel<float>), in the same order: the
// cell formulas, accurate expf/tanhf, float32 fmaf; the dh product's k chunks
// of 32 gate rows dealt to the 8 warps in turn (chunk c to warp c % 8),
// each chunk's kq in order, and the warps' partial sums added in warp
// order. Only where the operands come from changes. So this kernel's dG
// equals, bit for bit, the bf16 rounding of what the float32 recurrence
// computes from the same float32 gates with c_prev and dout widened
// (chip_smoke.py checks it at every bf16 shape).
//
// What bounds the old design on the H100: each step every block of a
// direction read the step's whole float32 dG[d] (B x 4H floats, 1 MB at
// B = 128, H = 512) from L2 through per-warp cp.async double buffers, over
// all B rows in passes of 64, and a grid sync joined both directions.
//
// What this design does.
// * Clusters share the dG stream. The H / 8 blocks of a direction form
//   clusters of C (cluster_size: 8 up to 120 blocks, 4 where H / 8 is not
//   a multiple of 8, else 2, as many as the H100 holds resident; C = 2 at
//   H = 512). The dh product walks a pass of up to 64 rows chunk by chunk;
//   chunk c of a pass goes to warp c % 8 of every block, and the cluster's
//   block (c % 8) % C fetches it from L2 once, lane c % 8 of its producer
//   warp issuing a bulk copy multicast to the C blocks (cp.async.bulk ...
//   .multicast::cluster) that completes on a "full" mbarrier in each. Each
//   warp has a ring of 4 slots of 32 rows: a round of up to 32 rows takes
//   one, a round of 64 two adjacent ones (one copy). Warp w's slot is
//   refilled only after warp w of every block of the cluster has released
//   it (a remote arrive on the fetching block's "empty" mbarrier; at block
//   scope: a cluster-scope release each round cost ~25% of the step). L2
//   reads of dG fall by C.
// * Only the valid rows stream. The rows pass in descending-length order
//   (the wrapper's length_order, as the forward takes them), so the rows
//   valid at a step are a prefix of n rows; the dG phase, the exchange
//   and the product cover that prefix only. A row's sums do not depend on
//   its position, so bit-equality holds.
// * A barrier for each direction. After its dG phase a block releases its
//   flag (ready[block] = steps done); before the product it acquires the
//   flags of its own direction's blocks, as in bilstm_persistent.cuh, with
//   a __trap on a wait of seconds (and on an mbarrier wait of 2 s). No grid
//   sync: the launch memsets the flags before the kernel, and the
//   directions run at their own pace.
// * dG is written with generic stores and read by bulk copies through the
//   async proxy: every writer fences (fence.proxy.async.global) before its
//   block releases its flag, and every fetching lane fences again after
//   the flags are acquired, before its first copy of the step.
// * The product's lanes hold 4 rows x 4 units each (16 FMAs for 8 values
//   loaded from shared memory), and the dG phase issues the loads of 4
//   cells a thread before computing any of them.
//
// What bounds it now (tools/probe_bilstm.py, PERF.md): the product's
// shared-memory loads (~1 us a round of 64 rows at H = 512: 128 B a cycle
// fill 8 values a lane for 16 FMAs), then the barrier and the dG phase,
// ~5 us a step at H = 512.
//
// The exchange xchg [2, 2, 4H / 32, B, 32] (float32: ping-pong, direction,
// chunk, sorted row, column) holds step s's dG in half s % 2. A chunk's
// rows are contiguous, so one copy moves a pass's chunk. The eight float4
// groups of a row are stored XOR-swizzled by the row (group g at
// g ^ (row % 8)), so the product's float4 reads of 16 rows are free of
// bank conflicts without padding.
// Ping-pong safety under the flag barrier: block X writes half p at step
// s only after acquiring every flag of its direction at step s + 1 (the
// barrier of s + 1, taken whenever that step had a valid row), and a block
// releases its step s + 1 flag only after its product of step s + 2 is
// done; every copy of that product lands in every block of the cluster and
// each block waits for all of them, so every read of half p at step s + 2
// has completed before X writes it at step s. Where step s + 1 had no
// valid row, neither had s + 2 (forward direction: rows only join as s
// falls) or X writes nothing at s (backward direction: rows only leave).
//
// Shared memory a block: the slots (8 warps x 4 x 32 x 32 floats, 128 KB),
// W_hh[d][:, u0:u0+8] (4H x 8 floats, 64 KB at H = 512), the warps' sums of
// half a pass (8 KB), the mbarriers, and the (dh, dc) carry with the
// sorted lengths and rows (72 B a row): 214,528 B at B = 128, H = 512, so
// B <= 376 at H = 512 (ops/lstm_cuda.py bwd_cluster_plan mirrors it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bilstm_persistent.cuh"

namespace {
namespace bwd_cluster {

constexpr int UNITS = 8;           // hidden units per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PASS = 64;           // batch rows per pass of the dh product
constexpr int Q = 32;              // gate rows of dG per chunk, dealt to the warps in turn
constexpr int SLOTS = 4;           // ring depth of each warp's slots
constexpr int SLOT_ROWS = PASS / 2;  // a slot holds a chunk of 32 rows, two adjacent ones 64
constexpr int SLOT_FLOATS = SLOT_ROWS * Q;
constexpr int RED_ROWS = PASS / 2; // the warps' sums are added half a pass at a time
constexpr int BLOCK_THREADS = THREADS + 32;  // the consumer warps and one producer warp
constexpr int CELLS = 4;           // cells of the dG phase whose loads a thread issues together

// Blocks a cluster: a direction's hidden / UNITS blocks in whole clusters,
// as many as the H100 holds resident at one block an SM (cudaOccupancy-
// MaxActiveClusters: 15 clusters of 8, 30 of 4, 66 of 2), so 8 up to 120
// blocks, else 2.
__host__ __device__ inline int cluster_size(int hidden) {
  const int per_direction = hidden / UNITS;
  return per_direction <= 60 ? (per_direction % 8 == 0 ? 8 : 4) : 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The consumer warps' own barrier (the producer runs ahead of them).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// This thread's arrival on a local barrier, expecting `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// An arrival on the barrier at the same offset in the cluster's block
// `rank`, releasing at block scope: it tells the fetching block that this
// warp has read its slot (the values are in registers and used).
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* bar, unsigned rank) {
  asm volatile("{\n.reg .b32 remote;\n"
               "mapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
               :: "r"(smem_u32(bar)), "r"(rank) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`,
// acquiring at cluster scope for a barrier that peers arrive on (CLUSTER)
// or at block scope for one that only copies complete; a wait of seconds
// is a fault, not a slow step: end the launch with an error.
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned long long start = 0;
  for (;;) {
    unsigned done;
    if constexpr (CLUSTER) {
      asm volatile("{\n.reg .pred p;\n"
                   "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } else {
      asm volatile("{\n.reg .pred p;\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
    if (done) return;
    const unsigned long long now = global_ns();
    if (start == 0) start = now;
    else if (now - start > 2000000000ull) __trap();
  }
}

// `bytes` from device memory into the same shared-memory offset `dst` of
// every block of the cluster, each completing on its barrier at `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar, unsigned blocks) {
  const unsigned long long g = static_cast<unsigned long long>(__cvta_generic_to_global(src));
  if (blocks == 1) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(g), "r"(bytes), "r"(smem_u32(bar)) : "memory");
  } else {
    const unsigned short mask = static_cast<unsigned short>((1u << blocks) - 1);
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
                 :: "r"(smem_u32(dst)), "l"(g), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
                 : "memory");
  }
}

// One warp's share of one chunk. Lane rg + 16 uh (rg < 16) takes the
// pass's rows rg + 16 i (i < R) and the units 4 uh .. 4 uh + 3, and adds to
// acc[i][j] the sum over the chunk's 32 gate rows of dG x W_hh, kq in
// order, as lstm_train_bwd_recurrence_kernel sums each output (which lane
// computes an output does not change its sum). Four rows by four units a
// lane load 8 values from shared memory for 16 FMAs, where two rows by
// eight units load 10: the loads, not the FMAs, bound this loop.
template <int R>
__device__ __forceinline__ void chunk_product(const float* x, const float* w, int lane,
                                              float (&acc)[4][4]) {
  const int rg = lane & 15;
  const int uh = lane >> 4;
#pragma unroll 2
  for (int kq = 0; kq < Q; kq += 4) {
    const int col = ((kq >> 2) ^ (rg & 7)) << 2;  // the rows' swizzled float4 group
    float xv[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(x + (rg + 16 * i) * Q + col);
      xv[i][0] = v.x, xv[i][1] = v.y, xv[i][2] = v.z, xv[i][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(w + (kq + c) * UNITS + 4 * uh);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i][c], wa[j], acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
lstm_train_bwd_cluster_kernel(
    const float* __restrict__ w_hh,            // [2, 4H, H]
    const int* __restrict__ lengths,           // [B]
    const int* __restrict__ order,             // [B]: rows by descending length
    const __nv_bfloat16* __restrict__ c_prev,  // [2, B, T, H]
    const __nv_bfloat16* __restrict__ dout,    // [B, T, 2H]
    const float* __restrict__ gates,           // [2, B, T, 4H]: the gate pass's
    float* xchg,  // [2, 2, 4H / Q, B, Q]: float32 dG by sorted row, written here
    int* ready,   // [2 * H / UNITS]: steps each block has finished (zeroed)
    __nv_bfloat16* __restrict__ dg,            // [2, B, T, 4H]
    int batch, int time, int hidden) {
  extern __shared__ __align__(128) float smem[];
  float* slots = smem;                                  // [WARPS, SLOTS, 32, Q], swizzled
  float* wcol = slots + WARPS * SLOTS * SLOT_FLOATS;    // [4H, UNITS]: W_hh[d][:, u0:u0+8]
  float* red = wcol + 4 * hidden * UNITS;               // [WARPS, RED_ROWS, UNITS]
  unsigned long long* full =                            // [SLOTS, WARPS]: a slot's copy landed
      reinterpret_cast<unsigned long long*>(red + WARPS * RED_ROWS * UNITS);
  unsigned long long* empty = full + SLOTS * WARPS;     // [SLOTS, WARPS]: the cluster is done
  float* dh_s = reinterpret_cast<float*>(empty + SLOTS * WARPS);  // [B, UNITS] by sorted row
  float* dc_s = dh_s + batch * UNITS;                   // [B, UNITS]
  int* len_s = reinterpret_cast<int*>(dc_s + batch * UNITS);      // [B]: lengths, sorted
  int* row_s = len_s + batch;                           // [B]: the batch row of each position
  const int groups = hidden / UNITS;
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x % groups) * UNITS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;   // WARPS consumer warps, then the producer
  const int gates4 = 4 * hidden;
  const int chunks = gates4 / Q;
  const unsigned rank = cluster_rank();
  const unsigned blocks = cluster_blocks();
  // chunks of a pass that warp w takes (w, w + WARPS, ...), and the block
  // of the cluster that fetches them
  auto rounds_of = [&](int w) { return (chunks - w + WARPS - 1) / WARPS; };
  const unsigned fetcher = warp % blocks;
  // a round of warp w takes one chunk of a pass: up to 32 rows in slot
  // q % SLOTS of its ring, more in the two slots from the next even q (one
  // copy); the fetching lane and the warp walk the ring alike, each with
  // the parity of the uses of each slot's barriers so far (bit s)
  int ring = 0;
  unsigned parity = 0, used = 0;
  auto next_slot = [&](int rows) {
    if (rows > SLOT_ROWS) ring += ring & 1;
    const int slot = ring % SLOTS;
    ring += rows > SLOT_ROWS ? 2 : 1;
    return slot;
  };

  for (int i = tid; i < gates4 * 2; i += BLOCK_THREADS) {
    const float4* src = reinterpret_cast<const float4*>(
        w_hh + (static_cast<size_t>(d) * gates4 + i / 2) * hidden + u0) + i % 2;
    reinterpret_cast<float4*>(wcol)[i] = __ldg(src);
  }
  for (int i = tid; i < batch * UNITS; i += BLOCK_THREADS) dh_s[i] = dc_s[i] = 0.f;
  for (int r = tid; r < batch; r += BLOCK_THREADS) {
    row_s[r] = __ldg(order + r);
    len_s[r] = __ldg(lengths + row_s[r]);
  }
  if (tid == 0) {
    for (int i = 0; i < SLOTS * WARPS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, blocks);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers exist before a peer copies or arrives

  for (int s = time - 1; s >= 0; --s) {
    const int ts = source_time(d, s, time);
    int n = 0;  // rows valid at this step: a prefix of the sorted order
    for (int r0 = 0; r0 < batch; r0 += THREADS)
      n += __syncthreads_count(tid < THREADS && r0 + tid < batch && len_s[r0 + tid] > ts);
    float* ex = xchg + (static_cast<size_t>(s & 1) * 2 + d) * gates4 * batch;

    if (warp < WARPS) {
      // dG of the block's units at the valid rows, as the float32 recurrence;
      // the inputs of CELLS cells a thread are loaded before any is computed
      for (int p0 = tid; p0 < n * UNITS; p0 += CELLS * THREADS) {
        float gv[CELLS][4], cpv[CELLS], dov[CELLS];
#pragma unroll
        for (int i = 0; i < CELLS; ++i) {
          const int p = p0 + i * THREADS;
          if (p >= n * UNITS) break;
          const int b = row_s[p / UNITS];
          const int u = u0 + p % UNITS;
          const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;
#pragma unroll
          for (int j = 0; j < 4; ++j) gv[i][j] = __ldg(gates + row * gates4 + u + j * hidden);
          cpv[i] = ldg_f32(c_prev + row * hidden + u);
          dov[i] = ldg_f32(dout + (static_cast<size_t>(b) * time + ts) * 2 * hidden
                           + d * hidden + u);
        }
#pragma unroll
        for (int i = 0; i < CELLS; ++i) {
          const int p = p0 + i * THREADS;
          if (p >= n * UNITS) break;
          const int pos = p / UNITS;
          const int u = u0 + p % UNITS;
          const size_t row = (static_cast<size_t>(d) * batch + row_s[pos]) * time + ts;
          const float gi = sigmoid(gv[i][0]);
          const float gf = sigmoid(gv[i][1]);
          const float gg = tanhf(gv[i][2]);
          const float go = sigmoid(gv[i][3]);
          const float cp_u = cpv[i];
          const float tanh_c = tanhf(gf * cp_u + gi * gg);
          const float d_hcand = dh_s[p] + dov[i];
          const float d_ccand = d_hcand * go * (1.f - tanh_c * tanh_c) + dc_s[p];
          const float da[4] = {d_ccand * gg * gi * (1.f - gi), d_ccand * cp_u * gf * (1.f - gf),
                               d_ccand * gi * (1.f - gg * gg),
                               d_hcand * tanh_c * go * (1.f - go)};
          // gate row k H + u: chunk (k H + u) / Q, column u % Q, swizzled by the row
          const int col = ((((u % Q) >> 2) ^ pos) & 7) << 2 | (u & 3);
          float* e = ex + (static_cast<size_t>(u / Q) * batch + pos) * Q + col;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            __stcg(e + static_cast<size_t>(j) * (hidden / Q) * batch * Q, da[j]);
            store_f32(dg + row * gates4 + u + j * hidden, da[j]);
          }
          dc_s[p] = d_ccand * gf;
        }
      }
      // frozen rows: dG = 0, (dh, dc) pass through
      for (int p = tid; p < (batch - n) * UNITS; p += THREADS) {
        const int b = row_s[n + p / UNITS];
        const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_f32(dg + row * gates4 + u0 + p % UNITS + j * hidden, 0.f);
      }
      fence_proxy_async_global();  // this thread's dG stores before the peers' bulk reads
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      st_release(ready + blockIdx.x, time - s);
    }
    if (s == 0) break;  // dh after the last step is not needed

    if (n > 0) {  // the barrier of this direction: every block's dG at ts
      if (tid < groups) {
        for (int spins = 0; ld_acquire(ready + d * groups + tid) < time - s; ++spins)
          if (spins > (1 << 22)) __trap();
      }
      __syncthreads();
    }

    // dh[:, own units] = dG[d, :, ts] @ W_hh[d][:, u0:u0+8] for the valid rows
    const int streamed = n;  // rows the dh product streams
    const int passes = (streamed + PASS - 1) / PASS;
    if (warp == WARPS) {
      // the producer warp: lane w fetches consumer warp w's chunks of the
      // step where this block is their fetcher, in the order the warp takes
      // them, each into warp w's slot of every block of the cluster once
      // that slot is free in all of them
      const int w = lane;
      if (w < WARPS && w % blocks == rank && w < chunks && passes > 0) {
        fence_proxy_async_global();  // the acquired dG before this step's bulk reads
        const int rounds = rounds_of(w);
        for (int p = 0; p < passes; ++p) {
          const int rows = min(PASS, streamed - p * PASS);
          for (int r = 0; r < rounds; ++r) {
            const int slot = next_slot(rows);
            // the slots' last uses released by warp w of every block of the cluster
            for (int i = slot; i < slot + (rows > SLOT_ROWS ? 2 : 1); ++i)
              if (used >> i & 1) mbar_wait<true>(empty + i * WARPS + w, (parity >> i & 1) ^ 1);
            bulk_copy(slots + (w * SLOTS + slot) * SLOT_FLOATS,
                      ex + (static_cast<size_t>(w + r * WARPS) * batch + p * PASS) * Q,
                      rows * Q * sizeof(float), full + slot * WARPS + w, blocks);
            parity ^= 1u << slot;
            used |= 1u << slot;
          }
        }
      }
    } else {
      // the next step's inputs of the valid rows, from device memory into
      // L2 while the dh product runs (own units: no other block writes them)
      const int tn = source_time(d, s - 1, time);
      for (int pos = tid; pos < batch; pos += THREADS) {
        if (len_s[pos] <= tn) continue;
        const int b = row_s[pos];
        const size_t row = (static_cast<size_t>(d) * batch + b) * time + tn;
#pragma unroll
        for (int j = 0; j < 4; ++j) prefetch_l2(gates + row * gates4 + j * hidden + u0);
        prefetch_l2(c_prev + row * hidden + u0);
        prefetch_l2(dout + (static_cast<size_t>(b) * time + tn) * 2 * hidden + d * hidden + u0);
      }
      const int rounds = rounds_of(warp);
      for (int p = 0; p < passes; ++p) {
        const int b0 = p * PASS;
        const int nb = min(PASS, streamed - b0);
        float acc[4][4];  // pass rows rg + 16 i, units 4 uh + j (see chunk_product)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        }
        for (int r = 0; r < rounds; ++r) {
          const int slot = next_slot(nb);
          if (lane == 0) mbar_expect_tx(full + slot * WARPS + warp, nb * Q * sizeof(float));
          mbar_wait<false>(full + slot * WARPS + warp, parity >> slot & 1);
          parity ^= 1u << slot;
          const float* x = slots + (warp * SLOTS + slot) * SLOT_FLOATS;
          const float* w = wcol + (warp + r * WARPS) * Q * UNITS;
          if (nb > 32) chunk_product<4>(x, w, lane, acc);
          else chunk_product<2>(x, w, lane, acc);
          __syncwarp();  // the warp is done with the slot: the cluster may refill it
          if (lane == 0) mbar_arrive_remote(empty + slot * WARPS + warp, fetcher);
        }
        // the warps' sums in warp order, half a pass at a time (rows
        // rg + 16 i with i = 2 h, 2 h + 1)
        for (int h = 0; h * RED_ROWS < nb; ++h) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              red[(warp * RED_ROWS + (lane & 15) + 16 * i) * UNITS + 4 * (lane >> 4) + j] =
                  h == 0 ? acc[i][j] : acc[2 + i][j];
          }
          consumers_sync();
          const int rows = min(RED_ROWS, nb - h * RED_ROWS);
          for (int q = tid; q < rows * UNITS; q += THREADS) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) sum += red[w * RED_ROWS * UNITS + q];
            dh_s[(b0 + h * RED_ROWS) * UNITS + q] = sum;
          }
          consumers_sync();
        }
      }
    }
  }
  cluster_sync();  // no block leaves while a peer may still arrive on its barriers
}

// Dynamic shared memory of one block (see the header).
inline int smem_bytes(int batch, int hidden) {
  return static_cast<int>(
      (WARPS * SLOTS * SLOT_FLOATS + 4 * hidden * UNITS + WARPS * RED_ROWS * UNITS)
          * sizeof(float)
      + 2 * SLOTS * WARPS * sizeof(unsigned long long)
      + 2 * batch * UNITS * sizeof(float) + 2 * batch * sizeof(int));
}

inline cudaLaunchConfig_t launch_config(int batch, int hidden, cudaLaunchAttribute* attrs,
                                        int n_attrs, void* stream) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster_size(hidden);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  if (n_attrs > 1) {
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * hidden / UNITS);
  config.blockDim = dim3(BLOCK_THREADS);
  config.dynamicSmemBytes = smem_bytes(batch, hidden);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attrs;
  config.numAttrs = n_attrs;
  return config;
}

// How many clusters of `cluster` blocks of the kernel at these shapes the
// current device holds resident at once (cudaOccupancyMaxActiveClusters).
inline cudaError_t max_clusters(int batch, int hidden, int cluster, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(lstm_train_bwd_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(batch, hidden));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(lstm_train_bwd_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[1];
  cudaLaunchConfig_t config = launch_config(batch, hidden, attrs, 1, nullptr);
  attrs[0].val.clusterDim.x = cluster;
  return cudaOccupancyMaxActiveClusters(clusters, lstm_train_bwd_cluster_kernel, &config);
}

// 0 if the launch can run with all its clusters resident at once on the
// current device; else cudaErrorInvalidValue (hidden not a multiple of 32),
// cudaErrorNotSupported (no cluster or cooperative launch), an error of
// setting the shared-memory limit (above the opt-in) or of the occupancy
// query, or cudaErrorCooperativeLaunchTooLarge (too few clusters fit).
inline int check(int batch, int hidden) {
  if (hidden <= 0 || hidden % 32 || batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters_ok = 0, coop = 0;
  cudaDeviceGetAttribute(&clusters_ok, cudaDevAttrClusterLaunch, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!clusters_ok || !coop) return static_cast<int>(cudaErrorNotSupported);
  int clusters = 0;
  err = max_clusters(batch, hidden, cluster_size(hidden), &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters * cluster_size(hidden) < 2 * hidden / UNITS)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

// One launch for the whole layer: the flags zeroed on the stream, then the
// kernel as a cooperative launch of clusters. check's error without
// launching when the grid cannot be resident, else the memset's or the
// launch's error.
inline int launch(const float* w_hh, const int* lengths, const int* order,
                  const __nv_bfloat16* c_prev, const __nv_bfloat16* dout, const float* gates,
                  float* xchg, int* ready, __nv_bfloat16* dg, int batch, int time, int hidden,
                  void* stream) {
  const int status = check(batch, hidden);
  if (status != 0) return status;
  cudaError_t err = cudaMemsetAsync(ready, 0, 2 * (hidden / UNITS) * sizeof(int),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t config = launch_config(batch, hidden, attrs, 2, stream);
  return static_cast<int>(cudaLaunchKernelEx(&config, lstm_train_bwd_cluster_kernel, w_hh,
                                             lengths, order, c_prev, dout, gates, xchg, ready,
                                             dg, batch, time, hidden));
}

}  // namespace bwd_cluster
}  // namespace
