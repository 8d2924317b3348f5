// Kernels 1b and 2b, the bf16 forward recurrences of the biLSTM, for Hopper
// (sm_90a): one persistent cooperative launch a layer whose h @ W_hh^T
// runs on the tensor cores as a three-term bf16 split held to float32.
//
// Replaces the TPU kernels voice100_tpu/ops/lstm_pallas.py::_kernel (via
// _bilstm_pallas_call; its bf16 xg at lstm_pallas.py:140-146) and
// ::_kernel_train_fwd (via _lstm_train_fwd_pair; bf16 states at :259-264,
// :380) in their bf16 mode. Included by bilstm.cu (bilstm_bf16, kernel 1b)
// and bilstm_train.cu (lstm_train_fwd_bf16, kernel 2b: SAVE_STATES). Both
// directions in natural (source) time: loop step s touches ts = s for the
// forward direction and T-1-s for the backward one. Each step, for each
// row b and direction d:
//
//     gates = widen(xg[d, b, ts]) + h @ W_hh[d]^T      (gate order i, f, g, o)
//     c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//     v = ts < length[b]:  (h, c) = v ? (h', c') : (h, c),  out[b, ts, dH + u] = v ? h' : 0
//     SAVE_STATES: h_prev[d, b, ts] = bf16(h), c_prev[d, b, ts] = bf16(c)  (entering the step)
//
// h, c, W_hh, the cell and out are float32; the cell uses accurate
// expf/tanhf, as the JAX kernels run float32 at Precision.HIGHEST. The
// saved states round to nearest even.
//
// What bounded the old design (bilstm_persistent.cuh, instantiated on a
// bf16 xg): its product ran in float32 FMAs on the CUDA cores, 32 gate
// rows x H x the valid rows a block a step (2.1 M FMA at B = 128, H = 512:
// ~9 us at the SM's 128 FMA a cycle), with the warps splitting K, so
// every pass also reduced through shared memory behind two barriers.
// 2b's step at tts_en_base was 15.4 us (PERF.md).
//
// What this design does.
// * The product on tensor cores. mma.sync m16n8k16, bf16 operands,
//   float32 accumulation, as three terms: h = h_hi + h_lo and
//   W = W_hi + W_lo (each half bf16, round to nearest), and
//       gates += h_hi W_hi + (h_hi W_lo + h_lo W_hi),
//   the two small terms in accumulators of their own. What is dropped,
//   h_lo W_lo and the split residues, is at most 2^-16 of |h||w| a term
//   each, so the sum stays within float32's reach of the JAX product
//   (tests/test_torch_lstm_fwd_mma.py holds an emulation to 2^-15
//   sum |h||w| and to the Pallas kernels). One bf16 product would not.
// * Gate-major n tiles. Block (d, u0) owns the 32 gate rows i, f, g, o of
//   units u0..u0+7; n tile g is gate g of those 8 units, so the i, f, g
//   and o of one (row, unit) sit at the same place of a lane's four
//   accumulators.
// * A warp owns an m tile (16 length-sorted rows) and its whole K. Where
//   fewer tiles than warps have live rows, K splits over 2, 4 or 8 warps
//   (at least MIN_SPLIT_KT k tiles each), which shortens the chain of
//   mma a warp waits on. The warps store their sums in fragment order and
//   every thread then updates cells of the round (up to 8 tiles), one
//   (row, unit) at a time, adding the parts in order: on a few rows the
//   cells' accurate expf / tanhf spread over all 8 warps, not over the
//   tiles' owners (updating the cells in the owners' registers lost to
//   the float32 kernel at B = 32, H = 128). The cell loop is instantiated
//   for each split, so its sums unroll.
// * W_hh stays resident in shared memory, split once at the start into
//   hi and lo planes (32 x H x 2 bf16: 64 KB at H = 512, the bytes of the
//   float32 slice), stored in fragment order: a lane reads its B
//   fragments of a k tile as four 16-byte words, free of bank conflicts.
// * The exchange carries the split. The thread that updates a cell splits
//   its new h once and writes hi and lo, already in the A-fragment order
//   of the readers' mma, to xchg [2, 2, M tiles, H / 16, 32 lanes, hi | lo]
//   (16 bytes of hi and 16 of lo a lane a tile: the bytes of float32
//   [2, 2, 16 M, H]). The readers load their A fragments straight from L2
//   into registers (ld.global.cg, GROUP k tiles ahead of the mma), with no
//   shared-memory stage; the rows past the valid prefix are zeroed in
//   registers. 2b's saved h_prev is h_hi bit for bit.
// * Kept from the old design: rows in descending-length order, so the
//   valid rows are a prefix; only valid rows are computed and streamed;
//   one flag barrier a direction (the launch zeroes the flags first), with
//   a __trap on a wait of seconds; generic-proxy writes and .cg reads of
//   what the launch writes (never __ldg or the non-coherent L1); the next
//   step's xg into L2. A block releases its flag with __syncthreads and
//   one st.release.gpu (the barrier makes the block's writes the
//   releasing thread's, as CUTLASS's semaphore relies on; a __threadfence
//   before it only lengthened the step), and acquires its direction's
//   flags with ld.acquire.gpu before a __syncthreads. Ping-pong: step s
//   reads half s % 2 and writes the other, after the barrier of step s,
//   when every block of the direction has finished step s - 1 and its
//   reads of that half. Where a direction has no valid row it takes no
//   barrier and writes nothing.
//
// What bounds it now (tools/probe_bilstm.py forward_mma, tts_en_base, us
// a step of 8.58): the mma ~3.5 (three bf16 products at mma.sync's rate),
// the cell phase ~2.5 (accurate expf / tanhf, the stores), the L2 read of
// h ~1.4, the barrier ~1.2. The h stream is under a third of the step, so
// the blocks share no stream (3b's cluster multicast gained 2% there).
//
// Shared memory a block: W_hh's fragments (128 H bytes), the warps'
// sums (16 KB), and the (c, h) carry with the sorted lengths and rows
// (72 B a row): 91,136 B at B = 128, H = 512, so B <= 2090 at H = 512
// (ops/lstm_cuda.py fwd_mma_plan mirrors it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "bilstm_persistent.cuh"

namespace {
namespace fwd_mma {

constexpr int UNITS = 8;           // hidden units per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_M = 16;         // batch rows an m tile
constexpr int TILE_K = 16;         // columns of h a k tile
constexpr int GROUP = 4;           // k tiles a warp loads ahead of its mma
constexpr int MIN_SPLIT_KT = 2;    // k tiles a warp takes at least where K splits
constexpr int FRAG_WORDS = 4 * 32;      // uint4 of W's fragments a k tile
constexpr int EXCHANGE_WORDS = 2 * 32;  // uint4 of h (hi, lo) a tile
constexpr int CELL_BYTES = 2 * UNITS * 4 + 2 * 4;  // a row's (c, h), length, position
constexpr int CELLS = TILE_M * WARPS * UNITS / THREADS;  // cells of a round a thread updates

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// v = hi + lo + residue, each half bf16 rounded to nearest even
__device__ __forceinline__ void split(float v, unsigned short& hi, unsigned short& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(h)));
}

__device__ __forceinline__ unsigned pack(unsigned short first, unsigned short second) {
  return static_cast<unsigned>(first) | static_cast<unsigned>(second) << 16;
}

// This warp's share of one m tile: k tiles kt0..kt1-1 of
//     acc += h_hi W_hi,  cor += h_hi W_lo + h_lo W_hi
// for the gate-major n tiles 0..3. src is the tile's first k tile at this
// lane's slot; live0 / live1 say whether the lane's rows (g, g + 8 of the
// tile) hold h, else their A fragments are zero.
__device__ __forceinline__ void product(const uint4* src, const uint4* wf, int lane, int kt0,
                                        int kt1, bool live0, bool live1, float (&acc)[4][4],
                                        float (&cor)[4][4]) {
  uint4 cur[GROUP][2], nxt[GROUP][2];
  auto load = [&](int k0, uint4 (&a)[GROUP][2]) {
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      if (k0 + i < kt1) {
        a[i][0] = __ldcg(src + (k0 + i) * EXCHANGE_WORDS);
        a[i][1] = __ldcg(src + (k0 + i) * EXCHANGE_WORDS + 1);
      }
    }
  };
  load(kt0, cur);
  for (int k0 = kt0; k0 < kt1; k0 += GROUP) {
    if (k0 + GROUP < kt1) load(k0 + GROUP, nxt);
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      if (k0 + i >= kt1) break;
      uint4 hi = cur[i][0], lo = cur[i][1];
      // registers x, z hold row g; y, w row g + 8
      if (!live0) hi.x = hi.z = lo.x = lo.z = 0u;
      if (!live1) hi.y = hi.w = lo.y = lo.w = 0u;
      const uint4* w = wf + (k0 + i) * FRAG_WORDS + lane;
      const uint4 h01 = w[0], h23 = w[32], l01 = w[64], l23 = w[96];
      mma_bf16(acc[0], hi, h01.x, h01.y);
      mma_bf16(acc[1], hi, h01.z, h01.w);
      mma_bf16(acc[2], hi, h23.x, h23.y);
      mma_bf16(acc[3], hi, h23.z, h23.w);
      mma_bf16(cor[0], hi, l01.x, l01.y);
      mma_bf16(cor[1], hi, l01.z, l01.w);
      mma_bf16(cor[2], hi, l23.x, l23.y);
      mma_bf16(cor[3], hi, l23.z, l23.w);
      mma_bf16(cor[0], lo, h01.x, h01.y);
      mma_bf16(cor[1], lo, h01.z, h01.w);
      mma_bf16(cor[2], lo, h23.x, h23.y);
      mma_bf16(cor[3], lo, h23.z, h23.w);
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      cur[i][0] = nxt[i][0];
      cur[i][1] = nxt[i][1];
    }
  }
}

template <bool SAVE_STATES>
__global__ void __launch_bounds__(THREADS, 1)
bilstm_fwd_mma_kernel(const __nv_bfloat16* __restrict__ xg,  // [2, B, T, 4H]
                      const float* __restrict__ w_hh,        // [2, 4H, H]
                      const int* __restrict__ lengths,       // [B]
                      const int* __restrict__ order,         // [B]: rows by descending length
                      uint4* xchg,  // [2, 2, M tiles, H / 16, 32, 2]: h (hi, lo) in A-fragment
                                    // order by sorted row; written here, read through .cg only
                      int* ready,   // [2 * H / UNITS]: steps each block has finished (zeroed)
                      float* __restrict__ out,               // [B, T, 2H]
                      __nv_bfloat16* __restrict__ h_prev,    // [2, B, T, H] (SAVE_STATES)
                      __nv_bfloat16* __restrict__ c_prev,    // [2, B, T, H] (SAVE_STATES)
                      int batch, int time, int hidden) {
  extern __shared__ __align__(16) uint4 smem4[];
  const int k_tiles = hidden / TILE_K;
  const int m_tiles = (batch + TILE_M - 1) / TILE_M;
  uint4* wf = smem4;                              // [H / 16, 4, 32]: W's B fragments
  float4* red = reinterpret_cast<float4*>(wf + k_tiles * FRAG_WORDS);  // [WARPS, 4, 32]
  float* c_s = reinterpret_cast<float*>(red + WARPS * 4 * 32);        // [B, UNITS] sorted
  float* h_s = c_s + batch * UNITS;               // [B, UNITS] (SAVE_STATES)
  int* len_s = reinterpret_cast<int*>(h_s + batch * UNITS);  // [B]: lengths, sorted
  int* row_s = len_s + batch;                     // [B]: the batch row at each position
  const int groups = hidden / UNITS;
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x % groups) * UNITS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;          // the lane's rows gq, gq + 8 of a tile
  const int gates4 = 4 * hidden;
  const size_t half_words = static_cast<size_t>(m_tiles) * k_tiles * EXCHANGE_WORDS;
  // the block's units are columns 0..7 or 8..15 of k tile u0 / 16: A
  // registers 0, 1 (rows g, g + 8) or 2, 3 of each lane's 16 bytes
  const int word0 = (u0 & 8) ? 2 : 0;

  // W's fragments: k tile kt, word q (hi n tiles 0-1, hi 2-3, lo 0-1, lo
  // 2-3), lane l, register r: n tile nt = 2 (q % 2) + r / 2 (gate nt of
  // unit u0 + l / 4), k = 16 kt + 8 (r % 2) + 2 (l % 4) and k + 1
  for (int i = tid; i < k_tiles * FRAG_WORDS * 4; i += THREADS) {
    const int r = i & 3;
    const int l = (i >> 2) & 31;
    const int q = (i >> 7) & 3;
    const int kt = i >> 9;
    const int nt = ((q & 1) << 1) | (r >> 1);
    const int k = kt * TILE_K + (r & 1) * 8 + 2 * (l & 3);
    const float* src = w_hh + (static_cast<size_t>(d) * gates4 + nt * hidden + u0 + (l >> 2))
                       * hidden + k;
    unsigned short h0, l0, h1, l1;
    split(__ldg(src), h0, l0);
    split(__ldg(src + 1), h1, l1);
    reinterpret_cast<unsigned*>(wf)[i] = q < 2 ? pack(h0, h1) : pack(l0, l1);
  }
  for (int i = tid; i < batch * UNITS; i += THREADS) c_s[i] = h_s[i] = 0.f;
  for (int r = tid; r < batch; r += THREADS) {
    row_s[r] = __ldg(order + r);
    len_s[r] = __ldg(lengths + row_s[r]);
  }
  __syncthreads();

  int n_prev = 0;  // rows valid at the step before: their h is in the exchange
  for (int s = 0; s < time; ++s) {
    const int ts = source_time(d, s, time);
    int n = 0;  // rows valid at this step: a prefix of the sorted order
    for (int r0 = 0; r0 < batch; r0 += THREADS)
      n += __syncthreads_count(r0 + tid < batch && len_s[r0 + tid] > ts);
    // forward: n <= n_prev (0 at s = 0); backward: the rows from n_prev on
    // start this step from h = 0
    const int n_live = min(n, n_prev);
    const int n_tiles = (n + TILE_M - 1) / TILE_M;       // tiles with a cell to update
    const int p_tiles = (n_live + TILE_M - 1) / TILE_M;  // tiles with a product

    // the next step's xg slices of the block's gate columns, into L2
    if (s + 1 < time) {
      const int tn = source_time(d, s + 1, time);
      for (int r = tid; r < batch; r += THREADS) {
        if (len_s[r] <= tn) continue;
        const __nv_bfloat16* x =
            xg + ((static_cast<size_t>(d) * batch + row_s[r]) * time + tn) * gates4 + u0;
#pragma unroll
        for (int g = 0; g < 4; ++g) prefetch_l2(x + g * hidden);
      }
    }

    const uint4* h_src = xchg + (static_cast<size_t>(s & 1) * 2 + d) * half_words;
    uint4* h_dst = xchg + (static_cast<size_t>((s & 1) ^ 1) * 2 + d) * half_words;
    // the gate inputs of this thread's cells of a round from tile r0 (cell
    // p = tid + k THREADS: row r0 16 + p / UNITS, unit p % UNITS), loaded
    // ahead of the product that they wait for
    float xv[CELLS][4];
    auto load_xg = [&](int r0) {
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int p = tid + k * THREADS;
        const int pos = r0 * TILE_M + p / UNITS;
        if (pos >= n) continue;
        const __nv_bfloat16* x = xg + ((static_cast<size_t>(d) * batch + row_s[pos]) * time
                                       + ts) * gates4 + u0 + p % UNITS;
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[k][g] = ldg_f32(x + g * hidden);
      }
    };

    if (n_tiles > 0) load_xg(0);
    if (n > 0 && s > 0) {  // the barrier of this direction: every block's h of step s - 1
      if (tid < groups) {
        // a wait of seconds is a fault, not a slow step: end the launch with an error
        for (int spins = 0; ld_acquire(ready + d * groups + tid) < s; ++spins)
          if (spins > (1 << 22)) __trap();
      }
      __syncthreads();
    }

    // rounds of up to WARPS tiles: the warps' products into red, then every
    // thread's cells of the round. Where fewer tiles than warps have a
    // product, K of each splits over split = 2, 4 or 8 warps (tile
    // w / split, part w % split)
    int r0 = 0, live = 0;
    // the cells of the round, from the sums of SPLIT parts a tile (a
    // constant of each instance, so that the loops unroll)
    auto update_cells = [&](auto split_c) {
      constexpr int SPLIT = decltype(split_c)::value;
      const float* sums = reinterpret_cast<const float*>(red);
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int p = tid + k * THREADS;
        const int pos = r0 * TILE_M + p / UNITS;
        if (pos >= n) continue;
        const int j = p % UNITS;
        const int t = p / (UNITS * TILE_M);          // the tile of the round
        const int rr = (p / UNITS) % TILE_M;         // the row of the tile
        const int l = (rr & 7) * 4 + (j >> 1);       // the lane and register of (rr, j)
        const int c = (rr >> 3) * 2 + (j & 1);       // in the C and A fragments
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < live) {
#pragma unroll
          for (int part = 0; part < SPLIT; ++part) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              sum[g] += sums[(((t * SPLIT + part) * 4 + g) * 32 + l) * 4 + c];
          }
        }
        const int b = row_s[pos];
        const int u = u0 + j;
        const float gi = sigmoid(xv[k][0] + sum[0]);
        const float gf = sigmoid(xv[k][1] + sum[1]);
        const float gg = tanhf(xv[k][2] + sum[2]);
        const float go = sigmoid(xv[k][3] + sum[3]);
        const float c_in = c_s[pos * UNITS + j];
        const float cn = gf * c_in + gi * gg;
        const float h = go * tanhf(cn);
        if constexpr (SAVE_STATES) {
          const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;  // [2, B, T]
          store_f32(h_prev + row * hidden + u, h_s[pos * UNITS + j]);
          store_f32(c_prev + row * hidden + u, c_in);
          h_s[pos * UNITS + j] = h;
        }
        c_s[pos * UNITS + j] = cn;
        out[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u] = h;
        // h split into the other half of the exchange: lane l's 16 bytes of hi
        // then 16 of lo of tile (pos / 16, u0 / 16), register word0 + rr / 8
        unsigned short hi, lo;
        split(h, hi, lo);
        unsigned short* slot = reinterpret_cast<unsigned short*>(
            h_dst + (static_cast<size_t>(pos / TILE_M) * k_tiles + u0 / TILE_K) * EXCHANGE_WORDS
            + 2 * l) + 2 * word0 + c;
        __stcg(slot, hi);
        __stcg(slot + 8, lo);
      }
    };
    for (; r0 < n_tiles; r0 += WARPS) {
      if (r0 > 0) {
        __syncthreads();  // red is free for this round
        load_xg(r0);
      }
      live = max(0, min(min(WARPS, n_tiles - r0), p_tiles - r0));  // tiles with a product
      int log_split = 0;
      while (live > 0 && live << (log_split + 1) <= WARPS && k_tiles % (2 << log_split) == 0
             && k_tiles >> (log_split + 1) >= MIN_SPLIT_KT)
        ++log_split;
      const int tile = warp >> log_split;
      if (tile < live) {
        const int kts = k_tiles >> log_split;
        const int kt0 = (warp & ((1 << log_split) - 1)) * kts;
        const int row0 = (r0 + tile) * TILE_M + gq;
        float acc[4][4] = {}, cor[4][4] = {};
        product(h_src + static_cast<size_t>(r0 + tile) * k_tiles * EXCHANGE_WORDS + 2 * lane, wf,
                lane, kt0, kt0 + kts, row0 < n_live, row0 + 8 < n_live, acc, cor);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          red[(warp * 4 + g) * 32 + lane] = make_float4(
              acc[g][0] + cor[g][0], acc[g][1] + cor[g][1], acc[g][2] + cor[g][2],
              acc[g][3] + cor[g][3]);
      }
      __syncthreads();  // the sums are in place
      switch (log_split) {
        case 0: update_cells(std::integral_constant<int, 1>()); break;
        case 1: update_cells(std::integral_constant<int, 2>()); break;
        case 2: update_cells(std::integral_constant<int, 4>()); break;
        default: update_cells(std::integral_constant<int, 8>()); break;
      }
    }

    // frozen rows: the state passes through, out is 0
    for (int p = tid; p < (batch - n) * UNITS; p += THREADS) {
      const int pos = n + p / UNITS;
      const int j = p % UNITS;
      const int b = row_s[pos];
      const int u = u0 + j;
      const size_t row = (static_cast<size_t>(d) * batch + b) * time + ts;
      if constexpr (SAVE_STATES) {
        store_f32(h_prev + row * hidden + u, h_s[pos * UNITS + j]);
        store_f32(c_prev + row * hidden + u, c_s[pos * UNITS + j]);
      }
      out[(static_cast<size_t>(b) * time + ts) * 2 * hidden + d * hidden + u] = 0.f;
    }
    n_prev = n;
    __syncthreads();  // the block's h of this step is written, its sums read
    if (tid == 0) st_release(ready + blockIdx.x, s + 1);
  }
}

// Dynamic shared memory of one block (see the header).
inline int smem_bytes(int batch, int hidden) {
  return static_cast<int>((hidden / TILE_K) * FRAG_WORDS * sizeof(uint4)
                          + WARPS * 4 * 32 * sizeof(float4)
                          + static_cast<size_t>(batch) * CELL_BYTES);
}

// 0 if the launch can run with all 2 * hidden / UNITS blocks resident on
// the current device; else cudaErrorInvalidValue (hidden not a multiple of
// 32), cudaErrorNotSupported (no cooperative launch), an error of setting
// the shared-memory limit (above the opt-in), or
// cudaErrorCooperativeLaunchTooLarge (too few SMs for the grid).
template <bool SAVE_STATES>
int check(int batch, int hidden) {
  if (hidden <= 0 || hidden % 32 || batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = smem_bytes(batch, hidden);
  err = cudaFuncSetAttribute(bilstm_fwd_mma_kernel<SAVE_STATES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bilstm_fwd_mma_kernel<SAVE_STATES>,
                                                      THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm * sms < 2 * hidden / UNITS)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

// One launch for the whole layer: the flags zeroed on the stream, then the
// kernel as a cooperative launch. check's error without launching when the
// grid cannot be resident, else the memset's or the launch's error.
template <bool SAVE_STATES>
int launch(const __nv_bfloat16* xg, const float* w_hh, const int* lengths, const int* order,
           void* exchange, int* ready, float* out, __nv_bfloat16* h_prev,
           __nv_bfloat16* c_prev, int batch, int time, int hidden, void* stream) {
  const int status = check<SAVE_STATES>(batch, hidden);
  if (status != 0) return status;
  cudaError_t err = cudaMemsetAsync(ready, 0, 2 * (hidden / UNITS) * sizeof(int),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  uint4* xchg = static_cast<uint4*>(exchange);
  void* args[] = {&xg, &w_hh, &lengths, &order, &xchg, &ready, &out, &h_prev, &c_prev,
                  &batch, &time, &hidden};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bilstm_fwd_mma_kernel<SAVE_STATES>), dim3(2 * hidden / UNITS),
      dim3(THREADS), args, smem_bytes(batch, hidden), static_cast<cudaStream_t>(stream)));
}

}  // namespace fwd_mma
}  // namespace
