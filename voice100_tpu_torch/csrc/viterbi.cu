// CTC Viterbi forced alignment for Hopper (sm_90a) in one launch: the
// max-semiring forward that records the move into every lattice state, the
// choice of the final state, and the backtrace.
//
// Replaces the TPU kernels voice100_tpu/ops/ctc_pallas.py::_vit_fwd_kernel
// (ctc_pallas.py:405) and ::_vit_bt_kernel (:440), and the choice of the
// final state between them, all three wrapped by ctc_viterbi_pallas
// (:464-565). Lattice of one sample: S = 2L + 1 states over the
// blank-interleaved labels z (blank 0); valid(s) comes with z (s < 2 *
// target_length + 1).
//
//     alpha[0](s) = (s < 2 and valid(s)) ? lp[b, 0, z_s] : NEG,  moves[0] = 0
//     t >= 1, t < input_length:
//         c0 = alpha[t-1](s), c1 = alpha[t-1](s-1), c2 = z_s != 0 ? alpha[t-1](s-2) : NEG
//         (NEG where s - k < 0); best, move = c0, 0; then c1, c2 replace it only
//         when strictly greater, so ties go to the smallest move
//         alpha[t](s) = valid(s) ? best + lp[b, t, z_s] : NEG,  moves[t](s) = move
//     t >= input_length: alpha[t] = alpha[t-1], moves[t] = 0
//     final = 2L if alpha(2L) > alpha(max(2L-1, 0)) else max(2L-1, 0); score = alpha(final)
//     from final at t = len - 1: pos_{t-1} = max(pos_t - moves[t](pos_t), 0);
//     path[t] = pos_t, labels[t] = z[pos_t], both 0 for t >= len
// The 2-move gate is "may not land on a blank" (the reference's max_move=3
// rule), not the loss's skip gate. NEG = -1e30, finite, as in the JAX
// kernels: in float32 -1e30 + lp == -1e30, so unreachable states tie
// exactly and the tie-break decides their moves. Compares, selects and one
// float32 add are exact, so this kernel and the plain PyTorch version
// (ops/ctc.py) agree bit for bit on any input.
//
// What bounds it on Hopper, and what the design does about it. A sample's
// lattice is a chain of T dependent steps; the bytes (the log_probs rows
// once, the moves and the path out) take ~2 us at B=64, T=512, S=321, so
// the time is the chain. A step is about a dozen compare, select and
// predicate instructions a state, which issue at half rate on the SM's
// schedulers, plus the exchange of the row's neighbours. Measured on an H100
// at S = 321 (tools/probe_ctc.py, event time of one launch over T): one warp
// a sample holding 11 states a lane took 0.39 us a step and a block a
// sample with a barrier a step (the previous design) 0.27; spreading the
// sample over the SM's four schedulers without a barrier a step takes
// 0.21, of which the chain of shuffles, polls and maxima is 0.12. So a
// sample takes a block of
// `warps` warps, four by default, and lane g holds the K states [g*K, g*K +
// K) of the row in registers. It gets alpha[t-1] at its first state - 1 and
// - 2 from lane g-1: inside a warp by two __shfl_up_sync; across warps from
// a tagged slot in shared memory: lane 31 of each warp publishes its last
// two states with a 16-byte store whose 8-byte halves each carry the step as
// a tag, and the next warp polls the slot until both tags match (an
// LL-protocol exchange). A warp never waits for the warp after it, so the
// warps run as a pipeline with a small lag. Each step loads the next step's
// slot as soon as its own poll is done, and computes the states that need
// nothing from the lane before ahead of the poll. Steps go in chunks of
// CH = 32, the chunk's loop unrolled with no branch a step (the sample's
// last, partial chunk takes a plain loop). Once a chunk, the sample's warps
// meet at a named barrier (bar.sync 1): it bounds a warp's lead to the two
// halves of its slots, and it hands over the emissions, which all the
// sample's threads copy one chunk ahead from the sample's contiguous
// log_probs rows into a double-buffered shared-memory ring with cp.async;
// each lane gathers its K emissions a step ahead. Where two chunks of rows
// do not fit shared memory (a vocabulary past ~830-880 classes), the launch
// stages nothing and each lane loads its K emissions a step ahead straight
// from device memory (the template's RING = false). Moves are packed 2 bits a
// state, bits [2i, 2i+2) of lane g's word holding state g*K + i; a chunk's
// 32 words of a lane stay in registers and leave as eight 16-byte stores,
// into packed [B, chunks, 32 * warps, 32], chunk c holding steps 1 + 32c
// to 32 + 32c. The last row goes through shared memory, where the final
// state and score are chosen. The backtrace walks back a chunk at a time:
// every thread loads its 32 words of the next chunk (in L2, just written)
// while the current chunk is walked and unpacks them to a byte a state in
// shared memory; warp 0 walks (a shared byte load, a subtract and a clamp a
// step) and lane j writes the position and label of the chunk's step j. No
// fast math.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int K_MIN = 2;                   // the neighbours come from one lane
constexpr int K_MAX = 16;                  // one 32-bit word of moves a lane
constexpr int MAX_WARPS = 6;                // ops/viterbi_cuda.py's most: MAX_STATES / (32 * K_MAX)
constexpr int MAX_STATES = 3072;           // the byte stage of 2 x 32 rows fits shared memory
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int CH = 32;                     // steps of a chunk: emissions, moves, backtrace
constexpr int SMEM_LIMIT = 232448;         // opt-in dynamic shared memory of a block
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_TAG = 0xffffffffu;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Bytes of shared memory of a block: the warps' exchange slots, z, then the
// emission ring (none where `ring` is false), which the last row and the
// backtrace's byte stage reuse after the forward.
__host__ __device__ inline int smem_bytes(int S, int vocab, int warps, bool ring) {
  const int rows = ring ? 4 * 2 * CH * vocab : 0;
  const int after = 4 * round4(S) + 2 * CH * round16(S);
  return 16 * warps * 2 * (CH + 1) + 4 * round4(S) + (rows > after ? rows : after);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The warps of the sample (the block) at a named barrier.
__device__ __forceinline__ void sample_sync(int warps) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(32 * warps) : "memory");
}

// An exchange slot: {lo, tag, hi, tag}, each 8-byte half with its own tag,
// so a reader that sees both tags sees both values. This takes each 8-byte
// half of a 16-byte volatile access to be single-copy atomic, which the PTX
// memory model does not promise for vector accesses (it models them as
// scalar accesses in an unspecified order); NCCL's LL protocol rests on the
// same property (its ncclLLFifoLine {data1, flag1, data2, flag2}, stored
// and polled with st/ld.volatile.v4.u32). chip_smoke.py holds every output
// of this kernel bit-equal to the plain versions.
__device__ __forceinline__ void put_slot(unsigned addr, float lo, float hi, unsigned tag) {
  asm volatile("st.volatile.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(__float_as_uint(lo)), "r"(tag), "r"(__float_as_uint(hi)),
                  "r"(tag));
}

__device__ __forceinline__ uint4 get_slot(unsigned addr) {
  uint4 x;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w) : "r"(addr));
  return x;
}

// Waits until the slot x (loaded from addr) carries `tag` in both halves,
// reloading it; a warp that does not poll (poll == 0) returns x as it is.
// The branches are uniform, as bra.uni asserts: `poll` and `tag` are the
// same in every lane, and every lane loads the one address in the one
// instruction, so every lane sees the same value.
__device__ __forceinline__ void wait_slot(uint4& x, unsigned addr, unsigned tag, unsigned poll) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %5, 0;\n"
      "@p bra.uni DONE;\n"
      "CHECK:\n"
      "setp.ne.u32 p, %1, %6;\n"
      "@!p setp.ne.u32 p, %3, %6;\n"
      "@!p bra.uni DONE;\n"
      "ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "bra.uni CHECK;\n"
      "DONE:\n"
      "}\n"
      : "+r"(x.x), "+r"(x.y), "+r"(x.z), "+r"(x.w)
      : "r"(addr), "r"(poll), "r"(tag));
}

// One state of a step: the best of c0, c1 and (where the 2-move may land)
// c2, the first on ties; its new alpha; returns the move.
__device__ __forceinline__ unsigned vit_state(float c0, float c1, float c2, bool gate,
                                              bool valid, float e, float& out) {
  c2 = gate ? c2 : NEG;
  float best = c0;
  unsigned m = 0;
  if (c1 > best) {
    best = c1;
    m = 1;
  }
  if (c2 > best) {
    best = c2;
    m = 2;
  }
  out = valid ? best + e : NEG;
  return m;
}

// This thread's CH words of packed moves of chunk c (steps 1 + c*CH ...).
__device__ __forceinline__ void fetch_chunk(uint4 (&pre)[CH / 4], const unsigned* pb, int nw,
                                            int g, int c) {
  const uint4* src = reinterpret_cast<const uint4*>(pb + (static_cast<size_t>(c) * nw + g) * CH);
#pragma unroll
  for (int q = 0; q < CH / 4; ++q) pre[q] = src[q];
}

__device__ __forceinline__ unsigned word_of(const uint4 (&pre)[CH / 4], int j) {
  const uint4& v = pre[j / 4];
  return (j & 3) == 0 ? v.x : (j & 3) == 1 ? v.y : (j & 3) == 2 ? v.z : v.w;
}

template <int K, bool RING>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_align_kernel(const float* __restrict__ lp,        // [B, T, V]
                     const int* __restrict__ z,           // [B, S]
                     const int* __restrict__ valid,       // [B, S]
                     const int* __restrict__ in_len,      // [B]
                     const int* __restrict__ tgt_len,     // [B]
                     float* __restrict__ score,           // [B]
                     int* __restrict__ path,              // [B, T]
                     int* __restrict__ labels,            // [B, T]
                     unsigned* __restrict__ packed,       // [B, chunks, 32 * warps, CH]
                     float* __restrict__ alpha_last,      // [B, S]
                     int time, int vocab, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x;                         // lanes of the sample
  const int warps = nw >> 5;
  const int g = threadIdx.x;                         // states [g*K, g*K + K)
  const int lane = g & 31, w = g >> 5;
  const int b = blockIdx.x;
  uint4* xs = reinterpret_cast<uint4*>(smem);        // [warps][2][CH + 1] exchange slots
  int* zs = reinterpret_cast<int*>(xs + warps * 2 * (CH + 1));       // [S]
  float* ring = reinterpret_cast<float*>(zs + round4(S));            // [2][CH][V] if RING
  float* row = ring;                                 // [S]: the last row, after the forward
  unsigned char* stage = reinterpret_cast<unsigned char*>(row + round4(S));
  const int s16 = round16(S);                        // stage: [2][CH][s16] moves, a byte each

  const int len = max(0, min(in_len[b], time));
  const int chunks = (time + CH - 2) / CH;           // of steps 1 .. T-1
  const float* lpb = lp + static_cast<size_t>(b) * time * vocab;
  unsigned* pb = packed + static_cast<size_t>(b) * chunks * nw * CH;

  // the log_probs rows of chunk c into half c % 2 of the ring, shared by
  // the sample's threads
  auto stage_emissions = [&](int c) {
    const int t0 = 1 + c * CH;
    if (RING && t0 < len) {
      const int n = min(CH, len - t0) * vocab;
      const float* src = lpb + static_cast<size_t>(t0) * vocab;
      float* dst = ring + (c & 1) * CH * vocab;
      for (int i = g; i < n; i += nw) cp_async4(dst + i, src + i);
    }
    cp_async_commit();
  };
  stage_emissions(0);
  for (int i = g; i < warps * 2 * (CH + 1); i += nw)
    put_slot(smem_addr(xs + i), 0.f, 0.f, NO_TAG);
  for (int s = g; s < S; s += nw) zs[s] = z[static_cast<size_t>(b) * S + s];
  sample_sync(warps);

  // this lane's states: z (emission offsets), the 2-move gate and valid as
  // bitmasks, and alpha[0]
  int zo[K];
  unsigned gate = 0, vmask = 0;
  float a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = g * K + i;
    const bool in = s < S;
    zo[i] = in ? zs[s] : 0;
    const bool v = in && valid[static_cast<size_t>(b) * S + s] != 0;
    gate |= static_cast<unsigned>(zo[i] != 0) << i;
    vmask |= static_cast<unsigned>(v) << i;
    a[i] = (s < 2 && v) ? lpb[zo[i]] : NEG;
  }
  // slots [2][CH + 1] of a warp: chunk c writes half c % 2 at j + 1 for the
  // step after its step j; its step 0 reads slot CH of the other half
  const unsigned mine = smem_addr(xs + w * 2 * (CH + 1));            // read by warp w + 1
  const unsigned left = smem_addr(xs + (w > 0 ? w - 1 : 0) * 2 * (CH + 1));
  const bool publishes = lane == 31 && w + 1 < warps;
  if (publishes) put_slot(mine + 16 * (2 * CH + 1), a[K - 2], a[K - 1], 1u);
  // the slot of the next step, loaded a step ahead and checked when used
  uint4 x = get_slot(left + 16 * (2 * CH + 1));

  for (int c = 0; 1 + c * CH < len; ++c) {
    const int t0 = 1 + c * CH;
    const int n = min(CH, len - t0);
    cp_async_wait_all();                     // this thread's copies of chunk c
    sample_sync(warps);                      // everyone's; and every warp is past chunk c - 1
    stage_emissions(c + 1);
    // the chunk's rows: in the ring, or in device memory
    const float* half =
        RING ? ring + (c & 1) * CH * vocab : lpb + static_cast<size_t>(t0) * vocab;
    const unsigned cur = 16 * (c & 1) * (CH + 1), other = 16 * (1 - (c & 1)) * (CH + 1);
    float e[K];
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = half[zo[i]];
    // step j of the chunk: alpha[t0 + j] from alpha[t0 + j - 1]; returns the
    // word of moves
    auto step = [&](int j) -> unsigned {
      const unsigned t = t0 + j;
      const unsigned in_slot = left + (j == 0 ? other + 16 * CH : cur + 16 * j);
      // the next step's emissions, a step ahead (from device memory only
      // where the step is the sample's)
      const bool ahead = j + 1 < CH && (RING || j + 1 < n);
      float en[K];
      if (ahead) {
#pragma unroll
        for (int i = 0; i < K; ++i) en[i] = half[(j + 1) * vocab + zo[i]];
      }
      float v1 = __shfl_up_sync(FULL, a[K - 1], 1);      // alpha[t-1](g*K - 1)
      float v2 = __shfl_up_sync(FULL, a[K - 2], 1);      // alpha[t-1](g*K - 2)
      float nx[K];
      unsigned word = 0;
#pragma unroll
      for (int i = K - 1; i >= 2; --i) {
        word |= vit_state(a[i], a[i - 1], a[i - 2], (gate >> i) & 1u, (vmask >> i) & 1u, e[i],
                          nx[i]) << (2 * i);
        asm volatile("" :: "f"(nx[i]));      // before the poll, not sunk below it
      }
      wait_slot(x, in_slot, t, w > 0);
      if (lane == 0) {
        v2 = w > 0 ? __uint_as_float(x.x) : NEG;
        v1 = w > 0 ? __uint_as_float(x.z) : NEG;
      }
      word |= vit_state(a[1], a[0], v1, gate & 2u, vmask & 2u, e[1], nx[1]) << 2;
      word |= vit_state(a[0], v1, v2, gate & 1u, vmask & 1u, e[0], nx[0]);
      x = get_slot(left + cur + 16 * (j + 1));
#pragma unroll
      for (int i = 0; i < K; ++i) {
        a[i] = nx[i];
        if (ahead) e[i] = en[i];
      }
      if (publishes) put_slot(mine + cur + 16 * (j + 1), a[K - 2], a[K - 1], t + 1);
      return word;
    };
    unsigned* pw = pb + (static_cast<size_t>(c) * nw + g) * CH;
    if (n == CH) {                           // a whole chunk: unrolled, no branch a step
      unsigned words[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) words[j] = step(j);
#pragma unroll
      for (int q = 0; q < CH / 4; ++q)
        reinterpret_cast<uint4*>(pw)[q] =
            make_uint4(words[4 * q], words[4 * q + 1], words[4 * q + 2], words[4 * q + 3]);
    } else {                                 // the last chunk of the sample
#pragma unroll 1
      for (int j = 0; j < n; ++j) pw[j] = step(j);
    }
  }
  cp_async_wait_all();

  // the last row through shared memory (over the ring: every warp is past
  // it), the final state and the score
  sample_sync(warps);
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (g * K + i < S) row[g * K + i] = a[i];
  sample_sync(warps);
  for (int s = g; s < S; s += nw) alpha_last[static_cast<size_t>(b) * S + s] = row[s];
  const int tl = tgt_len[b];
  const int end = max(0, min(2 * tl, S - 1));
  const int prev = max(0, min(2 * tl - 1, S - 1));
  const bool take_end = row[end] > row[prev];
  int top = take_end ? end : prev;
  if (g == 0) score[b] = take_end ? row[end] : row[prev];

  // the backtrace, a chunk at a time from the one of step len - 1
  int* pathb = path + static_cast<size_t>(b) * time;
  int* labb = labels + static_cast<size_t>(b) * time;
  for (int t = len + g; t < time; t += nw) {
    pathb[t] = 0;
    labb[t] = 0;
  }
  uint4 pre[CH / 4];
  int cb = len >= 2 ? (len - 2) / CH : -1;   // the walk's next chunk
  if (cb >= 0) fetch_chunk(pre, pb, nw, g, cb);
  for (int buf = 0; cb >= 0; buf ^= 1, --cb) {
    unsigned char* st = stage + buf * CH * s16;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const unsigned word = word_of(pre, j);
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (g * K + i < S) st[j * s16 + g * K + i] = (word >> (2 * i)) & 3u;
    }
    sample_sync(warps);
    if (cb > 0) fetch_chunk(pre, pb, nw, g, cb - 1);   // in flight while this chunk is walked
    if (w == 0) {
      const int t0 = 1 + cb * CH;
      const int jhi = min(CH - 1, len - 1 - t0);
      int pos = top, at = 0;
      const unsigned char* r = st + jhi * s16;
      for (int j = jhi; j >= 0; --j, r -= s16) {
        if (j == lane) at = pos;
        pos = max(pos - static_cast<int>(r[pos]), 0);
      }
      top = pos;
      if (lane <= jhi) {
        pathb[t0 + lane] = at;
        labb[t0 + lane] = zs[at];
      }
    }
  }
  if (g == 0 && len > 0) {
    pathb[0] = top;
    labb[0] = zs[top];
  }
}

struct Launch {
  const float* lp;
  const int *z, *valid, *in_len, *tgt_len;
  float* score;
  int *path, *labels;
  unsigned* packed;
  float* alpha_last;
  int batch, time, vocab, S, warps, smem;
  bool ring;
  cudaStream_t stream;
};

template <int K, bool RING>
int launch(const Launch& a) {
  const auto kernel = viterbi_align_kernel<K, RING>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.batch, 32 * a.warps, a.smem, a.stream>>>(
      a.lp, a.z, a.valid, a.in_len, a.tgt_len, a.score, a.path, a.labels, a.packed,
      a.alpha_last, a.time, a.vocab, a.S);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(int k, const Launch& a) {
  if constexpr (K > K_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return dispatch<K + 1>(k, a);
    return a.ring ? launch<K, true>(a) : launch<K, false>(a);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// score [B], path and labels [B, T] (int32), the packed moves [B, chunks,
// 32 * warps, 32] (uint32: lane g's words of steps 1 + 32c ... 32 + 32c,
// chunks = ceil((T - 1) / 32); words of steps from input_length on are
// unspecified, and chunks past it are not written) and the last lattice
// row [B, S] of a batch, in one launch, a block of `warps` warps a sample.
// Contiguous device arrays (log_probs float32; z, valid and the lengths
// int32; z < vocab). The layout (k states a lane, warps a sample), whether
// the rows go through the shared-memory ring (`ring`) and the dynamic
// shared memory come from ops/viterbi_cuda.py's viterbi_layout and
// viterbi_smem_bytes; a layout that does not cover S, or shared memory
// other than it needs, returns cudaErrorInvalidValue without launching.
// Returns cudaGetLastError() after the launch.
extern "C" int viterbi_align_f32(const float* lp, const int* z, const int* valid,
                                 const int* in_len, const int* tgt_len, float* score, int* path,
                                 int* labels, unsigned* packed, float* alpha_last, int batch,
                                 int time, int vocab, int S, int k, int warps, int ring,
                                 int smem, void* stream) {
  const bool fits = S >= 1 && S <= MAX_STATES && vocab >= 1 && k >= K_MIN && k <= K_MAX &&
                    warps >= 1 && warps <= MAX_WARPS && 32 * k * warps >= S &&
                    smem <= SMEM_LIMIT && smem == smem_bytes(S, vocab, warps, ring != 0);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || time <= 0) return static_cast<int>(cudaGetLastError());
  const Launch a{lp, z, valid, in_len, tgt_len, score, path, labels, packed, alpha_last,
                 batch, time, vocab, S, warps, smem, ring != 0,
                 static_cast<cudaStream_t>(stream)};
  return dispatch<K_MIN>(k, a);
}
