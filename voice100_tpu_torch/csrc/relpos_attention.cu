// Relative-position multi-head attention for Hopper (sm_90a), float32:
// kernel 9, the Conformer's self-attention core, forward and backward.
//
// Replaces no TPU kernel: the JAX package has no attention layer. It was
// added for the Conformer-CTC model (models/conformer_ctc.py), whose plain
// attention materialises [B, H, T, T] scores several times a layer (358 MB
// each at B = 64, H = 8, T = 418 in float32) and keeps them for backward.
//
// Semantics (ops/relpos_attention.py, NeMo's RelPositionMultiHeadAttention
// after its projections), for a head of size D = 64 with biases u and vb:
//     s[i, j] = ((q_i + u) . k_j + (q_i + vb) . p[T - 1 - i + j]) / sqrt(D)
//     P[i, j] = softmax_j over the keys j < len (0 for i >= len or j >= len)
//     o_i     = sum_j P[i, j] * keep[i, j] / (1 - p_drop) * v_j
// Layouts: q, k, v, o [B, T, H, D]; p [2T - 1, H, D]; u, vb [H, D]; keep
// [B, H, T, T] uint8 (null: no dropout); lse [B, H, T] (saved for backward).
//
// What bounds it on this card: float32 work outside the tensor cores,
// 3 dot products of D a pair forward (q.k, q.p, P.v) and 11 backward (each
// of the two backward kernels recomputes q.k and q.p and takes dO.v; then
// dV, dK, dQu, dQv and dp); B H T^2 pairs a layer. So the kernels are register-tiled SIMT products: a block of 256
// threads owns a 64 x 64 tile of pairs, each thread a 4 x 4 sub-tile, and the
// operands sit in shared memory (16-byte loads). The positional term needs
// only a window of 127 rows of p for a tile of 64 queries and 64 keys (row
// T - 1 - i + j runs over 127 values); a thread's 4 x 4 sub-tile reads 7
// consecutive rows of that window, two 16-byte loads. Nothing of size T x T
// is written: the forward keeps a running max and sum a row (online
// softmax) and saves lse; the backward recomputes the probabilities.
//
// Forward (relpos_fwd_kernel): a block a (query tile, head, batch row),
// looping over the key tiles below the row's length. Backward: the row
// reduction Delta_i = dO_i . o_i comes from the caller; relpos_dkdv_kernel
// owns a key tile and loops over query tiles (dK, dV in registers);
// relpos_dq_kernel owns a query tile and loops over key tiles (dQu = dS K,
// dQv = dS p-window in registers), and adds the positional gradient
// dp[r] = sum over pairs on diagonal r of dS[i, j] (q_i + vb) / sqrt(D)
// into dp_part[b % G] with atomics: the window of a key tile overlaps the
// next one's by 63 rows, so a thread carries the upper half of its window
// rows to the next tile in registers and flushes each row once a block.
// Tiles wholly past a row's length are skipped; padded rows get zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;               // head size
constexpr int TILE = 64;            // queries or keys a tile
constexpr int NT = 256;             // threads a block: 16 x 16, a 4 x 4 sub-tile each
constexpr int LD = TILE + 4;        // pitch of a 64-wide buffer (floats)
constexpr int TILE_F = D * LD;      // floats of one 64 x 64 buffer
constexpr int WIN = 2 * TILE;       // rows of a p window (127 used)
constexpr int LDW = WIN + 4;        // pitch of the transposed window
constexpr int WIN_T_F = D * LDW;    // the transposed window [D][LDW]
constexpr int WIN_R_F = WIN * LD;   // the row-major window [WIN][LD]

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* p;
  const float* u;
  const float* vb;
  const int* len;
  const uint8_t* keep;
  int B, T, H;
  float keep_scale;
};

__device__ __forceinline__ float4 ld4(const float* s) { return *reinterpret_cast<const float4*>(s); }
__device__ __forceinline__ void st4(float* s, float4 x) { *reinterpret_cast<float4*>(s) = x; }

__device__ __forceinline__ size_t row_off(int b, int t, int h, int T, int H) {
  return ((static_cast<size_t>(b) * T + t) * H + h) * D;
}

// 64 rows from t0 of a [B, T, H, D] tensor at (b, h), (x + bias) * scale,
// stored transposed: dst[d * LD + i]. Rows past T are zeros.
__device__ void load_t(float* dst, const float* src, const float* bias, float scale, int b, int t0,
                       int h, int T, int H) {
  for (int e = threadIdx.x; e < TILE * (D / 4); e += NT) {
    const int i = e & (TILE - 1), d4 = e >> 6;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + i < T) {
      x = *reinterpret_cast<const float4*>(src + row_off(b, t0 + i, h, T, H) + 4 * d4);
      if (bias != nullptr) {
        const float4 c = *reinterpret_cast<const float4*>(bias + h * D + 4 * d4);
        x.x += c.x; x.y += c.y; x.z += c.z; x.w += c.w;
      }
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    dst[(4 * d4 + 0) * LD + i] = x.x;
    dst[(4 * d4 + 1) * LD + i] = x.y;
    dst[(4 * d4 + 2) * LD + i] = x.z;
    dst[(4 * d4 + 3) * LD + i] = x.w;
  }
}

// The same rows stored row-major: dst[i * LD + d].
__device__ void load_r(float* dst, const float* src, const float* bias, float scale, int b, int t0,
                       int h, int T, int H) {
  for (int e = threadIdx.x; e < TILE * (D / 4); e += NT) {
    const int i = e >> 4, d4 = e & 15;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + i < T) {
      x = *reinterpret_cast<const float4*>(src + row_off(b, t0 + i, h, T, H) + 4 * d4);
      if (bias != nullptr) {
        const float4 c = *reinterpret_cast<const float4*>(bias + h * D + 4 * d4);
        x.x += c.x; x.y += c.y; x.z += c.z; x.w += c.w;
      }
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    st4(dst + i * LD + 4 * d4, x);
  }
}

// The p window of rows w0 .. w0 + 127 at head h (rows outside [0, 2T - 2]
// are zeros), transposed (dst[d * LDW + r]) and, with rdst, row-major too.
__device__ void load_window(float* tdst, float* rdst, const float* p, int w0, int h, int T, int H) {
  for (int e = threadIdx.x; e < WIN * (D / 4); e += NT) {
    const int r = e & (WIN - 1), d4 = e >> 7;
    const int g = w0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < WIN - 1 && g >= 0 && g <= 2 * T - 2)
      x = *reinterpret_cast<const float4*>(p + (static_cast<size_t>(g) * H + h) * D + 4 * d4);
    tdst[(4 * d4 + 0) * LDW + r] = x.x;
    tdst[(4 * d4 + 1) * LDW + r] = x.y;
    tdst[(4 * d4 + 2) * LDW + r] = x.z;
    tdst[(4 * d4 + 3) * LDW + r] = x.w;
    if (rdst != nullptr) st4(rdst + r * LD + 4 * d4, x);
  }
}

// s[a][c] = sum_d QuT[d][4ty+a] KT[d][4tx+c] + QvT[d][4ty+a] PT[d][63 + 4tx+c - 4ty-a]
__device__ __forceinline__ void score_tile(const float* QuT, const float* QvT, const float* KT,
                                           const float* PT, int ty, int tx, float s[4][4]) {
  const int pb = (TILE - 4) + 4 * (tx - ty);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 qu = ld4(QuT + d * LD + 4 * ty);
    const float4 kk = ld4(KT + d * LD + 4 * tx);
    const float4 qv = ld4(QvT + d * LD + 4 * ty);
    const float4 p0 = ld4(PT + d * LDW + pb);
    const float4 p1 = ld4(PT + d * LDW + pb + 4);
    const float qa[4] = {qu.x, qu.y, qu.z, qu.w};
    const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
    const float va[4] = {qv.x, qv.y, qv.z, qv.w};
    const float pw[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], ka[c], s[a][c]);
        s[a][c] = fmaf(va[a], pw[3 + c - a], s[a][c]);
      }
  }
}

// acc[a][c] += sum_k A[k][4ty+a] B[k][4tx+c], both k-major with pitch LD.
__device__ __forceinline__ void mm_tile(const float* A, const float* B, int ty, int tx,
                                        float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    const float4 x = ld4(A + k * LD + 4 * ty);
    const float4 y = ld4(B + k * LD + 4 * tx);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xa[a], ya[c], acc[a][c]);
  }
}

__device__ __forceinline__ float keep_factor(const Args& a, int b, int h, int i, int j) {
  if (a.keep == nullptr) return 1.f;
  const size_t idx = ((static_cast<size_t>(b) * a.H + h) * a.T + i) * a.T + j;
  return a.keep[idx] ? a.keep_scale : 0.f;
}

__device__ __forceinline__ int clamp_len(const int* len, int b, int T) {
  const int L = len[b];
  return L < 0 ? 0 : (L > T ? T : L);
}

__device__ void zero_rows(float* out, int b, int t0, int h, int T, int H) {
  for (int e = threadIdx.x; e < TILE * (D / 4); e += NT) {
    const int i = e >> 4, d4 = e & 15;
    if (t0 + i < T) st4(out + row_off(b, t0 + i, h, T, H) + 4 * d4, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

constexpr float SCALE = 0.125f;  // 1 / sqrt(D), a power of two: exact

__global__ void __launch_bounds__(NT) relpos_fwd_kernel(Args a, float* out, float* lse) {
  extern __shared__ float4 smem4[];
  float* QuT = reinterpret_cast<float*>(smem4);
  float* QvT = QuT + TILE_F;
  float* KT = QvT + TILE_F;
  float* Vr = KT + TILE_F;
  float* PT = Vr + TILE_F;
  float* PsT = KT;  // the probabilities, transposed, once the scores are taken

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int T = a.T, H = a.H;
  const int L = clamp_len(a.len, b, T);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (i0 >= L) {
    zero_rows(out, b, i0, h, T, H);
    if (threadIdx.x < TILE && i0 + threadIdx.x < T)
      lse[(static_cast<size_t>(b) * H + h) * T + i0 + threadIdx.x] = 0.f;
    return;
  }
  load_t(QuT, a.q, a.u, SCALE, b, i0, h, T, H);
  load_t(QvT, a.q, a.vb, SCALE, b, i0, h, T, H);

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
  }
  for (int j0 = 0; j0 < L; j0 += TILE) {
    __syncthreads();
    load_t(KT, a.k, nullptr, 1.f, b, j0, h, T, H);
    load_r(Vr, a.v, nullptr, 1.f, b, j0, h, T, H);
    load_window(PT, nullptr, a.p, T - 1 - i0 + j0 - (TILE - 1), h, T, H);
    __syncthreads();
    float s[4][4];
    score_tile(QuT, QvT, KT, PT, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + 4 * tx + c >= L) s[r][c] = -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);  // finite: key j0 is below the length
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = expf(s[r][c] - m_new);
        s[r][c] = pr;
        rs += pr;
        o[r][c] *= alpha;
      }
      l[r] = l[r] * alpha + rs;  // this thread's columns; summed over the row at the end
    }
    if (a.keep != nullptr) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
          s[r][c] *= (i < T && j < T) ? keep_factor(a, b, h, i, j) : 0.f;
        }
    }
    __syncthreads();  // every thread has read KT
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) PsT[(4 * tx + c) * LD + 4 * ty + r] = s[r][c];
    __syncthreads();
    mm_tile(PsT, Vr, ty, tx, o);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float sum = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int i = i0 + 4 * ty + r;
    if (i < T) {
      const float inv = i < L ? 1.f / sum : 0.f;
      st4(out + row_off(b, i, h, T, H) + 4 * tx,
          make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv));
      if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * T + i] = i < L ? m[r] + logf(sum) : 0.f;
    }
  }
}

// The probabilities and dS of a (query tile, key tile) from the scores s and
// dO.v products dp: P = exp(s - lse) on valid pairs, P' = P keep, dS =
// P (dp keep - Delta). Rows a = 4ty + r, columns 4tx + c.
__device__ __forceinline__ void grads_of_tile(const Args& a, int b, int h, int i0, int j0, int L,
                                              int ty, int tx, const float* lse_s,
                                              const float* dl_s, float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
      const bool valid = i < L && j < L;
      const float pr = valid ? expf(s[r][c] - lse_s[4 * ty + r]) : 0.f;
      const float kf = valid ? keep_factor(a, b, h, i, j) : 0.f;
      s[r][c] = pr * kf;                                   // P'
      dp[r][c] = pr * (dp[r][c] * kf - dl_s[4 * ty + r]);  // dS
    }
}

__device__ void load_rowstats(float* lse_s, float* dl_s, const float* lse, const float* delta,
                              int b, int h, int i0, int T, int H) {
  if (threadIdx.x < TILE) {
    const int i = i0 + threadIdx.x;
    const size_t idx = (static_cast<size_t>(b) * H + h) * T + i;
    lse_s[threadIdx.x] = i < T ? lse[idx] : 0.f;
    dl_s[threadIdx.x] = i < T ? delta[idx] : 0.f;
  }
}

__global__ void __launch_bounds__(NT) relpos_dkdv_kernel(Args a, const float* dout,
                                                        const float* lse, const float* delta,
                                                        float* dk, float* dv) {
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);
  float* VT = KT + TILE_F;
  float* QuT = VT + TILE_F;
  float* QvT = QuT + TILE_F;
  float* dOT = QvT + TILE_F;
  float* Qur = dOT + TILE_F;
  float* dOr = Qur + TILE_F;
  float* PT = dOr + TILE_F;
  float* lse_s = PT + WIN_T_F;
  float* dl_s = lse_s + TILE;
  float* Ps = QuT;   // P' [i][j] once the scores are taken
  float* dSs = QvT;  // dS [i][j]

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * TILE;
  const int T = a.T, H = a.H;
  const int L = clamp_len(a.len, b, T);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (j0 >= L) {
    zero_rows(dk, b, j0, h, T, H);
    zero_rows(dv, b, j0, h, T, H);
    return;
  }
  load_t(KT, a.k, nullptr, 1.f, b, j0, h, T, H);
  load_t(VT, a.v, nullptr, 1.f, b, j0, h, T, H);
  float acc_k[4][4], acc_v[4][4];  // rows j = 4ty + r, columns d = 4tx + c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int i0 = 0; i0 < L; i0 += TILE) {
    __syncthreads();
    load_t(QuT, a.q, a.u, SCALE, b, i0, h, T, H);
    load_t(QvT, a.q, a.vb, SCALE, b, i0, h, T, H);
    load_t(dOT, dout, nullptr, 1.f, b, i0, h, T, H);
    load_r(Qur, a.q, a.u, SCALE, b, i0, h, T, H);
    load_r(dOr, dout, nullptr, 1.f, b, i0, h, T, H);
    load_window(PT, nullptr, a.p, T - 1 - i0 + j0 - (TILE - 1), h, T, H);
    load_rowstats(lse_s, dl_s, lse, delta, b, h, i0, T, H);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile(QuT, QvT, KT, PT, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[r][c] = 0.f;
    mm_tile(dOT, VT, ty, tx, dp);
    grads_of_tile(a, b, h, i0, j0, L, ty, tx, lse_s, dl_s, s, dp);
    __syncthreads();  // every thread has read QuT and QvT
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st4(Ps + (4 * ty + r) * LD + 4 * tx, make_float4(s[r][0], s[r][1], s[r][2], s[r][3]));
      st4(dSs + (4 * ty + r) * LD + 4 * tx, make_float4(dp[r][0], dp[r][1], dp[r][2], dp[r][3]));
    }
    __syncthreads();
    mm_tile(Ps, dOr, ty, tx, acc_v);   // dV[j][d] += sum_i P'[i][j] dO[i][d]
    mm_tile(dSs, Qur, ty, tx, acc_k);  // dK[j][d] += sum_i dS[i][j] Qu[i][d] / sqrt(D)
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j < T) {
      st4(dk + row_off(b, j, h, T, H) + 4 * tx,
          make_float4(acc_k[r][0], acc_k[r][1], acc_k[r][2], acc_k[r][3]));
      st4(dv + row_off(b, j, h, T, H) + 4 * tx,
          make_float4(acc_v[r][0], acc_v[r][1], acc_v[r][2], acc_v[r][3]));
    }
  }
}

__device__ __forceinline__ void add_window_rows(float* dp_part, const float4* acc, int w0, int b,
                                                int G, int h, int T, int H, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int g = w0 + ty + 16 * k;
    if (g >= 0 && g <= 2 * T - 2) {
      float* dst = dp_part + ((static_cast<size_t>(b % G) * (2 * T - 1) + g) * H + h) * D + 4 * tx;
      atomicAdd(dst + 0, acc[k].x);
      atomicAdd(dst + 1, acc[k].y);
      atomicAdd(dst + 2, acc[k].z);
      atomicAdd(dst + 3, acc[k].w);
    }
  }
}

__global__ void __launch_bounds__(NT) relpos_dq_kernel(Args a, const float* dout, const float* lse,
                                                      const float* delta, float* dq_u,
                                                      float* dq_v, float* dp_part, int G) {
  extern __shared__ float4 smem4[];
  float* QuT = reinterpret_cast<float*>(smem4);
  float* QvT = QuT + TILE_F;
  float* dOT = QvT + TILE_F;
  float* Qvr = dOT + TILE_F;
  float* KT = Qvr + TILE_F;
  float* VT = KT + TILE_F;
  float* Kr = VT + TILE_F;
  float* PT = Kr + TILE_F;
  float* Pr = PT + WIN_T_F;
  float* lse_s = Pr + WIN_R_F;
  float* dl_s = lse_s + TILE;
  float* dSs = KT;   // dS [i][j] once the scores are taken
  float* dST = VT;   // dS [j][i]

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int T = a.T, H = a.H;
  const int L = clamp_len(a.len, b, T);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (i0 >= L) {
    zero_rows(dq_u, b, i0, h, T, H);
    zero_rows(dq_v, b, i0, h, T, H);
    return;
  }
  load_t(QuT, a.q, a.u, SCALE, b, i0, h, T, H);
  load_t(QvT, a.q, a.vb, SCALE, b, i0, h, T, H);
  load_t(dOT, dout, nullptr, 1.f, b, i0, h, T, H);
  load_r(Qvr, a.q, a.vb, SCALE, b, i0, h, T, H);
  load_rowstats(lse_s, dl_s, lse, delta, b, h, i0, T, H);

  float acc_u[4][4], acc_v[4][4];  // rows i = 4ty + r, columns d = 4tx + c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_u[r][c] = acc_v[r][c] = 0.f;
  float4 acc_p[8];  // window rows ty + 16k, columns 4tx .. 4tx + 3
#pragma unroll
  for (int k = 0; k < 8; ++k) acc_p[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  int w0 = 0;
  for (int j0 = 0; j0 < L; j0 += TILE) {
    w0 = T - 1 - i0 + j0 - (TILE - 1);
    __syncthreads();
    load_t(KT, a.k, nullptr, 1.f, b, j0, h, T, H);
    load_t(VT, a.v, nullptr, 1.f, b, j0, h, T, H);
    load_r(Kr, a.k, nullptr, 1.f, b, j0, h, T, H);
    load_window(PT, Pr, a.p, w0, h, T, H);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile(QuT, QvT, KT, PT, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[r][c] = 0.f;
    mm_tile(dOT, VT, ty, tx, dp);
    grads_of_tile(a, b, h, i0, j0, L, ty, tx, lse_s, dl_s, s, dp);
    __syncthreads();  // every thread has read KT and VT
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st4(dSs + (4 * ty + r) * LD + 4 * tx, make_float4(dp[r][0], dp[r][1], dp[r][2], dp[r][3]));
#pragma unroll
      for (int c = 0; c < 4; ++c) dST[(4 * tx + c) * LD + 4 * ty + r] = dp[r][c];
    }
    __syncthreads();
    mm_tile(dST, Kr, ty, tx, acc_u);  // dQu[i][d] += sum_j dS[i][j] K[j][d]
#pragma unroll 2
    for (int jj = 0; jj < TILE; ++jj) {  // dQv[i][d] += sum_j dS[i][j] p[63 + j - i][d]
      const float4 sa = ld4(dST + jj * LD + 4 * ty);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 pr = ld4(Pr + (TILE - 1 + jj - 4 * ty - r) * LD + 4 * tx);
        acc_v[r][0] = fmaf(sv[r], pr.x, acc_v[r][0]);
        acc_v[r][1] = fmaf(sv[r], pr.y, acc_v[r][1]);
        acc_v[r][2] = fmaf(sv[r], pr.z, acc_v[r][2]);
        acc_v[r][3] = fmaf(sv[r], pr.w, acc_v[r][3]);
      }
    }
    // dp window: row rr = 63 + j - i takes dS[i][j] (q_i + vb) / sqrt(D)
#pragma unroll 2
    for (int ii = 0; ii < TILE; ++ii) {
      const float4 qv = ld4(Qvr + ii * LD + 4 * tx);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int jj = ty + 16 * k - (TILE - 1) + ii;
        if (jj >= 0 && jj < TILE) {
          const float w = dSs[ii * LD + jj];
          acc_p[k].x = fmaf(w, qv.x, acc_p[k].x);
          acc_p[k].y = fmaf(w, qv.y, acc_p[k].y);
          acc_p[k].z = fmaf(w, qv.z, acc_p[k].z);
          acc_p[k].w = fmaf(w, qv.w, acc_p[k].w);
        }
      }
    }
    // rows 0..63 of this window are complete (the next window starts 64
    // rows on): add them, carry rows 64..127 down
    add_window_rows(dp_part, acc_p, w0, b, G, h, T, H, ty, tx);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc_p[k] = acc_p[k + 4];
      acc_p[k + 4] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  add_window_rows(dp_part, acc_p, w0 + TILE, b, G, h, T, H, ty, tx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i < T) {
      st4(dq_u + row_off(b, i, h, T, H) + 4 * tx,
          make_float4(acc_u[r][0] * SCALE, acc_u[r][1] * SCALE, acc_u[r][2] * SCALE,
                      acc_u[r][3] * SCALE));
      st4(dq_v + row_off(b, i, h, T, H) + 4 * tx,
          make_float4(acc_v[r][0] * SCALE, acc_v[r][1] * SCALE, acc_v[r][2] * SCALE,
                      acc_v[r][3] * SCALE));
    }
  }
}

constexpr int FWD_SMEM = (4 * TILE_F + WIN_T_F) * 4;
constexpr int DKDV_SMEM = (7 * TILE_F + WIN_T_F + 2 * TILE) * 4;
constexpr int DQ_SMEM = (7 * TILE_F + WIN_T_F + WIN_R_F + 2 * TILE) * 4;

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

Args make_args(const float* q, const float* k, const float* v, const float* p, const float* u,
               const float* vb, const int* len, const uint8_t* keep, int B, int T, int H,
               float keep_scale) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.p = p; a.u = u; a.vb = vb; a.len = len; a.keep = keep;
  a.B = B; a.T = T; a.H = H; a.keep_scale = keep_scale;
  return a;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [B, T, H, D] and lse [B, H, T] (see the top). Contiguous device
// arrays; len int32 [B]; keep uint8 [B, H, T, T] or null. One launch.
extern "C" int relpos_attn_fwd_f32(const float* q, const float* k, const float* v, const float* p,
                                   const float* u, const float* vb, const int* len,
                                   const uint8_t* keep, float* out, float* lse, int B, int T,
                                   int H, float keep_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, p, u, vb, len, keep, B, T, H, keep_scale);
  cudaError_t err = prepare(relpos_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TILE - 1) / TILE, H, B);
  relpos_fwd_kernel<<<grid, NT, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(a, out, lse);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv, dq_u (= dL/d(q + u)), dq_v (= dL/d(q + vb)) [B, T, H, D] and the
// positional gradient's G partial sums dp_part [G, 2T - 1, H, D] (added to:
// the caller zeroes it), from dout [B, T, H, D], the forward's lse and
// delta [B, H, T] (dout . out a row). Two launches.
extern "C" int relpos_attn_bwd_f32(const float* q, const float* k, const float* v, const float* p,
                                   const float* u, const float* vb, const int* len,
                                   const uint8_t* keep, const float* dout, const float* lse,
                                   const float* delta, float* dq_u, float* dq_v, float* dk,
                                   float* dv, float* dp_part, int B, int T, int H, int G,
                                   float keep_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, p, u, vb, len, keep, B, T, H, keep_scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + TILE - 1) / TILE, H, B);
  cudaError_t err = prepare(relpos_dkdv_kernel, DKDV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_dkdv_kernel<<<grid, NT, DKDV_SMEM, st>>>(a, dout, lse, delta, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare(relpos_dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_dq_kernel<<<grid, NT, DQ_SMEM, st>>>(a, dout, lse, delta, dq_u, dq_v, dp_part, G);
  return static_cast<int>(cudaGetLastError());
}
