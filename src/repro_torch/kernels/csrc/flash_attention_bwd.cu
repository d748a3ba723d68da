// The backward of grouped-query attention for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's training step differentiates
// its chunked XLA attention (models/layers.py, attention_apply under
// jax.checkpoint) and its Pallas flash_attention has no backward; the
// port's forward is a hand-written kernel launched through ctypes, which
// autograd cannot see through, so its gradient is this kernel, reached
// through kernels/flash_attention.py::FlashAttentionFunction. It computes
// the gradient XLA gives the JAX training step, from the forward's output o
// and its per-row log-sum-exp lse (csrc/flash_attention.cu), without ever
// holding a row's scores in device memory. For query head h (BH of them,
// h reading KV head h / G), query row i at position i + q_offset and a key
// j it sees (the forward's causal / window mask):
//
//   p_ij  = exp(scale · q_i·k_j − lse_i)                      (float32)
//   D_i   = Σ_c dO_ic o_ic
//   dv_j  = Σ_{h, i} p_ij dO_i        dp_ij = dO_i · v_j
//   ds_ij = p_ij (dp_ij − D_i)
//   dq_i  = scale Σ_j ds_ij k_j       dk_j  = scale Σ_{h, i} ds_ij q_i
//
// Three launches, no atomics, so two calls give the same bits:
// * delta: D, one warp a row (a fixed butterfly), from the input-type o.
// * dkdv: one CTA a (KV head, key tile). K and V stay in shared memory;
//   the CTA walks the G query heads of its KV head and, in each, the query
//   tiles that see some key of its tile (the causal / window band), and
//   accumulates dk and dv for its keys in registers, in one fixed order.
// * dq: one CTA a tile of query rows; it walks the key tiles of its rows'
//   band, recomputing p and ds, and accumulates dq in registers.
// The heaviest tiles of a causal band (the first key tiles, the last row
// tiles) are launched first.
//
// Bound on this card: operations. Danube's training call (32 heads over
// 8, S = 4,096, d = 120, window 4,096) has 2.7e8 visible pairs a call and
// 5 products of 2·d operations a pair, 3.2e11 operations, 0.33 ms at the
// bf16 tensor cores' peak; its inputs and outputs are 0.2 GB, 0.06 ms at
// the memory's rate. The dq launch recomputes the scores and dp that the
// dkdv launch formed (7 products a pair in all) rather than exchange ds
// between CTAs, which would need atomics or a fixed-order handshake.
//
// bfloat16 (tensor cores: wgmma, TMA, warp specialisation; the building
// blocks are csrc/hopper_mma.cuh, shared with the forward).
// * Threads: two consumer warpgroups, then a producer warpgroup whose
//   first warp fills a ring of tiles in shared memory; setmaxnreg moves the
//   producer's registers to the consumers (24 against 240 a thread).
// * Shared tiles are bf16 in the 128-byte-swizzled layout that TMA writes
//   and wgmma reads (blocks of 64 columns; d <= 64 pads to one block, d <=
//   128 to two; columns past d and rows past Sq / Sk are zeros). When the
//   rows are 16-byte aligned (d a multiple of 8, aligned bases) one lane
//   issues TMA loads against a full barrier that counts the bytes;
//   otherwise the producer warp's lanes load elements into the same layout.
//   Consumers free a stage through its empty barrier.
// * dkdv: BK = 128 keys a CTA, 64 a consumer warpgroup, K and V resident.
//   Query tiles of 64 rows (Q and dO, with the rows' −lse·log2 e and D in
//   float32 beside them) stream through a ring of 3 stages. A tile:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma m64n64k16 from shared memory (keys
//   are M, so each key's row of the fragment is the operand layout that
//   follows), pᵀ = 2^(Sᵀ·scale·log2 e − lse·log2 e) (ex2.approx), the mask
//   only on tiles that some key of the warp does not wholly see, dSᵀ =
//   pᵀ(dPᵀ − D); then dV += pᵀ·dO and dK += dSᵀ·Q by wgmma with pᵀ and dSᵀ
//   rounded to bf16 in registers as the A operand and dO, Q as MN-major B
//   (the forward's p·v form). dK and dV stay in float32 registers (2 × 64
//   × DP a warpgroup) and are scaled and rounded to bf16 once.
// * dq: the forward's CTA: one KV head and 128 rows r = i·G + g of its G
//   query heads (two warpgroups of 64), which share each K/V tile; Q and
//   dO staged once (cp.async when aligned), K/V tiles of 64 keys through a
//   ring of 3 stages. A tile: S = Q·Kᵀ and dP = dO·Vᵀ (m64n64k16), p and
//   dS = p(dP − D) on the fragment, dQ += dS(bf16)·K (K as MN-major B).
// * A warpgroup runs each tile's products and its exp work in turn (the
//   two warpgroups of a CTA interleave): in dkdv a second Sᵀ/dPᵀ pair does
//   not fit in the registers beside dK and dV (the compiler serialises the
//   products), and software pipelines of both kernels measured slower
//   (PERF.md §6).
// * p and ds are float32 until they are rounded to bf16 as operands;
//   every product sums in float32; D comes from the bf16 o, as SDPA's
//   backward takes it.
//
// float32 (CUDA cores): fmaf chains (TF32 would round the inputs to 10
// bits). 64 × 64 tiles in shared memory (rows padded by 4 floats, so a
// warp's float4 reads of 16 rows fall in distinct banks), 256 threads a
// CTA, each thread a 4 × 4 block of the scores and the dp tile (4 rows × 4
// keys, 8 floats read a 16 fmaf) and a 4 × DP/16 block of its outputs; a
// dkdv CTA takes 64 keys.
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_mma.cuh"
#include "launch_log.cuh"

namespace {

constexpr int kThreads = 256;         // float32 path
constexpr int kB = 64;                // query rows and keys a tile, float32
constexpr int kPS = kB + 4;           // row stride of the p / ds tiles

// ---------------------------------------------------------------------------
// float32: CUDA cores (and the delta pass of both types)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

// Rows [r0, r0 + n) of a (rows, d) matrix into a shared tile of kB rows ×
// DP floats (row stride DP + 4); zeros past column d and past row n.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* tile, const T* src, long long r0,
                                      int n, int d) {
  constexpr int DS = DP + 4;
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    tile[r * DS + c] =
        r < n && c < d ? ld(src + (size_t)(r0 + r) * d + c) : 0.f;
  }
}

// s[a][b] = Σ_c A[ra + a][c] · B[rb + 16b][c] over DP columns of two staged
// tiles (row stride DP + 4): the thread's 4 rows × 4 keys.
template <int DP>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          int ra, int rb, float (&s)[4][4]) {
  constexpr int DS = DP + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(A + (ra + a) * DS + c);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      y[b] = *reinterpret_cast<const float4*>(B + (rb + 16 * b) * DS + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(x[a].x, y[b].x, s[a][b]);
        s[a][b] = fmaf(x[a].y, y[b].y, s[a][b]);
        s[a][b] = fmaf(x[a].z, y[b].z, s[a][b]);
        s[a][b] = fmaf(x[a].w, y[b].w, s[a][b]);
      }
  }
}

// Is key kpos visible from the query at qpos?
__device__ __forceinline__ bool visible(long long qpos, long long kpos,
                                        int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta,
                                     long long rows, int d) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* orow = o + (size_t)r * d;
  const T* grow = dout + (size_t)r * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(ld(grow + c), ld(orow + c), s);
  s = warp_sum(s);
  if (lane == 0) delta[r] = s;
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles; p and ds tiles; lse and D of the query tile
  return sizeof(float) * ((size_t)4 * kB * (DP + 4) + 2 * kB * kPS + 2 * kB);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int group, int sq, int sk,
        int d, int causal, int window, int q_offset, float scale,
        int ntiles) {
  constexpr int DS = DP + 4;
  constexpr int CPT = DP / 16;        // output columns a thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kB][DS]
  float* Vs = Ks + kB * DS;
  float* Qs = Vs + kB * DS;
  float* Gs = Qs + kB * DS;                      // dO
  float* Ps = Gs + kB * DS;                      // [kB rows][kPS]: p
  float* Ss = Ps + kB * kPS;                     // ds
  float* Ls = Ss + kB * kPS;                     // [kB] lse
  float* Ds = Ls + kB;                           // [kB] D

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int hk = blockIdx.x / ntiles;
  const int k0 = (int)(blockIdx.x % ntiles) * kB;  // tile 0 (most rows) first
  const int nk = min(kB, sk - k0);
  stage<T, DP>(Ks, k + (size_t)hk * sk * d, k0, nk, d);
  stage<T, DP>(Vs, v + (size_t)hk * sk * d, k0, nk, d);

  // the query rows that see some key of the tile
  long long i_begin = 0, i_end = sq;
  if (causal) i_begin = max(0LL, (long long)k0 - q_offset);
  if (window > 0)
    i_end = min(i_end, (long long)k0 + nk - 1 + window - q_offset);

  float dva[4][CPT], dka[4][CPT];     // keys ty·4 + a, columns tx + 16u
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < CPT; ++u) dva[a][u] = dka[a][u] = 0.f;

  for (int g = 0; g < group; ++g) {
    const size_t h = (size_t)hk * group + g;
    for (long long i0 = i_begin; i0 < i_end; i0 += kB) {
      const int nq = (int)min((long long)kB, i_end - i0);
      __syncthreads();                // the last tile's readers are done
      stage<T, DP>(Qs, q + h * sq * d, i0, nq, d);
      stage<T, DP>(Gs, dout + h * sq * d, i0, nq, d);
      if (tid < kB) {
        Ls[tid] = tid < nq ? lse[h * sq + i0 + tid] : 0.f;
        Ds[tid] = tid < nq ? delta[h * sq + i0 + tid] : 0.f;
      }
      __syncthreads();

      // p and ds of rows ty·4 + a, keys tx + 16b
      float s[4][4], dp[4][4];
      tile_dots<DP>(Qs, Ks, ty * 4, tx, s);
      tile_dots<DP>(Gs, Vs, ty * 4, tx, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
        const long long qpos = i0 + r + q_offset;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = tx + 16 * b;
          const bool keep =
              r < nq && c < nk && visible(qpos, k0 + c, causal, window);
          const float p =
              keep ? expf(__fsub_rn(__fmul_rn(s[a][b], scale), Ls[r])) : 0.f;
          Ps[r * kPS + c] = p;
          Ss[r * kPS + c] = __fmul_rn(p, __fsub_rn(dp[a][b], Ds[r]));
        }
      }
      __syncthreads();

      // dv += pᵀ dO and dk += dsᵀ q over the tile's rows, in row order
      for (int r = 0; r < nq; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(Ps + r * kPS +
                                                           ty * 4);
        const float4 sr = *reinterpret_cast<const float4*>(Ss + r * kPS +
                                                           ty * 4);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
        const float sv[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const float gq = Gs[r * DS + tx + 16 * u];
          const float qq = Qs[r * DS + tx + 16 * u];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dva[a][u] = fmaf(pv[a], gq, dva[a][u]);
            dka[a][u] = fmaf(sv[a], qq, dka[a][u]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = ty * 4 + a;
    if (j >= nk) continue;
    const size_t row = ((size_t)hk * sk + k0 + j) * d;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = tx + 16 * u;
      if (c < d) {
        st(dk + row + c, __fmul_rn(dka[a][u], scale));
        st(dv + row + c, dva[a][u]);
      }
    }
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; the ds tile (key-major); lse and D of the rows
  return sizeof(float) * ((size_t)4 * kB * (DP + 4) + kB * kPS + 2 * kB);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dq, int group, int sq, int sk, int d, int causal,
        int window, int q_offset, float scale, int ntiles) {
  constexpr int DS = DP + 4;
  constexpr int CPT = DP / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kB][DS]
  float* Gs = Qs + kB * DS;                      // dO
  float* Ks = Gs + kB * DS;
  float* Vs = Ks + kB * DS;
  float* St = Vs + kB * DS;                      // [kB keys][kPS]: ds
  float* Ls = St + kB * kPS;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t h = blockIdx.x / ntiles;
  const int hk = (int)(h / group);
  // the heaviest row tiles (the causal band's end) first
  const int i0 = (ntiles - 1 - (int)(blockIdx.x % ntiles)) * kB;
  const int nq = min(kB, sq - i0);
  stage<T, DP>(Qs, q + h * sq * d, i0, nq, d);
  stage<T, DP>(Gs, dout + h * sq * d, i0, nq, d);
  if (tid < kB) {
    Ls[tid] = tid < nq ? lse[h * sq + i0 + tid] : 0.f;
    Ds[tid] = tid < nq ? delta[h * sq + i0 + tid] : 0.f;
  }

  // the keys some row of the tile sees
  long long k_begin = 0, k_end = sk;
  if (causal) k_end = min(k_end, (long long)i0 + nq - 1 + q_offset + 1);
  if (window > 0)
    k_begin = max(k_begin, (long long)i0 + q_offset - window + 1);

  float dqa[4][CPT];                  // rows ty·4 + a, columns tx + 16u
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < CPT; ++u) dqa[a][u] = 0.f;

  const T* kh = k + (size_t)hk * sk * d;
  const T* vh = v + (size_t)hk * sk * d;
  for (long long kb = k_begin; kb < k_end; kb += kB) {
    const int nk = (int)min((long long)kB, k_end - kb);
    __syncthreads();                  // the last tile's readers are done
    stage<T, DP>(Ks, kh, kb, nk, d);
    stage<T, DP>(Vs, vh, kb, nk, d);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<DP>(Qs, Ks, ty * 4, tx, s);
    tile_dots<DP>(Gs, Vs, ty * 4, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
      const long long qpos = (long long)i0 + r + q_offset;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = tx + 16 * b;
        const bool keep =
            r < nq && c < nk && visible(qpos, kb + c, causal, window);
        const float p =
            keep ? expf(__fsub_rn(__fmul_rn(s[a][b], scale), Ls[r])) : 0.f;
        St[c * kPS + r] = __fmul_rn(p, __fsub_rn(dp[a][b], Ds[r]));
      }
    }
    __syncthreads();

    // dq += ds k over the tile's keys, in key order
    for (int j = 0; j < nk; ++j) {
      const float4 sr =
          *reinterpret_cast<const float4*>(St + j * kPS + ty * 4);
      const float sv[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const float kk = Ks[j * DS + tx + 16 * u];
#pragma unroll
        for (int a = 0; a < 4; ++a) dqa[a][u] = fmaf(sv[a], kk, dqa[a][u]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (r >= nq) continue;
    const size_t row = (h * sq + i0 + r) * d;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = tx + 16 * u;
      if (c < d) st(dq + row + c, __fmul_rn(dqa[a][u], scale));
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kBKV = 128;             // keys a dkdv CTA (64 a warpgroup)
constexpr int kBQ = 64;               // query rows a dkdv ring tile
constexpr int kRowsQ = 128;           // query rows a dq CTA (64 a warpgroup)
constexpr int kBKQ = 64;              // keys a dq ring tile
constexpr int kStages = 3;            // ring stages, both kernels
constexpr int kThreadsBf16 = 384;     // two consumer warpgroups + producer
constexpr float kLog2e = 1.4426950408889634f;

// The visible columns of a thread's two fragment rows h = 0, 1 in a tile
// of n columns, [lo[h], hi[h]) relative to the tile, clamped to [0, n) and
// shifted by 2·quad into a[h], b[h] (column 8j + e + 2·quad is visible iff
// a[h] <= 8j + e < b[h]). Returns whether every row of the warp sees every
// column (warp-uniform).
__device__ __forceinline__ bool band(const long long (&lo)[2],
                                     const long long (&hi)[2], int n,
                                     int quad, int (&a)[2], int (&b)[2]) {
  bool whole = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = (int)max(0LL, min((long long)n, lo[h]));
    b[h] = (int)max(0LL, min((long long)n, hi[h]));
    whole = whole && a[h] == 0 && b[h] == n;
    a[h] -= 2 * quad;
    b[h] -= 2 * quad;
  }
  return __all_sync(~0u, whole);
}

// On an m64n64 fragment pair (element 4j + 2h + e: row h of the thread,
// column 8j + 2·quad + e): p = 2^(s·sl2 + nl) into s, ds = p (dp − dd) into
// dp; nl(h, c) is the element's −lse·log2 e and dd(h, c) its D, for
// c = 8j + e. With MASK the columns outside [a[h], b[h]) get p = ds = 0; a
// visible element's arithmetic is the same with and without MASK.
template <bool MASK, typename NL, typename DD>
__device__ __forceinline__ void p_ds(float (&s)[32], float (&dp)[32],
                                     const int (&a)[2], const int (&b)[2],
                                     float sl2, NL nl, DD dd) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * h + e, c = 8 * j + e;
        float p = ex2(__fmaf_rn(s[x], sl2, nl(h, c)));
        if (MASK && !(c >= a[h] && c < b[h])) p = 0.f;
        s[x] = p;
        dp[x] = __fmul_rn(p, __fsub_rn(dp[x], dd(h, c)));
      }
}

// An m64n64 fragment rounded to bf16 as the A operands of four 16-column
// k-steps: y[4kk..4kk + 3] hold columns 16kk.. (fragment groups 2kk and
// 2kk + 1), i.e. x[8kk..8kk + 7] in pairs
__device__ __forceinline__ void pack32(const float (&x)[32],
                                       uint32_t (&y)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) y[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// acc (m64 × DP) += A · B over 64 rows of an MN-major B tile of R rows
// (64-column blocks R·128 bytes apart), A the four k-steps' fragments a
template <int DP>
__device__ __forceinline__ void mma_rs(float (&acc)[DP / 2],
                                       const uint32_t (&a)[16],
                                       uint32_t baddr, int R) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = gmma_desc(baddr + kk * 16 * 128, R * 128, 1024);
    if constexpr (DP == 128)
      wgmma_rs_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                    a[4 * kk + 3], db);
    else
      wgmma_rs_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                   a[4 * kk + 3], db);
  }
}

// s (m64 × n64) = A · Bᵀ over DP columns: A 64 rows of a K-major tile
// (64-column blocks ra bytes apart), B a K-major tile of 64 rows (blocks rb
// bytes apart)
template <int DP>
__device__ __forceinline__ void mma_ss(float (&s)[32], uint32_t aaddr,
                                       uint32_t ra, uint32_t baddr,
                                       uint32_t rb) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(s, gmma_desc(aaddr + (kk >> 2) * ra + (kk & 3) * 32, 16,
                              1024),
                 gmma_desc(baddr + (kk >> 2) * rb + (kk & 3) * 32, 16, 1024),
                 kk > 0);
}

template <int DP>
constexpr size_t dkdv_bf16_smem_bytes() {
  // 1,024 bytes of slack to align the swizzled tiles, K and V, the Q and dO
  // ring, the rows' −lse·log2 e and D a stage, a full and an empty barrier
  // a stage and the K/V barrier
  return 1024 + (size_t)2 * kBKV * DP * 2 +
         (size_t)kStages * 2 * kBQ * DP * 2 + (size_t)kStages * 2 * kBQ * 4 +
         (size_t)(2 * kStages + 1) * 8;
}

template <int DP>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_attention_bwd_dkdv_bf16_kernel(
        const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap gmap,
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int bhkv, int group, int sq, int sk,
        int d, int causal, int window, int q_offset, float scale, int tma) {
  constexpr int NA = DP / 2;                  // dK, dV floats a thread
  constexpr int KT = kBKV * DP * 2;           // the K or V tile
  constexpr int KBLK = kBKV * 128;            // its 64-column blocks
  constexpr int QT = kBQ * DP * 2;            // a Q or dO tile
  constexpr int QBLK = kBQ * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + KT;
  uint8_t* Qs = Vs + KT;                      // [kStages] tiles
  uint8_t* Gs = Qs + kStages * QT;            // [kStages] dO tiles
  float* Ln = reinterpret_cast<float*>(Gs + kStages * QT);  // −lse·log2 e
  float* Dn = Ln + kStages * kBQ;             // D
  uint64_t* full = reinterpret_cast<uint64_t*>(Dn + kStages * kBQ);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x % bhkv;
  const int k0 = (int)(blockIdx.x / bhkv) * kBKV;  // key tile 0 first
  const int nk = min(kBKV, sk - k0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 32);
      mbar_init(smem_u32(empty + s), 256);
    }
    mbar_init(smem_u32(kvbar), 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the query rows that see some key of the tile, from the band's first
  // 64-aligned tile; tile t is query head g = t / nqt, rows i0(t)..
  long long i_begin = 0, i_end = sq;
  if (causal) i_begin = max(0LL, (long long)k0 - q_offset);
  if (window > 0)
    i_end = min(i_end, (long long)k0 + nk - 1 + window - q_offset);
  const long long ifirst = i_begin < i_end ? (i_begin / kBQ) * kBQ : i_end;
  const int nqt = (int)((i_end - ifirst + kBQ - 1) / kBQ);
  const int ntile = group * nqt;

  if (tid >= 256) {
    // producer warpgroup: its registers go to the consumers; its first
    // warp loads K and V, then fills the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid >= 256 + 32) return;
    const int lane = tid - 256;
    const __nv_bfloat16* kh = k + (size_t)hk * sk * d;
    const __nv_bfloat16* vh = v + (size_t)hk * sk * d;
    if (tma) {
      if (lane == 0) {
        const uint32_t bar = smem_u32(kvbar);
        mbar_expect_tx(bar, 2 * KT);
#pragma unroll
        for (int b = 0; b < DP / 64; ++b) {
          tma_load_3d(smem_u32(Ks + b * KBLK), &kmap, bar, 64 * b, k0, hk);
          tma_load_3d(smem_u32(Vs + b * KBLK), &vmap, bar, 64 * b, k0, hk);
        }
      } else {
        mbar_arrive(smem_u32(kvbar));
      }
    } else {
      stage_rows<DP>(Ks, kBKV, nk, d, false, [&](int r) {
        return kh + (size_t)(k0 + r) * d;
      }, lane, 32);
      stage_rows<DP>(Vs, kBKV, nk, d, false, [&](int r) {
        return vh + (size_t)(k0 + r) * d;
      }, lane, 32);
      fence_proxy_async();
      mbar_arrive(smem_u32(kvbar));
    }
    for (int t = 0; t < ntile; ++t) {
      const int s = t % kStages, n = t / kStages;
      if (n > 0) mbar_wait(smem_u32(empty + s), (n - 1) & 1);
      const int h = hk * group + t / nqt;
      const int i0 = (int)(ifirst + (long long)(t % nqt) * kBQ);
      const size_t row0 = (size_t)h * sq + i0;
      for (int c = lane; c < kBQ; c += 32) {
        const bool in = i0 + c < sq;
        Ln[s * kBQ + c] = in ? __fmul_rn(-lse[row0 + c], kLog2e) : 0.f;
        Dn[s * kBQ + c] = in ? delta[row0 + c] : 0.f;
      }
      uint8_t* qt = Qs + s * QT;
      uint8_t* gt = Gs + s * QT;
      if (tma) {
        if (lane == 0) {
          const uint32_t bar = smem_u32(full + s);
          mbar_expect_tx(bar, 2 * QT);
#pragma unroll
          for (int b = 0; b < DP / 64; ++b) {
            tma_load_3d(smem_u32(qt + b * QBLK), &qmap, bar, 64 * b, i0, h);
            tma_load_3d(smem_u32(gt + b * QBLK), &gmap, bar, 64 * b, i0, h);
          }
        } else {
          mbar_arrive(smem_u32(full + s));
        }
      } else {
        const int nq = min(kBQ, sq - i0);
        stage_rows<DP>(qt, kBQ, nq, d, false, [&](int r) {
          return q + (row0 + r) * d;
        }, lane, 32);
        stage_rows<DP>(gt, kBQ, nq, d, false, [&](int r) {
          return dout + (row0 + r) * d;
        }, lane, 32);
        fence_proxy_async();
        mbar_arrive(smem_u32(full + s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumer warpgroup wg: keys wg·64.. of the tile. In an m64nN fragment
  // a thread holds rows (keys) kl[0] = wg·64 + 16·warp + lane/4 and
  // kl[0] + 8; element 4j + 2h + e is row h, column 8j + 2·(lane mod 4) + e
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane & 3;
  long long kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    kpos[h] = (long long)k0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
  float dka[NA], dva[NA], sT[32], dpT[32];
#pragma unroll
  for (int x = 0; x < NA; ++x) dka[x] = dva[x] = 0.f;
#pragma unroll
  for (int x = 0; x < 32; ++x) sT[x] = dpT[x] = 0.f;
  uint32_t pa[16], sa[16];
  const uint32_t kaddr = smem_u32(Ks) + wg * 64 * 128;
  const uint32_t vaddr = smem_u32(Vs) + wg * 64 * 128;
  const float sl2 = __fmul_rn(scale, kLog2e);
  mbar_wait(smem_u32(kvbar), 0);

  for (int t = 0; t < ntile; ++t) {
    const int s = t % kStages;
    const long long i0 = ifirst + (long long)(t % nqt) * kBQ;
    mbar_wait(smem_u32(full + s), (t / kStages) & 1);
    const uint32_t qaddr = smem_u32(Qs + s * QT);
    const uint32_t gaddr = smem_u32(Gs + s * QT);
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
    fence_regs(sT);
    fence_regs(dpT);
    wgmma_fence();
    mma_ss<DP>(sT, kaddr, KBLK, qaddr, QBLK);
    mma_ss<DP>(dpT, vaddr, KBLK, gaddr, QBLK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    // the tile's queries each key sees: causal c >= kpos − q_offset − i0,
    // window c < that + window, c < Sq − i0; none for a key past Sk
    long long lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long base = kpos[h] - q_offset - i0;
      lo[h] = causal ? base : 0;
      hi[h] = min((long long)sq - i0,
                  window > 0 ? base + window : (long long)kBQ);
      if (kpos[h] >= sk) hi[h] = 0;
    }
    int a[2], b[2];
    const float* ln = Ln + s * kBQ + 2 * quad;
    const float* dn = Dn + s * kBQ + 2 * quad;
    auto nl = [&](int, int c) { return ln[c]; };
    auto dd = [&](int, int c) { return dn[c]; };
    if (band(lo, hi, kBQ, quad, a, b))
      p_ds<false>(sT, dpT, a, b, sl2, nl, dd);
    else
      p_ds<true>(sT, dpT, a, b, sl2, nl, dd);
    pack32(sT, pa);
    pack32(dpT, sa);
    // dV += pᵀ·dO, dK += dSᵀ·Q
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(sa);
    wgmma_fence();
    mma_rs<DP>(dva, pa, gaddr, kBQ);
    mma_rs<DP>(dka, sa, qaddr, kBQ);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(sa);
    mbar_arrive(smem_u32(empty + s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= sk) continue;
    const size_t row = ((size_t)hk * sk + kpos[h]) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * quad + e;
        if (col < d) {
          dk[row + col] = __float2bfloat16(__fmul_rn(dka[4 * j + 2 * h + e],
                                                     scale));
          dv[row + col] = __float2bfloat16(dva[4 * j + 2 * h + e]);
        }
      }
  }
}

template <int DP>
constexpr size_t dq_bf16_smem_bytes() {
  // 1,024 bytes of slack, Q and dO, the K/V ring, a full and an empty
  // barrier a stage
  return 1024 + (size_t)2 * kRowsQ * DP * 2 +
         (size_t)kStages * 2 * kBKQ * DP * 2 + (size_t)kStages * 2 * 8;
}

template <int DP>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_attention_bwd_dq_bf16_kernel(
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
        int bhkv, int group, int sq, int sk, int d, int causal, int window,
        int q_offset, float scale, int ntiles, int tma, int qvec) {
  constexpr int NA = DP / 2;                  // dQ floats a thread
  constexpr int KT = kBKQ * DP * 2;           // a K or V tile
  constexpr int KBLK = kBKQ * 128;            // its 64-column blocks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Gs = Qs + kRowsQ * DP * 2;         // dO
  uint8_t* Ks = Gs + kRowsQ * DP * 2;         // [kStages] tiles
  uint8_t* Vs = Ks + kStages * KT;            // [kStages] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * KT);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x % bhkv;
  // the heaviest row tiles (the causal band's end) first
  const int tile = ntiles - 1 - (int)(blockIdx.x / bhkv);
  const int r0 = tile * kRowsQ;       // sq·group < 2^31 (the launcher checks)
  const int nrows = min(kRowsQ, sq * group - r0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), tma ? 1 : 32);
      mbar_init(smem_u32(empty + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the band of keys some row of this tile sees, from its first 64-aligned
  // tile
  const int i_lo = r0 / group;
  const int i_hi = (r0 + nrows - 1) / group;
  long long k_begin = 0, k_end = sk;
  if (causal) k_end = min(k_end, (long long)i_hi + q_offset + 1);
  if (window > 0)
    k_begin = max(k_begin, (long long)i_lo + q_offset - window + 1);
  const long long kfirst = k_begin < k_end ? (k_begin / kBKQ) * kBKQ : k_end;
  const int ntile = (int)((k_end - kfirst + kBKQ - 1) / kBKQ);

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid >= 256 + 32) return;
    const int lane = tid - 256;
    const __nv_bfloat16* kh = k + (size_t)hk * sk * d;
    const __nv_bfloat16* vh = v + (size_t)hk * sk * d;
    for (int t = 0; t < ntile; ++t) {
      const int s = t % kStages, n = t / kStages;
      const long long kb = kfirst + (long long)t * kBKQ;
      if (n > 0) mbar_wait(smem_u32(empty + s), (n - 1) & 1);
      uint8_t* kt = Ks + s * KT;
      uint8_t* vt = Vs + s * KT;
      if (tma) {
        if (lane == 0) {
          const uint32_t bar = smem_u32(full + s);
          mbar_expect_tx(bar, 2 * KT);
#pragma unroll
          for (int b = 0; b < DP / 64; ++b) {
            tma_load_3d(smem_u32(kt + b * KBLK), &kmap, bar, 64 * b, (int)kb,
                        hk);
            tma_load_3d(smem_u32(vt + b * KBLK), &vmap, bar, 64 * b, (int)kb,
                        hk);
          }
        }
      } else {
        const int nk = (int)min((long long)kBKQ, (long long)sk - kb);
        stage_rows<DP>(kt, kBKQ, nk, d, false, [&](int r) {
          return kh + (size_t)(kb + r) * d;
        }, lane, 32);
        stage_rows<DP>(vt, kBKQ, nk, d, false, [&](int r) {
          return vh + (size_t)(kb + r) * d;
        }, lane, 32);
        fence_proxy_async();
        mbar_arrive(smem_u32(full + s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumer warpgroup wg: rows wg·64.. of the tile; a thread holds rows
  // rl[0] = wg·64 + 16·warp + lane/4 and rl[0] + 8 of each fragment
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane & 3;
  long long lo[2], hi[2];             // a row's visible keys [lo, hi)
  float nlr[2], dr[2];                // its −lse·log2 e and D
  size_t orow[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    const int i = (r0 + rl) / group, g = (r0 + rl) % group;
    const long long qpos = (long long)i + q_offset;
    valid[h] = rl < nrows;
    lo[h] = window > 0 ? max(0LL, qpos - window + 1) : 0;
    hi[h] = causal ? min((long long)sk, qpos + 1) : (long long)sk;
    if (!valid[h]) hi[h] = 0;
    orow[h] = ((size_t)hk * group + g) * sq + i;
    nlr[h] = valid[h] ? __fmul_rn(-lse[orow[h]], kLog2e) : 0.f;
    dr[h] = valid[h] ? delta[orow[h]] : 0.f;
  }
  float dqa[NA], sc[32], dpc[32];
#pragma unroll
  for (int x = 0; x < NA; ++x) dqa[x] = 0.f;
#pragma unroll
  for (int x = 0; x < 32; ++x) sc[x] = dpc[x] = 0.f;
  uint32_t sa[16];
  const uint32_t qaddr = smem_u32(Qs) + wg * 64 * 128;
  const uint32_t gaddr = smem_u32(Gs) + wg * 64 * 128;
  const float sl2 = __fmul_rn(scale, kLog2e);
  // Q and dO, while the producer starts on the ring; then a barrier of the
  // consumer warps alone (named barrier 1)
  auto qrow = [&](int r) {
    const int i = (r0 + r) / group, g = (r0 + r) % group;
    return (((size_t)hk * group + g) * sq + i) * d;
  };
  stage_rows<DP>(Qs, kRowsQ, nrows, d, qvec != 0,
                 [&](int r) { return q + qrow(r); }, tid, 256);
  stage_rows<DP>(Gs, kRowsQ, nrows, d, qvec != 0,
                 [&](int r) { return dout + qrow(r); }, tid, 256);
  fence_proxy_async();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  for (int t = 0; t < ntile; ++t) {
    const int s = t % kStages;
    const long long kb = kfirst + (long long)t * kBKQ;
    mbar_wait(smem_u32(full + s), (t / kStages) & 1);
    const uint32_t kaddr = smem_u32(Ks + s * KT);
    const uint32_t vaddr = smem_u32(Vs + s * KT);
    // S = Q·Kᵀ and dP = dO·Vᵀ
    fence_regs(sc);
    fence_regs(dpc);
    wgmma_fence();
    mma_ss<DP>(sc, qaddr, kRowsQ * 128, kaddr, KBLK);
    mma_ss<DP>(dpc, gaddr, kRowsQ * 128, vaddr, KBLK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dpc);
    long long lt[2], ht[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lt[h] = lo[h] - kb;
      ht[h] = hi[h] - kb;
    }
    int a[2], b[2];
    auto nl = [&](int h, int) { return nlr[h]; };
    auto dd = [&](int h, int) { return dr[h]; };
    if (band(lt, ht, kBKQ, quad, a, b))
      p_ds<false>(sc, dpc, a, b, sl2, nl, dd);
    else
      p_ds<true>(sc, dpc, a, b, sl2, nl, dd);
    pack32(dpc, sa);
    // dQ += dS·K
    fence_regs(dqa);
    fence_regs(sa);
    wgmma_fence();
    mma_rs<DP>(dqa, sa, kaddr, kBKQ);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(sa);
    mbar_arrive(smem_u32(empty + s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    __nv_bfloat16* out = dq + orow[h] * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * quad + e;
        if (col < d)
          out[col] = __float2bfloat16(__fmul_rn(dqa[4 * j + 2 * h + e],
                                                scale));
      }
  }
}

// D = rowsum(dO ∘ o) of `rows` rows into delta; variant DP·10 + (T is bf16)
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         long long rows, int d, int variant,
                         cudaStream_t stream) {
  const long long grid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kdelta = flash_attention_bwd_delta_kernel<T>;
  launch_log::record("flash_attention_bwd_delta_kernel", variant,
                     reinterpret_cast<const void*>(kdelta), grid, kThreads,
                     0);
  kdelta<<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int bhkv,
                       int group, int sq, int sk, int d, int causal,
                       int window, int q_offset, float scale,
                       cudaStream_t stream) {
  using T = float;
  const long long bh = (long long)bhkv * group;
  const long long kv_tiles = (sk + kB - 1) / kB;
  const long long q_tiles = (sq + kB - 1) / kB;
  const long long grid_dkdv = (long long)bhkv * kv_tiles;
  const long long grid_dq = bh * q_tiles;
  if (grid_dkdv > 0x7fffffffLL || grid_dq > 0x7fffffffLL ||
      (long long)sk + kB > 0x7fffffffLL || (long long)sq + kB > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const int variant = DP * 10;        // DP·10 + (T is bf16)
  cudaError_t err = launch_delta<T>(o, dout, delta, bh * sq, d, variant,
                                    stream);
  if (err != cudaSuccess) return err;

  auto kdkdv = flash_attention_bwd_dkdv_kernel<T, DP>;
  constexpr size_t smem_kv = dkdv_smem_bytes<DP>();
  err = launch_log::optin_smem(reinterpret_cast<const void*>(kdkdv),
                               (long long)smem_kv);
  if (err != cudaSuccess) return err;
  launch_log::record("flash_attention_bwd_dkdv_kernel", variant,
                     reinterpret_cast<const void*>(kdkdv), grid_dkdv,
                     kThreads, smem_kv);
  kdkdv<<<(unsigned)grid_dkdv, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), group, sq, sk, d, causal,
      window, q_offset, scale, (int)kv_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = flash_attention_bwd_dq_kernel<T, DP>;
  constexpr size_t smem_q = dq_smem_bytes<DP>();
  err = launch_log::optin_smem(reinterpret_cast<const void*>(kdq),
                               (long long)smem_q);
  if (err != cudaSuccess) return err;
  launch_log::record("flash_attention_bwd_dq_kernel", variant,
                     reinterpret_cast<const void*>(kdq), grid_dq, kThreads,
                     smem_q);
  kdq<<<(unsigned)grid_dq, kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), group, sq, sk, d, causal, window, q_offset, scale,
      (int)q_tiles);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int bhkv,
                        int group, int sq, int sk, int d, int causal,
                        int window, int q_offset, float scale,
                        cudaStream_t stream) {
  using T = __nv_bfloat16;
  const long long bh = (long long)bhkv * group;
  const long long rows = bh * sq;
  const long long kv_tiles = (sk + kBKV - 1) / kBKV;
  const long long q_rows = (long long)sq * group;
  const long long q_tiles = (q_rows + kRowsQ - 1) / kRowsQ;
  const long long grid_dkdv = (long long)bhkv * kv_tiles;
  const long long grid_dq = (long long)bhkv * q_tiles;
  if (grid_dkdv > 0x7fffffffLL || grid_dq > 0x7fffffffLL ||
      q_rows > 0x7fffffffLL - kRowsQ || bh > 0x7fffffffLL ||
      (long long)sk + kBKV > 0x7fffffffLL ||
      (long long)sq + kBQ > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_delta<T>(o, dout, delta, rows, d, DP * 10 + 1,
                                    stream);
  if (err != cudaSuccess) return err;

  // TMA where every row is a whole number of aligned 16 bytes: the dkdv
  // kernel's Q, dO, K and V, the dq kernel's K and V (its Q and dO rows
  // r = i·G + g are not one box: cp.async when aligned)
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  const uintptr_t qg = reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(dout);
  const int tma_kv = d % 8 == 0 && kv % 16 == 0;
  const int tma_all = tma_kv && qg % 16 == 0;
  CUtensorMap maps[6];                // Q, dO, K, V (dkdv); K, V (dq)
  memset(maps, 0, sizeof(maps));
  CUtensorMap &qmap = maps[0], &gmap = maps[1], &kmap = maps[2],
              &vmap = maps[3], &kmap_q = maps[4], &vmap_q = maps[5];
  if (tma_all) {
    err = tma_map_3d(&qmap, q, (int)bh, sq, d, kBQ);
    if (err == cudaSuccess)
      err = tma_map_3d(&gmap, dout, (int)bh, sq, d, kBQ);
    if (err == cudaSuccess) err = tma_map_3d(&kmap, k, bhkv, sk, d, kBKV);
    if (err == cudaSuccess) err = tma_map_3d(&vmap, v, bhkv, sk, d, kBKV);
    if (err != cudaSuccess) return err;
  }
  if (tma_kv) {
    err = tma_map_3d(&kmap_q, k, bhkv, sk, d, kBKQ);
    if (err == cudaSuccess) err = tma_map_3d(&vmap_q, v, bhkv, sk, d, kBKQ);
    if (err != cudaSuccess) return err;
  }
  const int variant = 20000 + kStages * 1000 + DP;  // as the forward's

  auto kdkdv = flash_attention_bwd_dkdv_bf16_kernel<DP>;
  constexpr size_t smem_kv = dkdv_bf16_smem_bytes<DP>();
  err = launch_log::optin_smem(reinterpret_cast<const void*>(kdkdv),
                               (long long)smem_kv);
  if (err != cudaSuccess) return err;
  launch_log::record("flash_attention_bwd_dkdv_bf16_kernel", variant,
                     reinterpret_cast<const void*>(kdkdv), grid_dkdv,
                     kThreadsBf16, smem_kv);
  kdkdv<<<(unsigned)grid_dkdv, kThreadsBf16, smem_kv, stream>>>(
      qmap, gmap, kmap, vmap, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), bhkv, group, sq, sk, d, causal, window, q_offset,
      scale, tma_all);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = flash_attention_bwd_dq_bf16_kernel<DP>;
  constexpr size_t smem_q = dq_bf16_smem_bytes<DP>();
  err = launch_log::optin_smem(reinterpret_cast<const void*>(kdq),
                               (long long)smem_q);
  if (err != cudaSuccess) return err;
  const int qvec = d % 8 == 0 && qg % 16 == 0;
  launch_log::record("flash_attention_bwd_dq_bf16_kernel", variant,
                     reinterpret_cast<const void*>(kdq), grid_dq,
                     kThreadsBf16, smem_q);
  kdq<<<(unsigned)grid_dq, kThreadsBf16, smem_q, stream>>>(
      kmap_q, vmap_q, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), bhkv, group, sq, sk, d, causal, window, q_offset,
      scale, (int)q_tiles, tma_kv, qvec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Three launches on `stream` (not synchronised): dq (bhkv·group, sq, d) and
// dk, dv (bhkv, sk, d) of attention(q, k, v) at o with output gradient
// dout, from the forward's float32 lse (bhkv·group, sq); `delta` is a
// float32 (bhkv·group, sq) scratch. All contiguous, q's type float32
// (bf16 = 0) or bfloat16 (bf16 = 1), 1 <= d <= 128, sq >= 1, sk >= 1;
// causal 0/1, window <= 0 for none. Returns a cudaError_t (0 = every launch
// was accepted).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int bhkv, int group,
                               int sq, int sk, int d, int causal, int window,
                               int q_offset, float scale, int bf16,
                               void* stream) {
  if (d < 1 || d > 128 || sq < 1 || sk < 1 || bhkv < 1 || group < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (bf16) {
    if (d <= 64)
      return launch_bf16<64>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv,
                             bhkv, group, sq, sk, d, causal, window,
                             q_offset, scale, st);
    return launch_bf16<128>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv,
                            bhkv, group, sq, sk, d, causal, window, q_offset,
                            scale, st);
  }
  if (d <= 32)
    return launch_f32<32>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bhkv,
                          group, sq, sk, d, causal, window, q_offset, scale,
                          st);
  if (d <= 64)
    return launch_f32<64>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bhkv,
                          group, sq, sk, d, causal, window, q_offset, scale,
                          st);
  return launch_f32<128>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bhkv,
                         group, sq, sk, d, causal, window, q_offset, scale,
                         st);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_QUERY(flash_attention_bwd_delta_kernel)
LAUNCH_LOG_QUERY(flash_attention_bwd_dkdv_kernel)
LAUNCH_LOG_QUERY(flash_attention_bwd_dq_kernel)
LAUNCH_LOG_QUERY(flash_attention_bwd_dkdv_bf16_kernel)
LAUNCH_LOG_QUERY(flash_attention_bwd_dq_bf16_kernel)
LAUNCH_LOG_LIBRARY(flash_attention_bwd)
