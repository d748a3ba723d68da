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
// * delta: D, one warp a row (a fixed butterfly).
// * dkdv: one CTA a (KV head, 64-key tile). K and V stay in shared memory;
//   the CTA walks the G query heads of its KV head and, in each, the query
//   tiles that see some key of its tile (the causal / window band), and
//   accumulates dk and dv for its keys in registers, in one fixed order.
// * dq: one CTA a (query head, 64-row tile); it walks the key tiles of its
//   rows' band, recomputing p and ds, and accumulates dq in registers.
//
// Bound on this card: operations. Danube's training call (32 heads over
// 8, S = 4,096, d = 120, window 4,096) has 2.7e8 visible pairs a call and
// 5 products of 2·d operations a pair, 3.2e11 operations, 0.33 ms at the
// bf16 tensor cores' peak; its inputs and outputs are 0.2 GB, 0.06 ms at
// the memory's rate. This first design computes on the CUDA cores in
// float32 for both types (bf16 inputs are widened in shared memory; dq, dk,
// dv are rounded to the input type once, at the end), and the dq launch
// recomputes p and dp (7 products a pair in all): a simple kernel that is
// right, far from the tensor-core bound. Its design: 64 × 64 tiles in
// shared memory (rows padded by 4 floats, so a warp's float4 reads of 16
// rows fall in distinct banks), 256 threads a CTA, each thread a 4 × 4 block
// of the scores and the dp tile (4 rows × 4 keys, 8 floats read a 16 fmaf)
// and a 4 × DP/16 block of its outputs. wgmma (bf16 operands, float32
// sums), TMA and a dq pass fused into the dkdv CTAs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_log.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;                // query rows and keys a tile
constexpr int kPS = kB + 4;           // row stride of the p / ds tiles
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// the dynamic shared memory attribute of `kernel`, once a device (not
// again: a launch may be captured into a CUDA graph)
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem,
                      bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int bhkv, int group, int sq, int sk,
                   int d, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const long long bh = (long long)bhkv * group;
  const long long rows = bh * sq;
  const long long kv_tiles = (sk + kB - 1) / kB;
  const long long q_tiles = (sq + kB - 1) / kB;
  const long long grid_delta = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long grid_dkdv = (long long)bhkv * kv_tiles;
  const long long grid_dq = bh * q_tiles;
  if (grid_delta > 0x7fffffffLL || grid_dkdv > 0x7fffffffLL ||
      grid_dq > 0x7fffffffLL || (long long)sk + kB > 0x7fffffffLL ||
      (long long)sq + kB > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  // variant: DP·10 + (T is bf16)
  const int variant = DP * 10 + (sizeof(T) == 2 ? 1 : 0);

  auto kdelta = flash_attention_bwd_delta_kernel<T>;
  launch_log::record("flash_attention_bwd_delta_kernel", variant,
                     reinterpret_cast<const void*>(kdelta), grid_delta,
                     kThreads, 0);
  kdelta<<<(unsigned)grid_delta, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdkdv = flash_attention_bwd_dkdv_kernel<T, DP>;
  constexpr size_t smem_kv = dkdv_smem_bytes<DP>();
  static bool conf_kv[kMaxDevices] = {};
  err = configure(kdkdv, smem_kv, conf_kv);
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
  static bool conf_q[kMaxDevices] = {};
  err = configure(kdq, smem_q, conf_q);
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

template <typename T>
cudaError_t launch_dp(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int bhkv,
                      int group, int sq, int sk, int d, int causal,
                      int window, int q_offset, float scale,
                      cudaStream_t st) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhkv,
                         group, sq, sk, d, causal, window, q_offset, scale,
                         st);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhkv,
                         group, sq, sk, d, causal, window, q_offset, scale,
                         st);
  return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhkv, group,
                        sq, sk, d, causal, window, q_offset, scale, st);
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
  if (bf16)
    return launch_dp<__nv_bfloat16>(q, k, v, o, dout, lse_f, delta_f, dq, dk,
                                    dv, bhkv, group, sq, sk, d, causal,
                                    window, q_offset, scale, st);
  return launch_dp<float>(q, k, v, o, dout, lse_f, delta_f, dq, dk, dv, bhkv,
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
LAUNCH_LOG_LIBRARY(flash_attention_bwd)
