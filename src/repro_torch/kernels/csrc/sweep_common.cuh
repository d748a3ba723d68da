// Shared pieces of the training sweep kernels for NVIDIA Hopper (sm_90a):
// gs_sweep.cu, scheduled_sweep.cu and sharded_sweep.cu (their column loops
// are in gs_sweep.cu and sweep_active.cuh), and fused_estep.cu's reduction:
//
//   * warp_sum, block_sum  — fixed-order reductions (no atomics);
//   * ld4, st4, add4       — four lanes 4g..4g+3 of a row at once: one
//                            16-byte access (kVec) or four masked scalar ones
//                            with the same lane map, so a sum over lanes has
//                            the same order, and the same bits, on both;
//   * sweep_loglik_kernel  — the eq. 3 stop-rule phase: per-token data
//                            log-likelihood partials against the final
//                            statistics.
//
// The stop-rule phase. Bound on this card: device-memory bytes, a φ̂ row of
// K floats for every live token (≈ 10^5 tokens × 40 KB at stream_1k: 4.1 GB,
// ≈ 1.2 ms at 3.35 TB/s; frequent words' rows come again from L2), against
// ≈ 2 float32 operations per (token, topic) (≈ 0.1 ms). The design before
// this one walked a document's tokens one after another, one CTA, two block
// barriers a token, with two IEEE divisions per lane and token: 4.2 ms. Now
// one CTA of 512 threads takes a document: it normalises θ̂_d once and
// stages w(k) = (θ̂_d(k)+α−1)/Σθ̂ · 1/max(φ̂(k)+W(β−1), 1e-30) in shared
// memory (K floats), and each of its 16 warps takes a token: its lanes issue
// eight 16-byte row loads before they use them and the warp sums Σ_k w(k)·
// (φ̂_w(k)+β−1) in a fixed shuffle order, with no block barrier. The
// reciprocal 1/max(φ̂(k)+wb, 1e-30) and the product with θ̂'s normalised
// value round twice where the reference divides once: a few float32 ulps a
// term, far inside SWEEP_TOL["loglik"] (rtol 1e-5). Where K floats do not fit
// in shared memory w(k) is computed per token from θ̂ and φ̂(k), the same
// arithmetic and so the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

constexpr int kLoglikThreads = 512;  // stop rule: a document a CTA
constexpr int kLoglikLoads = 8;      // row loads in flight a lane

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block sum; every thread receives the same bits. `red` holds 33
// floats. Two barriers suffice between back-to-back calls: red[0..31] is
// read before the second barrier and rewritten only after it, and red[32] is
// rewritten only after the next call's first barrier, which every thread
// reaches after reading it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ float& lane(float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// How a lane group is read or written: plain (through L1; a generic address,
// so shared memory too), streaming (evict-first: used once), read-only
// (__ldg: not written during the kernel), or through L2 (state other CTAs
// of the launch write).
enum Via { kPlain, kStream, kReadOnly, kL2 };

template <Via kVia>
__device__ __forceinline__ float ld1(const float* p) {
  return kVia == kStream ? __ldcs(p) : kVia == kReadOnly ? __ldg(p)
         : kVia == kL2   ? __ldcg(p) : *p;
}

// Lanes 4g..4g+3 of `p`; the scalar form masks lanes past K (0).
template <bool kVec, Via kVia>
__device__ __forceinline__ float4 ld4(const float* p, int g, int K) {
  if constexpr (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p) + g;
    return kVia == kStream ? __ldcs(q) : kVia == kReadOnly ? __ldg(q)
           : kVia == kL2   ? __ldcg(q) : *q;
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = 4 * g + j < K ? ld1<kVia>(p + 4 * g + j) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kVec, Via kVia>
__device__ __forceinline__ void st4(float* p, int g, int K, float4 v) {
  if constexpr (kVec) {
    float4* q = reinterpret_cast<float4*>(p) + g;
    if (kVia == kStream)
      __stcs(q, v);
    else if (kVia == kL2)
      __stcg(q, v);
    else
      *q = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* q = p + 4 * g + j;
      if (4 * g + j >= K) continue;
      if (kVia == kStream)
        __stcs(q, get(v, j));
      else if (kVia == kL2)
        __stcg(q, get(v, j));
      else
        *q = get(v, j);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// w(k) of the stop rule: θ̂_d(k) normalised (eq. 9) times the reciprocal of
// φ̂'s eq. 10 denominator.
__device__ __forceinline__ float4 loglik_weight(float4 th, float4 pk,
                                                float th_den, float alpha_m1,
                                                float wb) {
  float4 w;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    lane(w, j) = __fmul_rn(
        __fdiv_rn(__fadd_rn(get(th, j), alpha_m1), th_den),
        __frcp_rn(fmaxf(__fadd_rn(get(pk, j), wb), 1e-30f)));
  return w;
}

// eq. 3 data log-likelihood partials against the final statistics:
// tok_ll[d, l] = x_{d,l} · log max(Σ_k θ_d(k) φ_w(k), 1e-30), θ (eq. 9)
// and φ (eq. 10, global W through `wb`) normalised on the fly. Zero-count
// tokens write 0 (the reference's 0 · log(lik)). A CTA a document, a warp a
// token; kVec: 16-byte lanes; kStaged: w(k) in shared memory (4·ceil(K/4)
// floats of dynamic shared memory).
template <bool kVec, bool kStaged>
__global__ void __launch_bounds__(kLoglikThreads, 2)
    sweep_loglik_kernel(const int* __restrict__ word_ids,
                        const float* __restrict__ counts,
                        const float* __restrict__ theta,
                        const float* __restrict__ phi,
                        const float* __restrict__ phi_k,
                        float* __restrict__ tok_ll, int L, int K,
                        float alpha_m1, float beta_m1, float wb,
                        float k_alpha) {
  extern __shared__ float4 w_s4[];
  float* w_s = reinterpret_cast<float*>(w_s4);
  __shared__ float red[33];
  const int d = blockIdx.x;
  const int groups4 = (K + 3) >> 2;
  const float* th = theta + (size_t)d * K;
  float part = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    part = __fadd_rn(part, __ldg(th + k));
  const float th_den =
      fmaxf(__fadd_rn(block_sum(part, red), k_alpha), 1e-30f);
  if (kStaged) {
    for (int g = threadIdx.x; g < groups4; g += blockDim.x)
      st4<kVec, kPlain>(w_s, g, K,
                        loglik_weight(ld4<kVec, kReadOnly>(th, g, K),
                                      ld4<kVec, kReadOnly>(phi_k, g, K),
                                      th_den, alpha_m1, wb));
    __syncthreads();
  }
  const int lane_id = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < L; l += blockDim.x >> 5) {
    const size_t t = (size_t)d * L + l;
    const float c = counts[t];
    if (c == 0.f) {
      if (lane_id == 0) tok_ll[t] = 0.f;
      continue;  // uniform across the warp
    }
    const float* row = phi + (size_t)word_ids[t] * K;
    float acc = 0.f;
    for (int g0 = lane_id; g0 < groups4; g0 += 32 * kLoglikLoads) {
      float4 r[kLoglikLoads];
#pragma unroll
      for (int u = 0; u < kLoglikLoads; ++u) {
        const int g = g0 + 32 * u;
        if (g < groups4) r[u] = ld4<kVec, kReadOnly>(row, g, K);
      }
#pragma unroll
      for (int u = 0; u < kLoglikLoads; ++u) {
        const int g = g0 + 32 * u;
        if (g >= groups4) break;
        const float4 w =
            kStaged ? ld4<kVec, kPlain>(w_s, g, K)
                    : loglik_weight(ld4<kVec, kReadOnly>(th, g, K),
                                    ld4<kVec, kReadOnly>(phi_k, g, K),
                                    th_den, alpha_m1, wb);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kVec || 4 * g + j < K)
            acc = __fmaf_rn(get(w, j), __fadd_rn(get(r[u], j), beta_m1),
                            acc);
      }
    }
    acc = warp_sum(acc);
    if (lane_id == 0) tok_ll[t] = __fmul_rn(c, logf(fmaxf(acc, 1e-30f)));
  }
}

// Launch the stop-rule phase on `stream` (one launch, D > 0); returns the
// first CUDA error. 16-byte lanes where K % 4 = 0 and the bases are
// aligned; w(k) staged in shared memory where K floats fit.
inline cudaError_t launch_loglik(const int* word_ids, const float* counts,
                                 const float* theta, const float* phi,
                                 const float* phi_k, float* tok_ll, int D,
                                 int L, int K, float alpha_m1, float beta_m1,
                                 float wb, float k_alpha,
                                 cudaStream_t stream) {
  const bool vec = K % 4 == 0 && aligned16(theta) && aligned16(phi) &&
                   aligned16(phi_k);
  const size_t smem = sizeof(float) * 4 * ((K + 3) / 4);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const bool staged = smem + 1024 <= static_cast<size_t>(optin);
  auto* kernel = vec ? (staged ? &sweep_loglik_kernel<true, true>
                               : &sweep_loglik_kernel<true, false>)
                     : (staged ? &sweep_loglik_kernel<false, true>
                               : &sweep_loglik_kernel<false, false>);
  if (staged && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<D, kLoglikThreads, staged ? smem : 0, stream>>>(
      word_ids, counts, theta, phi, phi_k, tok_ll, L, K, alpha_m1, beta_m1,
      wb, k_alpha);
  return cudaGetLastError();
}

}  // namespace sweep
