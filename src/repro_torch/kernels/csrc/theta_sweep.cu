// Frozen-phi theta-only fixed point (paper §2.4) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/theta_sweep.py::theta_sweep_pallas of the
// JAX package. One launch runs `num_sweeps` Jacobi sweeps of
//
//     mu_{w,d}(k) ∝ thn_d(k) · phi_w(k),   thn_d = (theta_d + α−1) / (Σθ_d + K(α−1))
//     theta_d(k)  = Σ_w x^{80%}_{w,d} mu_{w,d}(k)
//
// over the L token columns of each document, then L evaluation columns that
// emit x·log Σ_k thn_d(k) phi_w(k) for both count splits against the final
// theta. phi (W_s, K) arrives normalised (eq. 10) and read-only as f32, bf16,
// or int8 with a per-row f32 scale, dequantised on read; all arithmetic is
// f32. The scheduled variant restricts each token's fit to its word's A
// active topics (word_topics, distinct ids per row); evaluation always uses
// the full support.
//
// Bound: device-memory bytes. Every fit token reads its whole φ row (K values)
// and every evaluation token reads it again: (S+1)·nnz·K·bytes(phi) per
// launch, against ~7 flops per element. The TPU kernel kept phi resident in
// VMEM and ran the grid in order to carry theta; neither carries over.
//
// Design: the work is independent per document, so one CTA owns one
// document for the whole launch (no grid-wide order, no atomics). thn_d, the
// Jacobi fold accumulator and the staged per-token numerators live in
// dynamic shared memory (3·K floats: 120 KB at K = 10^4); when they do not
// fit (K = 5·10^4) the caller passes a global scratch of D·3·K floats and
// the same code runs on it. The normaliser is fixed for a whole sweep
// (Jacobi), so it is computed once per sweep. Per token the φ row is read
// once, coalesced (thread t owns lanes k ≡ t mod blockDim), the numerators
// are staged, and one fixed-order block reduction gives the token's
// normaliser. Every reduction has a fixed order and no atomics are used, so
// results are bitwise repeatable and a document's theta does not depend on
// its batch-mates. Fit columns with zero count add exactly zero and are
// skipped; evaluation columns are skipped only when both splits are zero.
// Speed (L2-aware row order, several documents per CTA, TMA staging) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <typename T>
struct PhiRead;

template <>
struct PhiRead<float> {
  static __device__ __forceinline__ float get(const float* row, int k, float) {
    return row[k];
  }
};

template <>
struct PhiRead<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* row, int k,
                                              float) {
    return __bfloat162float(row[k]);
  }
};

template <>
struct PhiRead<int8_t> {
  // dequantize on read: the same f32 product as dequantize_phi
  static __device__ __forceinline__ float get(const int8_t* row, int k,
                                              float scale) {
    return __fmul_rn(static_cast<float>(row[k]), scale);
  }
};

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

template <typename T, bool kScheduled>
__global__ void __launch_bounds__(kThreads)
    theta_sweep_kernel(const int* __restrict__ word_ids,
                       const float* __restrict__ est,
                       const float* __restrict__ ev,
                       const float* __restrict__ theta_in,
                       const T* __restrict__ phi,
                       const float* __restrict__ phi_scale,
                       const int* __restrict__ word_topics, int A,
                       float* __restrict__ theta_out,
                       float* __restrict__ est_ll, float* __restrict__ ev_ll,
                       float* __restrict__ scratch, int L, int K,
                       int num_sweeps, float alpha_m1, float k_alpha) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* base = scratch != nullptr ? scratch + (size_t)d * 3 * K : smem;
  float* thn = base;          // normalised theta of the sweep (Jacobi)
  float* acc = base + K;      // carried theta / next sweep's fold
  float* num = base + 2 * K;  // staged per-token numerators
  const int* wid = word_ids + (size_t)d * L;
  const float* cnt = est + (size_t)d * L;
  const float* evc = ev + (size_t)d * L;

  for (int k = tid; k < K; k += nt) acc[k] = theta_in[(size_t)d * K + k];

  for (int s = 0; s < num_sweeps; ++s) {
    float part = 0.f;
    for (int k = tid; k < K; k += nt) part = __fadd_rn(part, acc[k]);
    const float den = fmaxf(__fadd_rn(block_sum(part, red), k_alpha), 1e-30f);
    for (int k = tid; k < K; k += nt) {
      thn[k] = __fdiv_rn(__fadd_rn(acc[k], alpha_m1), den);
      acc[k] = 0.f;
    }
    __syncthreads();  // scheduled lanes read thn/acc across threads
    for (int l = 0; l < L; ++l) {
      const float c = cnt[l];
      if (c == 0.f) continue;  // adds exactly zero; uniform across the CTA
      const int w = wid[l];
      const T* row = phi + (size_t)w * K;
      const float sc = phi_scale != nullptr ? phi_scale[w] : 1.f;
      if (!kScheduled) {
        float z = 0.f;
        for (int k = tid; k < K; k += nt) {
          const float v = __fmul_rn(thn[k], PhiRead<T>::get(row, k, sc));
          num[k] = v;
          z = __fadd_rn(z, v);
        }
        z = fmaxf(block_sum(z, red), 1e-30f);
        for (int k = tid; k < K; k += nt)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(c, __fdiv_rn(num[k], z)));
      } else {
        const int* top = word_topics + (size_t)w * A;
        float z = 0.f;
        for (int a = tid; a < A; a += nt) {
          const int t = top[a];
          const float v = __fmul_rn(thn[t], PhiRead<T>::get(row, t, sc));
          num[a] = v;
          z = __fadd_rn(z, v);
        }
        z = fmaxf(block_sum(z, red), 1e-30f);
        for (int a = tid; a < A; a += nt) {
          const int t = top[a];
          acc[t] = __fadd_rn(acc[t], __fmul_rn(c, __fdiv_rn(num[a], z)));
        }
      }
    }
    __syncthreads();  // the fold is complete before the next normaliser
  }

  float part = 0.f;
  for (int k = tid; k < K; k += nt) {
    theta_out[(size_t)d * K + k] = acc[k];
    part = __fadd_rn(part, acc[k]);
  }
  const float den = fmaxf(__fadd_rn(block_sum(part, red), k_alpha), 1e-30f);
  for (int k = tid; k < K; k += nt)
    thn[k] = __fdiv_rn(__fadd_rn(acc[k], alpha_m1), den);

  // eq. 21 phase: full topic support against the final theta
  for (int l = 0; l < L; ++l) {
    const float e = cnt[l];
    const float v = evc[l];
    const size_t o = (size_t)d * L + l;
    if (e == 0.f && v == 0.f) {
      if (tid == 0) {
        est_ll[o] = 0.f;
        ev_ll[o] = 0.f;
      }
      continue;
    }
    const int w = wid[l];
    const T* row = phi + (size_t)w * K;
    const float sc = phi_scale != nullptr ? phi_scale[w] : 1.f;
    float lik = 0.f;
    for (int k = tid; k < K; k += nt)
      lik = __fadd_rn(lik, __fmul_rn(thn[k], PhiRead<T>::get(row, k, sc)));
    const float ll = logf(fmaxf(block_sum(lik, red), 1e-30f));
    if (tid == 0) {
      est_ll[o] = __fmul_rn(e, ll);
      ev_ll[o] = __fmul_rn(v, ll);
    }
  }
}

template <typename T, bool kScheduled>
cudaError_t launch(const void* word_ids, const void* est, const void* ev,
                   const void* theta_in, const void* phi,
                   const void* phi_scale, const void* word_topics, int A,
                   void* theta_out, void* est_ll, void* ev_ll, void* scratch,
                   int D, int L, int K, int num_sweeps, float alpha_m1,
                   float k_alpha, cudaStream_t stream) {
  auto kernel = theta_sweep_kernel<T, kScheduled>;
  const size_t smem = scratch != nullptr ? 0 : (size_t)3 * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<D, kThreads, smem, stream>>>(
      static_cast<const int*>(word_ids), static_cast<const float*>(est),
      static_cast<const float*>(ev), static_cast<const float*>(theta_in),
      static_cast<const T*>(phi), static_cast<const float*>(phi_scale),
      static_cast<const int*>(word_topics), A, static_cast<float*>(theta_out),
      static_cast<float*>(est_ll), static_cast<float*>(ev_ll),
      static_cast<float*>(scratch), L, K, num_sweeps, alpha_m1, k_alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sched(const void* word_ids, const void* est,
                           const void* ev, const void* theta_in,
                           const void* phi, const void* phi_scale,
                           const void* word_topics, int A, void* theta_out,
                           void* est_ll, void* ev_ll, void* scratch, int D,
                           int L, int K, int num_sweeps, float alpha_m1,
                           float k_alpha, cudaStream_t stream) {
  if (word_topics != nullptr)
    return launch<T, true>(word_ids, est, ev, theta_in, phi, phi_scale,
                           word_topics, A, theta_out, est_ll, ev_ll, scratch,
                           D, L, K, num_sweeps, alpha_m1, k_alpha, stream);
  return launch<T, false>(word_ids, est, ev, theta_in, phi, phi_scale,
                          nullptr, 0, theta_out, est_ll, ev_ll, scratch, D, L,
                          K, num_sweeps, alpha_m1, k_alpha, stream);
}

}  // namespace

extern "C" {

// Launch one chunk on `stream`. phi_dtype: 0 = f32, 1 = bf16, 2 = int8
// (phi_scale required). word_topics == NULL selects the dense fit. scratch ==
// NULL keeps the per-document state in shared memory (3·K floats must fit);
// otherwise it is D·3·K floats of device memory. Returns cudaGetLastError()
// after the launch (0 = launched).
int theta_sweep_launch(const void* word_ids, const void* est, const void* ev,
                       const void* theta_in, const void* phi, int phi_dtype,
                       const void* phi_scale, const void* word_topics, int A,
                       void* theta_out, void* est_ll, void* ev_ll,
                       void* scratch, int D, int L, int K, int num_sweeps,
                       float alpha_m1, float k_alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phi_dtype) {
    case 0:
      return dispatch_sched<float>(word_ids, est, ev, theta_in, phi, nullptr,
                                   word_topics, A, theta_out, est_ll, ev_ll,
                                   scratch, D, L, K, num_sweeps, alpha_m1,
                                   k_alpha, s);
    case 1:
      return dispatch_sched<__nv_bfloat16>(
          word_ids, est, ev, theta_in, phi, nullptr, word_topics, A,
          theta_out, est_ll, ev_ll, scratch, D, L, K, num_sweeps, alpha_m1,
          k_alpha, s);
    case 2:
      return dispatch_sched<int8_t>(word_ids, est, ev, theta_in, phi,
                                    phi_scale, word_topics, A, theta_out,
                                    est_ll, ev_ll, scratch, D, L, K,
                                    num_sweeps, alpha_m1, k_alpha, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* theta_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
