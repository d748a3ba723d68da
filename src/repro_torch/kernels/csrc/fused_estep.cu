// Fused E-step over (tokens × topics) rows for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/foem_estep.py::fused_estep_pallas of the
// JAX package. For every token row t, over all K topics:
//
//   th  = max(θ̂_t − ex_t, 0),  ph = max(φ̂_t − ex_t, 0),  pt = φ̂(k) − ex_t
//   num = (th + α−1)(ph + β−1)/(pt + W(β−1))            (eq. 11 / eq. 13)
//   μ_t = num / max(Σ_k num, 1e-30)
//   res = x_t·|μ_t − μ_old,t|                           (eq. 36 residual)
//
// ex (the eq. 13 self-exclusion x·μ_old) is optional, as the TPU kernel's
// use_exclude: without it the three subtractions drop out (BEM, SEM). The
// residual is optional too: without μ_old nothing is read or written for it
// (the trainer's callers use μ alone). θ̂ comes either as (T, K) rows or
// as (T/G, K) rows of G consecutive tokens each — a document's θ̂ under its
// blk (blocked sweep) or L (BEM, SEM) token slots — so no (T, K) copy of θ̂
// is ever made. W(β−1) is a runtime float: the live vocabulary size
// can change between calls.
//
// Bound on this card: device-memory bytes. At the stream_1k width (K = 10^4)
// a blocked sweep's block (T = D·blk = 16,384 with iem_blocks = 8) reads
// φ̂ rows and ex and writes μ, 3 × 655 MB (≈ 0.60 ms at 3.35 TB/s; with
// μ_old in and the residual out 5 slabs, ≈ 0.99 ms), against ≈ 12 float32
// operations per entry (≈ 0.03 ms). SEM's own call (T = D·L = 131,072, no
// ex, no residual) reads the φ̂ rows and writes μ: 2 × 5.24 GB, ≈ 3.1 ms.
// θ̂ (one row per G tokens) and φ̂(k) are small and shared: they come from
// L2. The arithmetic (two IEEE divisions per entry) is ≈ 0.3 of the bytes'
// time at SEM's shape, so every byte has to be in flight early.
//
// Design, register path (K ≤ kRegThreads·4·kGroups = 10,240): one CTA of
// 512 threads per token row, two CTAs resident on an SM (64 registers a
// thread), T CTAs in a row-major grid. Thread i owns the kGroups = 5
// four-lane groups g = i, i + 512, …:
//   1. it issues all of its streamed loads of the row first — the φ̂ row
//      and ex, 16 bytes a load (__ldcs, evict-first) — so a CTA has its
//      whole row in flight (80 KB with ex) and an SM two rows;
//   2. it reads θ̂ and φ̂(k) through the read-only path (__ldg: shared by
//      G tokens and by every row, they stay in L1/L2), computes the
//      numerators into the registers of step 1 and sums them in lane order;
//      μ_old's loads are issued into the freed ex registers before the
//      reduction, so they travel while it runs;
//   3. one fixed-order block reduction (sweep_common.cuh's block_sum) gives
//      the row's normaliser, and μ (and the residual) are written once, from
//      registers, with streaming stores (__stcs). Nothing is read back.
// Rows in flight come from the two resident CTAs of an SM and from the
// next CTA the scheduler starts as soon as one retires; a persistent grid
// with a register double buffer would need twice the registers, which the
// two-CTA residency does not have. Where K % 4 ≠ 0 or a base is not 16-byte
// aligned the same code reads and writes the lanes one by one (the scalar
// path): the lane→thread map and the summation order are the same, so a
// row's bits do not depend on the path either. The divisions stay IEEE
// (__fdiv_rn), as the reference's. Measured (PERF.md §6, an H100 80GB
// HBM3 at 700 W): 0.67–0.86 of the bytes' rate; what remains is each row's
// reduction bubble between its loads and its stores, which the second
// resident CTA covers only in part (the forms without the residual, whose
// rows are shortest, lose most).
//
// Two-pass path (K > 10,240: bigmodel's K = 5·10^4): one CTA of 256
// threads per row strides over K; the first pass stages the numerators in
// the row's μ output and sums them, the second normalises in place and
// writes the residual (the registers cannot hold the row).
//
// Both paths: every row's sum has a fixed order and no atomics are used, so
// a row's bits depend neither on T nor on its batch-mates, and two launches
// give the same bits. The wrapper (foem_estep.py, estep_path) picks the path
// from K and the operands' alignment.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::block_sum;

constexpr int kRegThreads = 512;     // register path: threads a CTA
constexpr int kGroups = 5;           // 4-lane groups a thread: K <= 10,240
constexpr int kTwoPassThreads = 256;  // two-pass path (wide K)

// Four lanes 4g..4g+3 of `p`; the scalar form masks lanes past K (0).
template <bool kVec, bool kStream>
__device__ __forceinline__ float4 ld4(const float* __restrict__ p, int g,
                                      int K) {
  if constexpr (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p) + g;
    return kStream ? __ldcs(q) : __ldg(q);
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      v[j] = k < K ? (kStream ? __ldcs(p + k) : __ldg(p + k)) : 0.f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kVec>
__device__ __forceinline__ void st4(float* __restrict__ p, int g, int K,
                                    float4 v) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(p) + g, v);
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * g + j < K) __stcs(p + 4 * g + j, a[j]);
  }
}

template <bool kExclude>
__device__ __forceinline__ float numer(float a, float b, float q, float x,
                                       float alpha_m1, float beta_m1,
                                       float wb) {
  if (kExclude) {
    a = __fsub_rn(a, x);
    b = __fsub_rn(b, x);
    q = __fsub_rn(q, x);
  }
  a = fmaxf(a, 0.f);
  b = fmaxf(b, 0.f);
  return __fdiv_rn(__fmul_rn(__fadd_rn(a, alpha_m1), __fadd_rn(b, beta_m1)),
                   __fadd_rn(q, wb));
}

__device__ __forceinline__ float& lane(float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <bool kExclude, bool kResidual, bool kVec>
__global__ void __launch_bounds__(kRegThreads, 2)
    fused_estep_regs(const float* __restrict__ theta,
                     const float* __restrict__ phi_rows,
                     const float* __restrict__ phi_k,
                     const float* __restrict__ exclude,
                     const float* __restrict__ mu_old,
                     const float* __restrict__ counts,
                     float* __restrict__ mu_out, float* __restrict__ res_out,
                     int K, int group, float alpha_m1, float beta_m1,
                     float wb) {
  __shared__ float red[33];
  const size_t t = blockIdx.x;
  const size_t off = t * (size_t)K;
  const float* th = theta + (t / (size_t)group) * K;
  const int groups = (K + 3) >> 2;
  float4 v[kGroups], e[kGroups];
  // 1. the streamed loads of the row, all issued before any is used
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + kRegThreads * i;
    if (g < groups) {
      v[i] = ld4<kVec, true>(phi_rows + off, g, K);
      if (kExclude) e[i] = ld4<kVec, true>(exclude + off, g, K);
    }
  }
  // 2. numerators in place of the φ̂ lanes, summed in lane order
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + kRegThreads * i;
    if (g < groups) {
      const float4 a = ld4<kVec, false>(th, g, K);
      const float4 q = ld4<kVec, false>(phi_k, g, K);
      const float4 x = kExclude ? e[i] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& n = lane(v[i], j);
        n = numer<kExclude>(get(a, j), n, get(q, j), get(x, j), alpha_m1,
                            beta_m1, wb);
        if (kVec || 4 * g + j < K) part = __fadd_rn(part, n);
      }
    }
  }
  if (kResidual) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = threadIdx.x + kRegThreads * i;
      if (g < groups) e[i] = ld4<kVec, true>(mu_old + off, g, K);
    }
  }
  // 3. one reduction, then μ (and the residual) written once
  const float den = fmaxf(block_sum(part, red), 1e-30f);
  const float c = kResidual ? counts[t] : 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + kRegThreads * i;
    if (g < groups) {
      float4 m, r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lane(m, j) = __fdiv_rn(lane(v[i], j), den);
        if (kResidual)
          lane(r, j) = __fmul_rn(c, fabsf(__fsub_rn(get(m, j),
                                                    get(e[i], j))));
      }
      st4<kVec>(mu_out + off, g, K, m);
      if (kResidual) st4<kVec>(res_out + off, g, K, r);
    }
  }
}

template <bool kExclude, bool kResidual>
__global__ void __launch_bounds__(kTwoPassThreads)
    fused_estep_two_pass(const float* __restrict__ theta,
                         const float* __restrict__ phi_rows,
                         const float* __restrict__ phi_k,
                         const float* __restrict__ exclude,
                         const float* __restrict__ mu_old,
                         const float* __restrict__ counts,
                         float* __restrict__ mu_out,
                         float* __restrict__ res_out, int K, int group,
                         float alpha_m1, float beta_m1, float wb) {
  __shared__ float red[33];
  const size_t t = blockIdx.x;
  const float* th = theta + (t / (size_t)group) * K;
  const float* ph = phi_rows + t * K;
  const float* ex = kExclude ? exclude + t * K : nullptr;
  float* mo = mu_out + t * K;
  float part = 0.f;
  for (int k = threadIdx.x; k < K; k += kTwoPassThreads) {
    const float num = numer<kExclude>(th[k], ph[k], phi_k[k],
                                      kExclude ? ex[k] : 0.f, alpha_m1,
                                      beta_m1, wb);
    mo[k] = num;
    part = __fadd_rn(part, num);
  }
  const float den = fmaxf(block_sum(part, red), 1e-30f);
  const float c = kResidual ? counts[t] : 0.f;
  for (int k = threadIdx.x; k < K; k += kTwoPassThreads) {
    const float m = __fdiv_rn(mo[k], den);
    mo[k] = m;
    if (kResidual) {
      const float d = fabsf(__fsub_rn(m, mu_old[t * K + k]));
      res_out[t * K + k] = __fmul_rn(c, d);
    }
  }
}

struct Args {
  const float *th, *ph, *pk, *ex, *mo, *cnt;
  float *mu, *res;
  int K, group;
  float alpha_m1, beta_m1, wb;
};

template <bool kExclude, bool kResidual, bool kVec>
cudaError_t launch_regs(const Args& a, long long T, cudaStream_t st) {
  if (a.K > kGroups * kRegThreads * 4) return cudaErrorInvalidValue;
  launch_log::record(
      "fused_estep_regs",
      (kVec ? 0 : 1) | (kResidual ? 2 : 0) | (kExclude ? 4 : 0),
      reinterpret_cast<const void*>(
          &fused_estep_regs<kExclude, kResidual, kVec>),
      T, kRegThreads, 0);
  fused_estep_regs<kExclude, kResidual, kVec>
      <<<(unsigned)T, kRegThreads, 0, st>>>(a.th, a.ph, a.pk, a.ex, a.mo,
                                            a.cnt, a.mu, a.res, a.K, a.group,
                                            a.alpha_m1, a.beta_m1, a.wb);
  return cudaGetLastError();
}

template <bool kExclude, bool kResidual>
cudaError_t launch(const Args& a, long long T, int path, cudaStream_t st) {
  switch (path) {
    case 0:
      return launch_regs<kExclude, kResidual, true>(a, T, st);
    case 1:
      return launch_regs<kExclude, kResidual, false>(a, T, st);
    case 2:
      launch_log::record(
          "fused_estep_two_pass", (kResidual ? 1 : 0) | (kExclude ? 2 : 0),
          reinterpret_cast<const void*>(
              &fused_estep_two_pass<kExclude, kResidual>),
          T, kTwoPassThreads, 0);
      fused_estep_two_pass<kExclude, kResidual>
          <<<(unsigned)T, kTwoPassThreads, 0, st>>>(
              a.th, a.ph, a.pk, a.ex, a.mo, a.cnt, a.mu, a.res, a.K,
              a.group, a.alpha_m1, a.beta_m1, a.wb);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch over T token rows on `stream` (not synchronised). theta is
// (T/group, K): row t reads θ̂ row t / group. phi_rows, mu_out and (when
// given) exclude, mu_old, res_out are (T, K); phi_k (K); counts (T), read
// only with mu_old. exclude == NULL drops the exclusion; mu_old == NULL
// skips the residual (res_out unused). path: 0 = registers with 16-byte
// loads and stores (K % 4 == 0 and every base 16-byte aligned), 1 =
// registers with scalar lanes, both K <= 10,240; 2 = two-pass.
// 1 <= T <= 2^31 − 1. Returns cudaGetLastError() (0 = the launch was
// accepted).
int fused_estep_launch(const void* theta, const void* phi_rows,
                       const void* phi_k, const void* exclude,
                       const void* mu_old, const void* counts, void* mu_out,
                       void* res_out, long long T, int K, int group,
                       float alpha_m1, float beta_m1, float wb, int path,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(theta),
               static_cast<const float*>(phi_rows),
               static_cast<const float*>(phi_k),
               static_cast<const float*>(exclude),
               static_cast<const float*>(mu_old),
               static_cast<const float*>(counts),
               static_cast<float*>(mu_out),
               static_cast<float*>(res_out),
               K, group, alpha_m1, beta_m1, wb};
  if (a.ex != nullptr && a.mo != nullptr)
    return launch<true, true>(a, T, path, st);
  if (a.ex != nullptr) return launch<true, false>(a, T, path, st);
  if (a.mo != nullptr) return launch<false, true>(a, T, path, st);
  return launch<false, false>(a, T, path, st);
}

const char* fused_estep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_QUERY(fused_estep_regs)
LAUNCH_LOG_QUERY(fused_estep_two_pass)
LAUNCH_LOG_LIBRARY(fused_estep)
