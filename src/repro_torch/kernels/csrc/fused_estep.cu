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
// φ̂ rows, ex and μ_old and writes μ and the residual, 5 × 655 MB, plus θ̂
// (41 MB): ≈ 0.99 ms at 3.35 TB/s against ≈ 12 float32 operations per
// entry (≈ 0.03 ms). SEM's T = D·L = 131,072 rows without ex move
// 4 × 5.24 GB, ≈ 6.3 ms.
//
// Design. One CTA per token row; the threads stride over K (lanes past K,
// K = 10^4 not being a multiple of the CTA, are masked by the loop bound).
// The first pass stages the numerators in the row's μ output and sums them
// per thread in lane order; sweep_common.cuh's block_sum reduces the 256
// partials in a fixed shuffle order, so a row's bits depend neither on T nor
// on its batch-mates and two launches give the same bits. The second pass
// (same thread, same lanes: no barrier needed) normalises in place and
// writes the residual. No atomics, no shared state between CTAs. The TPU
// wrapper's padding of T to the token block has no counterpart: the grid is
// T CTAs. What the design does about the bound: every input is read once,
// coalesced; the second pass re-reads the row's numerators (40 KB at
// K = 10^4) from L1/L2. Wider loads and several rows per CTA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::block_sum;
using sweep::kThreads;

template <bool kExclude, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    fused_estep_kernel(const float* __restrict__ theta,
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
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float a = th[k], b = ph[k], q = phi_k[k];
    if (kExclude) {
      const float x = ex[k];
      a = __fsub_rn(a, x);
      b = __fsub_rn(b, x);
      q = __fsub_rn(q, x);
    }
    a = fmaxf(a, 0.f);
    b = fmaxf(b, 0.f);
    const float num = __fdiv_rn(
        __fmul_rn(__fadd_rn(a, alpha_m1), __fadd_rn(b, beta_m1)),
        __fadd_rn(q, wb));
    mo[k] = num;
    part = __fadd_rn(part, num);
  }
  const float den = fmaxf(block_sum(part, red), 1e-30f);
  const float c = kResidual ? counts[t] : 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float m = __fdiv_rn(mo[k], den);
    mo[k] = m;
    if (kResidual) {
      const float d = fabsf(__fsub_rn(m, mu_old[t * K + k]));
      res_out[t * K + k] = __fmul_rn(c, d);
    }
  }
}

template <bool kExclude, bool kResidual>
cudaError_t launch(const float* th, const float* ph, const float* pk,
                   const float* ex, const float* mo, const float* cnt,
                   float* mu, float* res, long long T, int K, int group,
                   float alpha_m1, float beta_m1, float wb,
                   cudaStream_t st) {
  fused_estep_kernel<kExclude, kResidual>
      <<<(unsigned)T, kThreads, 0, st>>>(th, ph, pk, ex, mo, cnt, mu, res, K,
                                         group, alpha_m1, beta_m1, wb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over T token rows on `stream` (not synchronised). theta is
// (T/group, K): row t reads θ̂ row t / group. phi_rows, mu_out and (when
// given) exclude, mu_old, res_out are (T, K); phi_k (K); counts (T), read
// only with mu_old. exclude == NULL drops the exclusion; mu_old == NULL
// skips the residual (res_out unused). 1 <= T <= 2^31 − 1. Returns
// cudaGetLastError() (0 = the launch was accepted).
int fused_estep_launch(const void* theta, const void* phi_rows,
                       const void* phi_k, const void* exclude,
                       const void* mu_old, const void* counts, void* mu_out,
                       void* res_out, long long T, int K, int group,
                       float alpha_m1, float beta_m1, float wb,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* th = static_cast<const float*>(theta);
  const float* ph = static_cast<const float*>(phi_rows);
  const float* pk = static_cast<const float*>(phi_k);
  const float* ex = static_cast<const float*>(exclude);
  const float* mo = static_cast<const float*>(mu_old);
  const float* cnt = static_cast<const float*>(counts);
  float* mu = static_cast<float*>(mu_out);
  float* res = static_cast<float*>(res_out);
  if (ex != nullptr && mo != nullptr)
    return launch<true, true>(th, ph, pk, ex, mo, cnt, mu, res, T, K, group,
                              alpha_m1, beta_m1, wb, st);
  if (ex != nullptr)
    return launch<true, false>(th, ph, pk, ex, mo, cnt, mu, res, T, K, group,
                               alpha_m1, beta_m1, wb, st);
  if (mo != nullptr)
    return launch<false, true>(th, ph, pk, ex, mo, cnt, mu, res, T, K, group,
                               alpha_m1, beta_m1, wb, st);
  return launch<false, false>(th, ph, pk, ex, mo, cnt, mu, res, T, K, group,
                              alpha_m1, beta_m1, wb, st);
}

const char* fused_estep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
