// Scheduled (active-set) column-serial Gauss-Seidel IEM sweep (paper §3.1)
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/scheduled_sweep.py::scheduled_sweep_pallas
// of the JAX package. The sweep of gs_sweep.cu restricted to each word's A
// active topics (word_topics, (W_s, A), distinct ids per row) and to the
// tokens the λ_w word mask keeps (token_active). For an active token, on its
// word's A lanes:
//
//   ex    = x·μ_old;  num = (max(θ̂−ex,0)+α−1)(max(φ̂_w−ex,0)+β−1)/(φ̂(k)−ex+wb)
//   μ_new = num / Σ_A num · Σ_A μ_old                  (eq. 38 partial renorm)
//   Δ     = x·(μ_new − μ_old);  res = |Δ|               (eq. 36 replacement)
//
// Every other (token, topic) entry keeps μ_old and carries a zero residual;
// an inactive token changes nothing. The fold of sweep_common.cuh lands Δ
// before the next column, as in the dense sweep.
//
// Bound on this card: device-memory bytes. The outputs are full-K, as the
// reference's SweepResult is: μ_new and the residual (2·D·L·K floats) are
// written once and μ read once, 15.7 GB at the stream_1k width, ≈ 4.7 ms at
// 3.35 TB/s; the active-set arithmetic (A = 16 of K = 10^4 lanes) is
// negligible beside it. μ is not updated in place: each token's μ row is
// copied to μ_new (and its residual row zeroed) once per sweep, then its A
// active lanes are overwritten.
//
// Design. The TPU kernel expanded each word's A ids into a (D, K) lane mask
// and ran masked full-K arithmetic (A lanes cost what 128 cost in a vector
// register). Here an E-step CTA per document copies the token's rows, then
// computes on the A active lanes only, gathering θ̂, φ̂_w, φ̂(k) and μ_old at
// the word's topic ids; the two eq. 38 sums are fixed-order block
// reductions. Δ goes to a compact (D, A) scratch for the φ̂-row fold (the
// documents of one segment share a word and so its active set) and to a
// (D, K) scratch, zero off the active lanes, for the φ̂(k) fold, which zeroes
// it again as it reads. What the design does about the bound: nothing yet
// beyond reading μ once per sweep. Compact (D, L, A) outputs in place of
// full-K ones would cut the bytes ~600×; that changes the contract and is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::block_sum;
using sweep::kThreads;

__global__ void __launch_bounds__(kThreads)
    sched_estep_kernel(const int* __restrict__ word_ids,
                       const float* __restrict__ counts,
                       const uint8_t* __restrict__ token_active,
                       const float* __restrict__ mu_in,
                       float* __restrict__ mu_out,
                       float* __restrict__ res_out,
                       float* __restrict__ theta,
                       const float* __restrict__ phi,
                       const float* __restrict__ phi_k,
                       const int* __restrict__ word_topics, int A,
                       float* __restrict__ delta,
                       float* __restrict__ compact, int L, int l, int K,
                       float alpha_m1, float beta_m1, float wb) {
  __shared__ float red[33];
  const int d = blockIdx.x;
  const size_t tok = (size_t)d * L + l;
  const float* mo = mu_in + tok * K;
  float* mn = mu_out + tok * K;
  float* rs = res_out + tok * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    mn[k] = mo[k];
    rs[k] = 0.f;
  }
  if (!token_active[tok]) return;  // uniform across the CTA
  __syncthreads();  // the copy lands before the active lanes are rewritten

  const float c = counts[tok];
  const int w = word_ids[tok];
  const int* top = word_topics + (size_t)w * A;
  const float* row = phi + (size_t)w * K;
  float* th = theta + (size_t)d * K;
  float* cp = compact + (size_t)d * A;
  float ns = 0.f;  // Σ_A num
  float pm = 0.f;  // Σ_A μ_old: the active set's previous mass
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int k = top[a];
    const float m0 = mo[k];
    const float ex = __fmul_rn(c, m0);
    const float t = fmaxf(__fsub_rn(th[k], ex), 0.f);
    const float p = fmaxf(__fsub_rn(row[k], ex), 0.f);
    const float q = __fsub_rn(phi_k[k], ex);
    const float num = __fdiv_rn(
        __fmul_rn(__fadd_rn(t, alpha_m1), __fadd_rn(p, beta_m1)),
        __fadd_rn(q, wb));
    cp[a] = num;  // staged; read back below by this same thread
    ns = __fadd_rn(ns, num);
    pm = __fadd_rn(pm, m0);
  }
  ns = fmaxf(block_sum(ns, red), 1e-30f);
  pm = block_sum(pm, red);
  // Δ of a zero-count token is exactly zero: it neither changes θ̂ nor
  // enters the fold (its μ still moves, as in the reference).
  const bool live = c != 0.f;
  float* dd = delta + (size_t)d * K;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int k = top[a];
    const float m0 = mo[k];
    const float mu = __fmul_rn(__fdiv_rn(cp[a], ns), pm);
    const float dl = __fmul_rn(c, __fsub_rn(mu, m0));
    mn[k] = mu;
    rs[k] = fabsf(dl);
    if (live) {
      th[k] = __fadd_rn(th[k], dl);
      cp[a] = dl;
      dd[k] = dl;
    }
  }
}

}  // namespace

extern "C" {

// One scheduled sweep on `stream` (2L launches, +1 with tok_ll). theta, phi
// and phi_k are updated in place; mu_out and res_out are (D, L, K).
// token_active is (D, L) bytes; live is (D, L) bytes (token active and
// count ≠ 0); order and the lead_* arrays are (L, D) over the live tokens
// (see sweep_fold_kernel). delta is a (D, K) scratch that must be all zero
// on entry (it is all zero again on return); compact is a (D, A) scratch.
// tok_ll == NULL skips the stop-rule phase. Returns the first nonzero
// cudaGetLastError() (0 = every launch was accepted).
int scheduled_sweep_launch(const void* word_ids, const void* counts,
                           const void* token_active, const void* mu_in,
                           void* mu_out, void* res_out, void* theta,
                           void* phi, void* phi_k, const void* word_topics,
                           int A, const void* order, const void* lead_pos,
                           const void* lead_end, const void* lead_word,
                           const void* live, void* delta, void* compact,
                           void* tok_ll, int D, int L, int K, float alpha_m1,
                           float beta_m1, float wb, float k_alpha,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* wid = static_cast<const int*>(word_ids);
  const float* cnt = static_cast<const float*>(counts);
  const int* wt = static_cast<const int*>(word_topics);
  float* th = static_cast<float*>(theta);
  float* ph = static_cast<float*>(phi);
  float* pk = static_cast<float*>(phi_k);
  float* dl = static_cast<float*>(delta);
  float* cp = static_cast<float*>(compact);
  for (int l = 0; l < L; ++l) {
    sched_estep_kernel<<<D, kThreads, 0, st>>>(
        wid, cnt, static_cast<const uint8_t*>(token_active),
        static_cast<const float*>(mu_in), static_cast<float*>(mu_out),
        static_cast<float*>(res_out), th, ph, pk, wt, A, dl, cp, L, l, K,
        alpha_m1, beta_m1, wb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = sweep::launch_fold<true, true>(
        static_cast<const int*>(order), static_cast<const int*>(lead_pos),
        static_cast<const int*>(lead_end), static_cast<const int*>(lead_word),
        static_cast<const uint8_t*>(live), L, l, dl, cp, wt, A, ph, pk, D, K,
        st);
    if (err != cudaSuccess) return err;
  }
  if (tok_ll != nullptr)
    return sweep::launch_loglik(wid, cnt, th, ph, pk,
                                static_cast<float*>(tok_ll), D, L, K,
                                alpha_m1, beta_m1, wb, k_alpha, st);
  return cudaSuccess;
}

const char* scheduled_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
