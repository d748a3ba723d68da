// Dense column-serial Gauss-Seidel IEM sweep (paper Fig. 2 at B = L) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/gs_sweep.py::gs_sweep_pallas of the JAX
// package. One call of gs_sweep_launch runs one sweep over the L token
// columns of a (D, L) minibatch. For each column l, in order:
//
//   ex    = x·μ_old                                    (eq. 13 exclusion)
//   μ_new ∝ (max(θ̂−ex,0)+α−1)(max(φ̂_w−ex,0)+β−1)/(φ̂(k)−ex+W(β−1))
//                                                      (eq. 11, over K)
//   res   = x·|μ_new − μ_old|                          (eq. 36 residual)
//   Δ     = x·μ_new − ex;  θ̂_d += Δ;  φ̂_w += Δ;  φ̂(k) += Σ_d Δ
//
// and the fold lands before column l+1 reads the statistics (Gauss-Seidel).
// With a loglik buffer, one more launch emits the eq. 3 per-token partials
// against the final statistics (the training-perplexity stop rule).
//
// Bound on this card: device-memory bytes. The sweep must read μ (D·L·K
// floats) once and write μ_new and the residual (2·D·L·K) once: 15.7 GB at
// the stream_1k width (D = 1024, L = 128, K = 10^4), ≈ 4.7 ms at 3.35 TB/s,
// against ≈ 20 float32 operations per (token, topic), ≈ 0.4 ms. μ is not
// updated in place: μ_new and the residual are new buffers, as the
// reference's are, so a caller may compare or reuse its input.
//
// Design. Per column: an E-step launch with one CTA per document, then the
// fold launch of sweep_common.cuh. The E-step makes two passes over K: the
// first stages the unnormalised numerators in the document's row of the
// (D, K) Δ scratch and reduces them in a fixed order; the second (same
// thread, same lanes) normalises, writes μ_new and the residual, adds Δ into
// θ̂_d in place (a document owns its θ̂ row) and leaves Δ in the scratch for
// the fold. Documents are Jacobi within a column (they read φ̂ and φ̂(k) as
// the previous fold left them), as on the TPU. What the design does about the
// bound: nothing yet beyond reading μ once per sweep; the second pass re-reads
// μ_old and θ̂ from L2, and the 2L+1 launches per sweep cost their launch
// latency. A persistent kernel or a captured graph is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::block_sum;
using sweep::kThreads;

__global__ void __launch_bounds__(kThreads)
    gs_estep_kernel(const int* __restrict__ word_ids,
                    const float* __restrict__ counts,
                    const float* __restrict__ mu_in,
                    float* __restrict__ mu_out, float* __restrict__ res_out,
                    float* __restrict__ theta, const float* __restrict__ phi,
                    const float* __restrict__ phi_k,
                    float* __restrict__ delta, int L, int l, int K,
                    float alpha_m1, float beta_m1, float wb) {
  __shared__ float red[33];
  const int d = blockIdx.x;
  const size_t tok = (size_t)d * L + l;
  const float c = counts[tok];
  const float* mo = mu_in + tok * K;
  float* mn = mu_out + tok * K;
  float* rs = res_out + tok * K;
  float* th = theta + (size_t)d * K;
  const float* row = phi + (size_t)word_ids[tok] * K;
  float* s = delta + (size_t)d * K;

  float part = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float ex = __fmul_rn(c, mo[k]);
    const float t = fmaxf(__fsub_rn(th[k], ex), 0.f);
    const float p = fmaxf(__fsub_rn(row[k], ex), 0.f);
    const float q = __fsub_rn(phi_k[k], ex);
    const float num = __fdiv_rn(
        __fmul_rn(__fadd_rn(t, alpha_m1), __fadd_rn(p, beta_m1)),
        __fadd_rn(q, wb));
    s[k] = num;  // staged; read back below by this same thread
    part = __fadd_rn(part, num);
  }
  const float z = fmaxf(block_sum(part, red), 1e-30f);
  // A zero-count token still gets its new μ (as in the reference) but its Δ
  // is exactly zero: it neither changes θ̂ nor enters the fold.
  const bool live = c != 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float m0 = mo[k];
    const float mu = __fdiv_rn(s[k], z);
    mn[k] = mu;
    rs[k] = __fmul_rn(c, fabsf(__fsub_rn(mu, m0)));
    if (live) {
      const float dl = __fsub_rn(__fmul_rn(c, mu), __fmul_rn(c, m0));
      th[k] = __fadd_rn(th[k], dl);
      s[k] = dl;
    }
  }
}

}  // namespace

extern "C" {

// One dense sweep on `stream` (2L launches, +1 with tok_ll). theta, phi and
// phi_k are updated in place; mu_out and res_out are (D, L, K). order and
// the lead_* arrays are (L, D) (see sweep_fold_kernel); live is (D, L) bytes
// (count ≠ 0); delta is a (D, K) scratch. tok_ll == NULL skips the stop-rule
// phase, else it receives the (D, L) eq. 3 partials. Returns the first
// nonzero cudaGetLastError() (0 = every launch was accepted).
int gs_sweep_launch(const void* word_ids, const void* counts,
                    const void* mu_in, void* mu_out, void* res_out,
                    void* theta, void* phi, void* phi_k, const void* order,
                    const void* lead_pos, const void* lead_end,
                    const void* lead_word, const void* live, void* delta,
                    void* tok_ll, int D, int L, int K, float alpha_m1,
                    float beta_m1, float wb, float k_alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* wid = static_cast<const int*>(word_ids);
  const float* cnt = static_cast<const float*>(counts);
  float* th = static_cast<float*>(theta);
  float* ph = static_cast<float*>(phi);
  float* pk = static_cast<float*>(phi_k);
  float* dl = static_cast<float*>(delta);
  for (int l = 0; l < L; ++l) {
    gs_estep_kernel<<<D, kThreads, 0, st>>>(
        wid, cnt, static_cast<const float*>(mu_in),
        static_cast<float*>(mu_out), static_cast<float*>(res_out), th, ph,
        pk, dl, L, l, K, alpha_m1, beta_m1, wb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = sweep::launch_fold<false, false>(
        static_cast<const int*>(order), static_cast<const int*>(lead_pos),
        static_cast<const int*>(lead_end), static_cast<const int*>(lead_word),
        static_cast<const uint8_t*>(live), L, l, dl, nullptr, nullptr, 0, ph,
        pk, D, K, st);
    if (err != cudaSuccess) return err;
  }
  if (tok_ll != nullptr)
    return sweep::launch_loglik(wid, cnt, th, ph, pk,
                                static_cast<float*>(tok_ll), D, L, K,
                                alpha_m1, beta_m1, wb, k_alpha, st);
  return cudaSuccess;
}

const char* gs_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
