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
// an inactive token changes nothing. Jacobi within a column, Gauss-Seidel
// across columns, as on the TPU.
//
// Bound on this card: device-memory bytes. The outputs are full-K, as the
// reference's SweepResult is: μ_new and the residual (2·D·L·K floats) are
// written once and μ read once, 15.7 GB at the stream_1k width, ≈ 4.7 ms at
// 3.35 TB/s; the active-set arithmetic (A = 16 of K = 10^4 lanes) is
// negligible beside it.
//
// Design (sweep_active.cuh): the bytes go in one streaming pass, μ_new = μ
// and residual = 0 for every token, 16-byte accesses over the whole card;
// then ONE persistent cooperative launch runs the L columns, each an E-step
// phase on the active lanes of the active tokens (a warp a document) and
// two fold phases that read only the column's live Δ (D·A values, not
// D·K), with a grid barrier after each phase. A call enqueues 4 operations
// (the pass's copy and zeroing, the barrier's zeroing, the loop), +1 with
// the stop rule, in place of 2L + 1 launches. The TPU kernel expanded each
// word's A ids into a (D, K) lane mask and ran masked full-K arithmetic;
// here only the A lanes are computed, gathering θ̂, φ̂_w, φ̂(k) and μ_old at
// the word's topic ids.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_active.cuh"
#include "sweep_common.cuh"

extern "C" {

// The streaming pass of one sweep on `stream` (2 launches): mu_out = mu_in,
// then res_out = 0, over n floats. Returns the first CUDA error.
int scheduled_pass_launch(const void* mu_in, void* mu_out, void* res_out,
                          size_t n, void* stream) {
  return active::launch_stream_pass(
      static_cast<const float*>(mu_in), static_cast<float*>(mu_out),
      static_cast<float*>(res_out), n, static_cast<cudaStream_t>(stream));
}

// One scheduled sweep on `stream`, after its streaming pass. theta, phi
// and phi_k are updated in place; mu_out and res_out are (D, L, K).
// token_active is (D, L) bytes. row_order/row_key and pair_order/pair_key
// are the two folds' orders over the live tokens (token active and count
// ≠ 0; see sweep_active.cuh); compact and parts are (D, A) scratches,
// barrier one int. tok_ll == NULL skips the stop-rule phase.
// *launches receives the operations enqueued. Returns the first nonzero
// CUDA error (0 = every launch was accepted).
int scheduled_sweep_launch(const void* word_ids, const void* counts,
                           const void* token_active, const void* mu_in,
                           void* mu_out, void* res_out, void* theta,
                           void* phi, void* phi_k, const void* word_topics,
                           int A, const void* row_order, const void* row_key,
                           const void* pair_order, const void* pair_key,
                           void* compact, void* parts, void* barrier,
                           void* tok_ll, int D, int L, int K, float alpha_m1,
                           float beta_m1, float wb, float k_alpha,
                           int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  active::ActiveLoop p;
  p.word_ids = static_cast<const int*>(word_ids);
  p.counts = static_cast<const float*>(counts);
  p.token_active = static_cast<const uint8_t*>(token_active);
  p.mu_in = static_cast<const float*>(mu_in);
  p.mu_out = static_cast<float*>(mu_out);
  p.res_out = static_cast<float*>(res_out);
  p.theta = static_cast<float*>(theta);
  p.phi = static_cast<float*>(phi);
  p.phi_k = static_cast<float*>(phi_k);
  p.word_topics = static_cast<const int*>(word_topics);
  p.remainder = nullptr;
  p.prev_mass = nullptr;
  p.live_out = nullptr;
  p.row_order = static_cast<const int*>(row_order);
  p.row_key = static_cast<const int*>(row_key);
  p.pair_order = static_cast<const int*>(pair_order);
  p.pair_key = static_cast<const int*>(pair_key);
  p.compact = static_cast<float*>(compact);
  p.parts = static_cast<float*>(parts);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.D = D;
  p.L = L;
  p.K = K;
  p.A = A;
  p.alpha_m1 = alpha_m1;
  p.beta_m1 = beta_m1;
  p.wb = wb;
  cudaError_t err = active::launch_active_sweep<false>(p, st, launches);
  if (err != cudaSuccess) return err;
  if (tok_ll != nullptr) {
    err = sweep::launch_loglik(p.word_ids, p.counts, p.theta, p.phi,
                               p.phi_k, static_cast<float*>(tok_ll), D, L, K,
                               alpha_m1, beta_m1, wb, k_alpha, st);
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

const char* scheduled_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_LIBRARY(scheduled_sweep)
