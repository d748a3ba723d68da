// The two kernels of the two-phase topic-sharded Gauss-Seidel sweep for
// NVIDIA Hopper (sm_90a): the phase-A probe and the phase-C fold.
//
// Replaces the TPU kernels kernels/sharded_sweep.py::sharded_probe_pallas and
// sharded_fold_pallas of the JAX package. A rank owns the topic lanes
// [m·K/mp, (m+1)·K/mp): μ (D, L, K), θ̂ (D, K), φ̂ (W, K) and φ̂(k) (K) below
// are its slices (K = K/mp lanes), and the only cross-shard terms of the
// E-step are the per-token normalisers, reduced by the caller between the
// two launches (ops._sweep_two_phase). For a token with count x, word w and
// old responsibilities μ_old, on a lane k:
//
//   ex  = x·μ_old(k)                                        (eq. 13 exclusion)
//   num = (max(θ̂_d(k)−ex,0)+α−1)(max(φ̂_w(k)−ex,0)+β−1)/(φ̂(k)−ex+W(β−1))
//
// over all K lanes (dense) or the word's A active lanes of a token the λ_w
// mask keeps (scheduled, word_topics (W, A) distinct ids per row).
//
// Probe (phase A), against the sweep-start statistics, no fold: per token
// s = Σ num and, scheduled, p = Σ_A μ_old (the eq. 38 previous mass). The
// tokens are independent, so all D·L go in one launch, one warp per token;
// each lane strides over the shard's lanes and the warp sums in a fixed
// shuffle order. Nothing is atomic: two launches give the same bits.
//
// Fold (phase C): the column-serial sweep of gs_sweep.cu and
// scheduled_sweep.cu with the sharded denominator. Per column, one E-step
// launch (one CTA per document) computes
//
//   dense:     μ_new = num / max(rem + Σ_K num, 1e-30)
//   scheduled: μ_new = num / max(rem + Σ_A num, 1e-30) · pm  on the A lanes
//
// where rem (D, L) is the peers' probe sums (own sum live, peers' one phase
// stale) and pm (D, L) the global previous active mass; it writes μ_new, the
// eq. 36 residual, the token's live mass Σ μ_new (over the A lanes when
// scheduled) and adds Δ into θ̂_d. Then the deterministic fold launch of
// sweep_common.cuh lands Δ in φ̂ and φ̂(k) before the next column. With a
// `u` buffer one more launch, one warp per token like the probe, emits the
// pre-log eq. 3 partials u = Σ_k (θ̂_d(k)+α−1)(φ̂_w(k)+β−1)/max(φ̂(k)+wb,
// 1e-30) against the final statistics: the log must wait for the caller's
// cross-shard sum.
//
// Bound on this card: device-memory bytes. At the stream_1k shard width
// (D = 1024, L = 128, K/mp = 2,500) the dense probe must read μ once
// (1.31 GB, ≈ 0.39 ms at 3.35 TB/s) against ≈ 12 float32 operations per
// (token, lane); the fold reads μ and writes μ_new and the residual
// (3.9 GB, ≈ 1.2 ms). The scheduled probe reads 4 lanes of μ per active
// token and is bound by its (D, L) inputs and outputs. What the design does
// about it: the probe reads each μ row once, coalesced, and keeps nothing
// in shared memory; the fold is as simple as those sweeps (2L launches,
// a second pass over μ_old and θ̂ from L2). Padded documents (count 0,
// inactive) fold nothing; lanes past K are never touched.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::block_sum;
using sweep::kThreads;
using sweep::warp_sum;

constexpr int kWarpThreads = 256;               // probe and u CTAs
constexpr int kWarps = kWarpThreads / 32;       // tokens per CTA

__device__ __forceinline__ float numerator(float c, float m0, float th,
                                           float ph, float pk, float alpha_m1,
                                           float beta_m1, float wb) {
  const float ex = __fmul_rn(c, m0);
  const float t = fmaxf(__fsub_rn(th, ex), 0.f);
  const float p = fmaxf(__fsub_rn(ph, ex), 0.f);
  const float q = __fsub_rn(pk, ex);
  return __fdiv_rn(__fmul_rn(__fadd_rn(t, alpha_m1), __fadd_rn(p, beta_m1)),
                   __fadd_rn(q, wb));
}

// Phase A: one warp per token t = d·L + l.
template <bool kSched>
__global__ void __launch_bounds__(kWarpThreads)
    probe_kernel(const int* __restrict__ word_ids,
                 const float* __restrict__ counts,
                 const uint8_t* __restrict__ token_active,
                 const float* __restrict__ mu,
                 const float* __restrict__ theta,
                 const float* __restrict__ phi,
                 const float* __restrict__ phi_k,
                 const int* __restrict__ word_topics, int A,
                 float* __restrict__ s_out, float* __restrict__ pm_out,
                 long long tokens, int L, int K, float alpha_m1,
                 float beta_m1, float wb) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tokens) return;  // uniform across the warp
  const int d = (int)(t / L);
  const float c = counts[t];
  const int w = word_ids[t];
  const float* mo = mu + (size_t)t * K;
  const float* th = theta + (size_t)d * K;
  const float* row = phi + (size_t)w * K;
  float s = 0.f, pm = 0.f;
  if (kSched) {
    if (token_active[t]) {  // uniform across the warp
      const int* top = word_topics + (size_t)w * A;
      for (int a = lane; a < A; a += 32) {
        const int k = top[a];
        const float m0 = mo[k];
        s = __fadd_rn(s, numerator(c, m0, th[k], row[k], phi_k[k], alpha_m1,
                                   beta_m1, wb));
        pm = __fadd_rn(pm, m0);
      }
    }
  } else {
    for (int k = lane; k < K; k += 32)
      s = __fadd_rn(s, numerator(c, mo[k], th[k], row[k], phi_k[k], alpha_m1,
                                 beta_m1, wb));
  }
  s = warp_sum(s);
  if (kSched) pm = warp_sum(pm);
  if (lane == 0) {
    s_out[t] = s;
    if (kSched) pm_out[t] = pm;
  }
}

// Phase C, dense E-step of column l: one CTA per document. The numerators
// are staged in the document's row of the (D, K) Δ scratch and reduced in a
// fixed order; the second pass (same thread, same lanes) normalises, writes
// μ_new and the residual, sums the live mass and leaves Δ in the scratch.
__global__ void __launch_bounds__(kThreads)
    fold_estep_dense(const int* __restrict__ word_ids,
                     const float* __restrict__ counts,
                     const float* __restrict__ remainder,
                     const float* __restrict__ mu_in,
                     float* __restrict__ mu_out, float* __restrict__ res_out,
                     float* __restrict__ theta, const float* __restrict__ phi,
                     const float* __restrict__ phi_k,
                     float* __restrict__ delta, float* __restrict__ live_out,
                     int L, int l, int K, float alpha_m1, float beta_m1,
                     float wb) {
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
    const float num = numerator(c, mo[k], th[k], row[k], phi_k[k], alpha_m1,
                                beta_m1, wb);
    s[k] = num;  // staged; read back below by this same thread
    part = __fadd_rn(part, num);
  }
  const float z =
      fmaxf(__fadd_rn(remainder[tok], block_sum(part, red)), 1e-30f);
  // A zero-count token gets its new μ but its Δ is exactly zero: it neither
  // changes θ̂ nor enters the fold.
  const bool live = c != 0.f;
  float mass = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float m0 = mo[k];
    const float mu = __fdiv_rn(s[k], z);
    mn[k] = mu;
    rs[k] = __fmul_rn(c, fabsf(__fsub_rn(mu, m0)));
    mass = __fadd_rn(mass, mu);
    if (live) {
      const float dl = __fsub_rn(__fmul_rn(c, mu), __fmul_rn(c, m0));
      th[k] = __fadd_rn(th[k], dl);
      s[k] = dl;
    }
  }
  mass = block_sum(mass, red);
  if (threadIdx.x == 0) live_out[tok] = mass;
}

// Phase C, scheduled E-step of column l: one CTA per document. The token's
// μ row is copied to μ_new and its residual row zeroed, then its A active
// lanes are rewritten. Δ goes to the compact (D, A) scratch for the φ̂-row
// fold and to the (D, K) scratch, zero off the active lanes, for φ̂(k).
__global__ void __launch_bounds__(kThreads)
    fold_estep_sched(const int* __restrict__ word_ids,
                     const float* __restrict__ counts,
                     const uint8_t* __restrict__ token_active,
                     const float* __restrict__ remainder,
                     const float* __restrict__ prev_mass,
                     const float* __restrict__ mu_in,
                     float* __restrict__ mu_out, float* __restrict__ res_out,
                     float* __restrict__ theta, const float* __restrict__ phi,
                     const float* __restrict__ phi_k,
                     const int* __restrict__ word_topics, int A,
                     float* __restrict__ delta, float* __restrict__ compact,
                     float* __restrict__ live_out, int L, int l, int K,
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
  if (!token_active[tok]) {  // uniform across the CTA
    if (threadIdx.x == 0) live_out[tok] = 0.f;
    return;
  }
  __syncthreads();  // the copy lands before the active lanes are rewritten

  const float c = counts[tok];
  const int w = word_ids[tok];
  const int* top = word_topics + (size_t)w * A;
  const float* row = phi + (size_t)w * K;
  float* th = theta + (size_t)d * K;
  float* cp = compact + (size_t)d * A;
  float ns = 0.f;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int k = top[a];
    const float num = numerator(c, mo[k], th[k], row[k], phi_k[k], alpha_m1,
                                beta_m1, wb);
    cp[a] = num;  // staged; read back below by this same thread
    ns = __fadd_rn(ns, num);
  }
  const float z = fmaxf(__fadd_rn(remainder[tok], block_sum(ns, red)),
                        1e-30f);
  const float pm = prev_mass[tok];
  const bool live = c != 0.f;
  float* dd = delta + (size_t)d * K;
  float mass = 0.f;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int k = top[a];
    const float m0 = mo[k];
    const float mu = __fmul_rn(__fdiv_rn(cp[a], z), pm);
    const float dl = __fmul_rn(c, __fsub_rn(mu, m0));
    mn[k] = mu;
    rs[k] = fabsf(dl);
    mass = __fadd_rn(mass, mu);
    if (live) {
      th[k] = __fadd_rn(th[k], dl);
      cp[a] = dl;
      dd[k] = dl;
    }
  }
  mass = block_sum(mass, red);
  if (threadIdx.x == 0) live_out[tok] = mass;
}

// The pre-log eq. 3 partials against the final statistics, one warp per
// token, every token (a zero count is weighted out by the caller).
__global__ void __launch_bounds__(kWarpThreads)
    loglik_u_kernel(const int* __restrict__ word_ids,
                    const float* __restrict__ theta,
                    const float* __restrict__ phi,
                    const float* __restrict__ phi_k, float* __restrict__ u,
                    long long tokens, int L, int K, float alpha_m1,
                    float beta_m1, float wb) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tokens) return;  // uniform across the warp
  const float* th = theta + (size_t)(t / L) * K;
  const float* row = phi + (size_t)word_ids[t] * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float pn = __fdiv_rn(__fadd_rn(row[k], beta_m1),
                               fmaxf(__fadd_rn(phi_k[k], wb), 1e-30f));
    acc = __fadd_rn(acc, __fmul_rn(__fadd_rn(th[k], alpha_m1), pn));
  }
  acc = warp_sum(acc);
  if (lane == 0) u[t] = acc;
}

unsigned warp_grid(long long tokens) {
  return (unsigned)((tokens + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// Phase A on `stream`: one launch. word_topics == NULL is the dense probe
// (token_active and pm_out unused); else token_active is (D, L) bytes and
// pm_out receives the previous active mass. Returns cudaGetLastError().
int sharded_probe_launch(const void* word_ids, const void* counts,
                         const void* token_active, const void* mu,
                         const void* theta, const void* phi,
                         const void* phi_k, const void* word_topics, int A,
                         void* s_out, void* pm_out, int D, int L, int K,
                         float alpha_m1, float beta_m1, float wb,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tokens = (long long)D * L;
  const int* wid = static_cast<const int*>(word_ids);
  const float* cnt = static_cast<const float*>(counts);
  const uint8_t* act = static_cast<const uint8_t*>(token_active);
  const float* m = static_cast<const float*>(mu);
  const float* th = static_cast<const float*>(theta);
  const float* ph = static_cast<const float*>(phi);
  const float* pk = static_cast<const float*>(phi_k);
  const int* wt = static_cast<const int*>(word_topics);
  float* s = static_cast<float*>(s_out);
  float* pm = static_cast<float*>(pm_out);
  if (wt != nullptr)
    probe_kernel<true><<<warp_grid(tokens), kWarpThreads, 0, st>>>(
        wid, cnt, act, m, th, ph, pk, wt, A, s, pm, tokens, L, K, alpha_m1,
        beta_m1, wb);
  else
    probe_kernel<false><<<warp_grid(tokens), kWarpThreads, 0, st>>>(
        wid, cnt, act, m, th, ph, pk, wt, A, s, pm, tokens, L, K, alpha_m1,
        beta_m1, wb);
  return cudaGetLastError();
}

// Phase C on `stream` (2L launches, +1 with u). theta, phi and phi_k are
// updated in place; mu_out and res_out are (D, L, K); live_out is (D, L).
// word_topics == NULL is the dense fold (token_active, prev_mass and
// compact unused, delta a (D, K) scratch); else token_active is (D, L)
// bytes, prev_mass (D, L), compact a (D, A) scratch and delta a (D, K)
// scratch that must be all zero on entry (all zero again on return). live
// is (D, L) bytes (count ≠ 0, and token active when scheduled); order and
// the lead_* arrays are (L, D) over the live tokens (sweep_fold_kernel).
// u == NULL skips the pre-log loglik launch. Returns the first nonzero
// cudaGetLastError() (0 = every launch was accepted).
int sharded_fold_launch(const void* word_ids, const void* counts,
                        const void* token_active, const void* remainder,
                        const void* prev_mass, const void* mu_in,
                        void* mu_out, void* res_out, void* theta, void* phi,
                        void* phi_k, const void* word_topics, int A,
                        const void* order, const void* lead_pos,
                        const void* lead_end, const void* lead_word,
                        const void* live, void* delta, void* compact,
                        void* live_out, void* u, int D, int L, int K,
                        float alpha_m1, float beta_m1, float wb,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* wid = static_cast<const int*>(word_ids);
  const float* cnt = static_cast<const float*>(counts);
  const float* rem = static_cast<const float*>(remainder);
  const int* wt = static_cast<const int*>(word_topics);
  const int* ord = static_cast<const int*>(order);
  const int* lpos = static_cast<const int*>(lead_pos);
  const int* lend = static_cast<const int*>(lead_end);
  const int* lword = static_cast<const int*>(lead_word);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  float* th = static_cast<float*>(theta);
  float* ph = static_cast<float*>(phi);
  float* pk = static_cast<float*>(phi_k);
  float* dl = static_cast<float*>(delta);
  float* cp = static_cast<float*>(compact);
  float* mo = static_cast<float*>(live_out);
  for (int l = 0; l < L; ++l) {
    cudaError_t err;
    if (wt != nullptr) {
      fold_estep_sched<<<D, kThreads, 0, st>>>(
          wid, cnt, static_cast<const uint8_t*>(token_active), rem,
          static_cast<const float*>(prev_mass),
          static_cast<const float*>(mu_in), static_cast<float*>(mu_out),
          static_cast<float*>(res_out), th, ph, pk, wt, A, dl, cp, mo, L, l,
          K, alpha_m1, beta_m1, wb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      err = sweep::launch_fold<true, true>(ord, lpos, lend, lword, lv, L, l,
                                           dl, cp, wt, A, ph, pk, D, K, st);
    } else {
      fold_estep_dense<<<D, kThreads, 0, st>>>(
          wid, cnt, rem, static_cast<const float*>(mu_in),
          static_cast<float*>(mu_out), static_cast<float*>(res_out), th, ph,
          pk, dl, mo, L, l, K, alpha_m1, beta_m1, wb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      err = sweep::launch_fold<false, false>(ord, lpos, lend, lword, lv, L,
                                             l, dl, nullptr, nullptr, 0, ph,
                                             pk, D, K, st);
    }
    if (err != cudaSuccess) return err;
  }
  if (u != nullptr) {
    const long long tokens = (long long)D * L;
    loglik_u_kernel<<<warp_grid(tokens), kWarpThreads, 0, st>>>(
        wid, th, ph, pk, static_cast<float*>(u), tokens, L, K, alpha_m1,
        beta_m1, wb);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

const char* sharded_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
