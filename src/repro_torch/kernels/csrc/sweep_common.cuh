// Shared pieces of the dense Gauss-Seidel sweep kernel (gs_sweep.cu) for
// NVIDIA Hopper (sm_90a); scheduled_sweep.cu and sharded_sweep.cu use its
// reductions and its stop-rule phase (their column loop is
// sweep_active.cuh):
//
//   * block_sum          — fixed-order block reduction (no atomics);
//   * sweep_fold_kernel  — the Gauss-Seidel fold of one token column: adds
//                          the column's per-document Δ into the φ̂ rows and
//                          into φ̂(k), in a fixed order, without atomics;
//   * sweep_loglik_kernel — the eq. 3 stop-rule phase: per-token data
//                          log-likelihood partials against the final stats.
//
// Column order. The TPU kernels ran the token columns as a sequential Pallas
// grid, which gave the Gauss-Seidel order for free. Here each column is two
// launches on one stream (E-step, then fold), and stream order makes column
// l+1 read the statistics column l folded.
//
// Duplicate words in a column. Two documents of one column can share a word;
// their Δ rows must land in the same φ̂ row. The fold does not use atomics
// (their order, and so the bits, would change from run to run). The wrapper
// sorts each column's live documents by word id, stably, so the documents
// of one word form a segment in document order; one thread per (segment,
// lane) adds the segment's rows in that order: φ̂ ← ((φ̂ + Δ_d1) + Δ_d2)…,
// the order of the TPU kernel's serial scatter. φ̂(k) takes, per lane k, the
// column's Δ summed over the live documents in index order (eight strided
// partial sums combined in a fixed order), then one add: φ̂(k) + ΣΔ, the
// reference's `ptot + delta.sum(0)`. Every result is bitwise repeatable.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

constexpr int kThreads = 256;      // E-step and loglik CTAs
constexpr int kFoldThreads = 256;  // fold CTAs
constexpr int kFoldGroups = kFoldThreads / 32;  // φ̂(k) partial sums per lane
constexpr int kRowBlocks = 64;     // fold CTAs per lane tile walking segments

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

// The fold of column `l`. Grid: (lane tiles, kRowBlocks + kFoldGroups).
//
// Rows with blockIdx.y < kRowBlocks walk the column's segments: block y takes
// segments y, y + kRowBlocks, …; `lead_pos`/`lead_end`/`lead_word` (this
// column's slice, -1 past the last segment) give each segment's first and
// one-past-last sorted position and its word, `order` the document at each
// sorted position. Dense (kCompact false): lanes are topics k, Δ is the
// (D, K) `delta` scratch. Scheduled (kCompact true): lanes are the A active
// slots of the segment's word (every document of a segment shares its word
// and so its active set), Δ is the compact (D, A) `compact` scratch.
//
// Rows with blockIdx.y >= kRowBlocks sum φ̂(k): 32 lanes by kFoldGroups
// strided document groups per block. They read the (D, K) `delta` scratch of
// the live documents (`live`, this column: count ≠ 0, and token active when
// scheduled). When kZeroDelta, they zero what they read, so the scheduled
// E-step finds the scratch all zero at the next column.
template <bool kCompact, bool kZeroDelta>
__global__ void __launch_bounds__(kFoldThreads)
    sweep_fold_kernel(const int* __restrict__ order,
                      const int* __restrict__ lead_pos,
                      const int* __restrict__ lead_end,
                      const int* __restrict__ lead_word,
                      const uint8_t* __restrict__ live, int L, int l,
                      float* __restrict__ delta,
                      const float* __restrict__ compact,
                      const int* __restrict__ word_topics, int A,
                      float* __restrict__ phi, float* __restrict__ phi_k,
                      int D, int K) {
  if (blockIdx.y < kRowBlocks) {
    const int lanes = kCompact ? A : K;
    const int j = blockIdx.x * kFoldThreads + threadIdx.x;
    if (j >= lanes) return;
    for (int s = blockIdx.y; s < D; s += kRowBlocks) {
      const int p = lead_pos[s];
      if (p < 0) break;  // past the column's last segment
      const int end = lead_end[s];
      const int w = lead_word[s];
      const int k = kCompact ? word_topics[(size_t)w * A + j] : j;
      float* dst = phi + (size_t)w * K + k;
      float v = *dst;
      for (int q = p; q < end; ++q) {
        const int d = order[q];
        const float x = kCompact ? compact[(size_t)d * A + j]
                                 : delta[(size_t)d * K + k];
        v = __fadd_rn(v, x);
      }
      *dst = v;
    }
    return;
  }
  __shared__ float part[kFoldGroups][32];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int k = blockIdx.x * kFoldThreads +
                (blockIdx.y - kRowBlocks) * 32 + lane;
  float acc = 0.f;
  if (k < K) {
#pragma unroll 4
    for (int d = g; d < D; d += kFoldGroups) {
      if (!live[(size_t)d * L + l]) continue;
      float* src = delta + (size_t)d * K + k;
      const float x = *src;
      acc = __fadd_rn(acc, x);
      if (kZeroDelta && x != 0.f) *src = 0.f;
    }
  }
  part[g][lane] = acc;
  __syncthreads();
  if (g == 0 && k < K) {
    float s = part[0][lane];
#pragma unroll
    for (int i = 1; i < kFoldGroups; ++i) s = __fadd_rn(s, part[i][lane]);
    phi_k[k] = __fadd_rn(phi_k[k], s);
  }
}

// eq. 3 data log-likelihood partials against the final statistics, one CTA
// per document: tok_ll[d, l] = x_{d,l} · log max(Σ_k θ_d(k) φ_w(k), 1e-30)
// with θ (eq. 9) and φ (eq. 10, global W through `wb`) normalised on the
// fly, the arithmetic of the reference's loglik_partial term for term.
// Zero-count tokens write 0 (the reference's 0 · log(lik)).
__global__ void __launch_bounds__(kThreads)
    sweep_loglik_kernel(const int* __restrict__ word_ids,
                        const float* __restrict__ counts,
                        const float* __restrict__ theta,
                        const float* __restrict__ phi,
                        const float* __restrict__ phi_k,
                        float* __restrict__ tok_ll, int L, int K,
                        float alpha_m1, float beta_m1, float wb,
                        float k_alpha) {
  __shared__ float red[33];
  const int d = blockIdx.x;
  const float* th = theta + (size_t)d * K;
  float part = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) part = __fadd_rn(part, th[k]);
  const float th_den = fmaxf(__fadd_rn(block_sum(part, red), k_alpha), 1e-30f);
  for (int l = 0; l < L; ++l) {
    const size_t t = (size_t)d * L + l;
    const float c = counts[t];
    if (c == 0.f) {
      if (threadIdx.x == 0) tok_ll[t] = 0.f;
      continue;  // uniform across the CTA
    }
    const float* row = phi + (size_t)word_ids[t] * K;
    float lik = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float tn = __fdiv_rn(__fadd_rn(th[k], alpha_m1), th_den);
      const float pn = __fdiv_rn(__fadd_rn(row[k], beta_m1),
                                 fmaxf(__fadd_rn(phi_k[k], wb), 1e-30f));
      lik = __fadd_rn(lik, __fmul_rn(tn, pn));
    }
    lik = fmaxf(block_sum(lik, red), 1e-30f);
    if (threadIdx.x == 0) tok_ll[t] = __fmul_rn(c, logf(lik));
  }
}

// Launch the fold of column l on `stream`; returns cudaGetLastError().
template <bool kCompact, bool kZeroDelta>
cudaError_t launch_fold(const int* order, const int* lead_pos,
                        const int* lead_end, const int* lead_word,
                        const uint8_t* live, int L, int l, float* delta,
                        const float* compact, const int* word_topics, int A,
                        float* phi, float* phi_k, int D, int K,
                        cudaStream_t stream) {
  const int lanes = K > A ? K : A;
  dim3 grid((lanes + kFoldThreads - 1) / kFoldThreads,
            kRowBlocks + kFoldGroups);
  const size_t off = (size_t)l * D;
  sweep_fold_kernel<kCompact, kZeroDelta><<<grid, kFoldThreads, 0, stream>>>(
      order + off, lead_pos + off, lead_end + off, lead_word + off, live, L,
      l, delta, compact, word_topics, A, phi, phi_k, D, K);
  return cudaGetLastError();
}

// Launch the stop-rule phase on `stream`; returns cudaGetLastError().
inline cudaError_t launch_loglik(const int* word_ids, const float* counts,
                                 const float* theta, const float* phi,
                                 const float* phi_k, float* tok_ll, int D,
                                 int L, int K, float alpha_m1, float beta_m1,
                                 float wb, float k_alpha,
                                 cudaStream_t stream) {
  sweep_loglik_kernel<<<D, kThreads, 0, stream>>>(
      word_ids, counts, theta, phi, phi_k, tok_ll, L, K, alpha_m1, beta_m1,
      wb, k_alpha);
  return cudaGetLastError();
}

}  // namespace sweep
