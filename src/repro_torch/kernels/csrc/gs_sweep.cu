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
// and the fold lands before column l+1 reads the statistics (Gauss-Seidel);
// the documents of one column are Jacobi (they read the statistics the
// previous column left). With a loglik buffer, one more launch emits the
// eq. 3 per-token partials against the final statistics (the stop rule,
// sweep_common.cuh).
//
// Bound on this card: device-memory bytes. The sweep must read μ (D·L·K
// floats) once and write μ_new and the residual (2·D·L·K) once: 15.7 GB at
// the stream_1k width (D = 1024, L = 128, K = 10^4), ≈ 4.7 ms at 3.35 TB/s
// (5.3 ms with θ̂ and the touched rows), against ≈ 21 float32 operations per
// (token, topic), ≈ 0.4 ms. What holds a column-serial sweep above that is
// the (D, K) state each column moves: θ̂ (41 MB at stream_1k) read and
// written, the touched φ̂ rows, Δ for the fold; with μ's 123 MB of streams a
// column, more than the 50 MB L2 keeps. The design before this one (an
// E-step and a fold launch a column, 2L + 1 launches) moved about 15 such
// arrays a column.
//
// Design: ONE persistent cooperative launch runs the L columns (grid_barrier
// of sweep_active.cuh between phases, two a column):
//   * E-step phase. The documents go in fixed groups of `group_docs`
//     consecutive documents (the group, not the grid, fixes the φ̂(k) sum
//     order, so padding documents at the end change no bits); a CTA of 512
//     threads, two an SM, takes a group and its documents one after the
//     other. Thread i owns the four-lane groups i, i + 512, … (kGroups of
//     them: K ≤ 10,240). Every load of a token comes before its arithmetic:
//     μ_old by cp.async into the thread's lanes of shared memory (no
//     registers while in flight; evict-first, it is read once), φ̂_w into
//     the registers that then hold the numerators. One fixed-order block
//     reduction, then the second pass writes μ_new and the residual once
//     (evict-first), θ̂_d += Δ (θ̂_d re-read from L1: its document stays on
//     one SM for the call) and Σ_d Δ over the group into shared memory, lane
//     by lane: φ̂(k)'s partial sums with no second pass over Δ.
//   * Rows without a second pass. A live token whose word no other token of
//     its column has (the wrapper's `flags`, kSolo: about half the live
//     tokens at stream_1k) adds its Δ into its φ̂ row right there: no other
//     document of the column reads that row. Only tokens of words shared in
//     the column (kShared) write Δ to the (D, K) scratch for the fold.
//   * Fold phase, a thread an item: φ̂(k) += the group sums, eight threads a
//     lane (chunks of groups in group order, then a fixed butterfly), then
//     (shared word segment, lane): φ̂_w += the segment's Δ in document order
//     — the order of the TPU kernel's serial scatter and of the reference's
//     accumulating index_put_ — sixteen rows in flight.
// Two launches give the same bits: no atomics, every sum in a fixed order,
// and no order depends on the grid. Measured at stream_1k on an H100 (PERF.md
// §6): 2L + 1 launches → 2 (3 with the stop rule); the E-step phase takes
// most of the time, and its time follows the bytes a document moves through
// L2 (≈ 320 KB: μ in, μ_new, residual, θ̂ in and out, φ̂_w, φ̂(k), Δ or the
// row) more than the division or the registers: one 1,024-thread CTA an SM
// with a cp.async pipeline across documents, 256-thread CTAs with μ_old in
// registers, φ̂(k) staged in shared memory once a column and θ̂ with an
// L2 evict-last hint all ran no faster.
//
// Wide path (K > 10,240: bigmodel's K = 5·10^4): the lanes stride over K,
// the numerators wait in the document's Δ row between the two passes, and
// the group sums accumulate in the partial sum array. Scalar lanes (K % 4 ≠
// 0 or an unaligned μ) keep the lane map and every sum order of the 16-byte
// lanes, so both give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_active.cuh"
#include "sweep_common.cuh"

namespace {

using active::grid_barrier;
using active::numerator;
using sweep::add4;
using sweep::block_sum;
using sweep::get;
using sweep::kL2;
using sweep::kPlain;
using sweep::kStream;
using sweep::lane;
using sweep::ld4;
using sweep::st4;

constexpr int kThreads = 512;   // a CTA a document group, two an SM
constexpr int kCtasPerSm = 2;
constexpr int kGroups = 5;      // float4 lane groups a thread in registers
constexpr int kSumThreads = 8;  // threads summing a φ̂(k) lane's groups
constexpr int kChunk = 32;      // consecutive group sums in flight a thread
constexpr int kSegLoads = 16;   // Δ rows in flight of a row-fold item

// Token flags (gs_sweep.column_plan): dead tokens (count 0) are 0.
constexpr uint8_t kSolo = 1;    // live, the only token of its word in the column
constexpr uint8_t kShared = 2;  // live, its word has other tokens in the column

// μ_old lanes 4g..4g+3 into shared memory without passing through
// registers: one 16-byte cp.async, evict-first in L2 (μ is read once), or
// four 4-byte ones (lanes past K are not copied). Complete for this thread
// after cp_async_wait().
template <bool kVec>
__device__ __forceinline__ void copy4(float* smem, const float* src, int g,
                                      int K) {
  if constexpr (kVec) {
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
            static_cast<unsigned>(__cvta_generic_to_shared(smem + 4 * g))),
        "l"(src + 4 * g), "l"(policy)
        : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * g + j < K)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         static_cast<unsigned>(
                             __cvta_generic_to_shared(smem + 4 * g + j))),
                     "l"(src + 4 * g + j)
                     : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The operands of one dense sweep (see the file comment).
struct GsLoop {
  const int* word_ids;    // (D, L)
  const float* counts;    // (D, L)
  const uint8_t* flags;   // (D, L) kSolo / kShared / 0
  const float* mu_in;     // (D, L, K)
  float* mu_out;          // (D, L, K)
  float* res_out;         // (D, L, K)
  float* theta;           // (D, K), updated in place
  float* phi;             // (W, K), updated in place
  float* phi_k;           // (K,), updated in place
  float* delta;           // (D, K) shared tokens' Δ (wide: staged numerators)
  float* part;            // (groups, K) φ̂(k) partial sums
  const int* seg_order;   // the row fold's order over the shared tokens
  const int* seg_pos;     // (gs_sweep.column_segments)
  const int* seg_end;
  const int* seg_word;
  const int* seg_count;
  unsigned int* barrier;  // one int, zeroed before the launch
  int D, L, K, groups, group_docs;
  float alpha_m1, beta_m1, wb;
};

// The second pass of one lane group of token (d, l), from its numerators,
// μ_old and θ̂_d: write μ_new and the residual (streaming), and, live,
// θ̂_d += Δ and Δ into the row (kSolo: no other document of the column
// reads it) or the scratch (kShared); Σ_d Δ of the group into `acc` (this
// thread's lanes: shared memory, or the wide path's partial sum row).
template <bool kVec>
__device__ __forceinline__ void emit(const GsLoop& p, size_t tok, float* th,
                                     float* row, float* dl_row, float* acc,
                                     int g, float4 num, float4 m0, float4 t,
                                     float z, float c, uint8_t flag,
                                     bool first) {
  const int K = p.K;
  float4 mu, dl;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lane(mu, j) = __fdiv_rn(get(num, j), z);
    // the residual in num's registers: they are dead now
    lane(num, j) = __fmul_rn(c, fabsf(__fsub_rn(get(mu, j), get(m0, j))));
    // a zero-count token's Δ is exactly 0
    lane(dl, j) = __fsub_rn(__fmul_rn(c, get(mu, j)), __fmul_rn(c, get(m0, j)));
  }
  st4<kVec, kStream>(p.mu_out + tok * K, g, K, mu);
  st4<kVec, kStream>(p.res_out + tok * K, g, K, num);
  if (flag) {
    st4<kVec, kPlain>(th, g, K, add4(t, dl));
    if (flag == kSolo)  // the row this document read: still in L2
      st4<kVec, kL2>(row, g, K, add4(ld4<kVec, kL2>(row, g, K), dl));
    else
      st4<kVec, kL2>(dl_row, g, K, dl);
  }
  st4<kVec, kPlain>(acc, g, K,
                    first ? dl : add4(ld4<kVec, kPlain>(acc, g, K), dl));
}

// The E-step of token (d, l) on the register path (K ≤ 10,240): every load
// of the thread's lanes issued before any arithmetic — μ_old into its
// lanes of shared memory (`mu_s`), φ̂_w into the registers that then hold
// the numerators —, one block reduction, then the second pass (θ̂_d
// re-read from L1).
template <bool kVec>
__device__ __forceinline__ void estep(const GsLoop& p, int d, int l,
                                      bool first, float* acc, float* mu_s,
                                      float* red) {
  const int K = p.K;
  const int groups4 = (K + 3) >> 2;
  const size_t tok = (size_t)d * p.L + l;
  const float c = p.counts[tok];
  const uint8_t flag = p.flags[tok];
  const float* mo = p.mu_in + tok * K;
  float* th = p.theta + (size_t)d * K;
  float* row = p.phi + (size_t)p.word_ids[tok] * K;
  float4 n[kGroups];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + kThreads * i;
    if (g < groups4) {
      copy4<kVec>(mu_s, mo, g, K);
      n[i] = ld4<kVec, kL2>(row, g, K);
    }
  }
  cp_async_wait();
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + kThreads * i;
    if (g < groups4) {
      const float4 m = ld4<kVec, kPlain>(mu_s, g, K);
      const float4 t = ld4<kVec, kPlain>(th, g, K);
      const float4 q = ld4<kVec, kL2>(p.phi_k, g, K);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lane(n[i], j) = numerator(c, get(m, j), get(t, j), get(n[i], j),
                                  get(q, j), p.alpha_m1, p.beta_m1, p.wb);
        if (kVec || 4 * g + j < K) part = __fadd_rn(part, get(n[i], j));
      }
    }
  }
  const float z = fmaxf(block_sum(part, red), 1e-30f);
  float* dl_row = p.delta + (size_t)d * K;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + kThreads * i;
    if (g < groups4)
      emit<kVec>(p, tok, th, row, dl_row, acc, g, n[i],
                 ld4<kVec, kPlain>(mu_s, g, K), ld4<kVec, kPlain>(th, g, K),
                 z, c, flag, first);
  }
}

// The E-step of token (d, l) on the wide path (K > 10,240): the lanes
// stride over K, the numerators staged in the document's Δ row between
// the two passes, the group sums in the partial sum row `acc`.
template <bool kVec>
__device__ __forceinline__ void estep_wide(const GsLoop& p, int d, int l,
                                           bool first, float* acc,
                                           float* red) {
  const int K = p.K;
  const int groups4 = (K + 3) >> 2;
  const size_t tok = (size_t)d * p.L + l;
  const float c = p.counts[tok];
  const uint8_t flag = p.flags[tok];
  const float* mo = p.mu_in + tok * K;
  float* th = p.theta + (size_t)d * K;
  float* row = p.phi + (size_t)p.word_ids[tok] * K;
  float* dl_row = p.delta + (size_t)d * K;
  float part = 0.f;
  for (int g = threadIdx.x; g < groups4; g += kThreads) {
    const float4 m = ld4<kVec, kPlain>(mo, g, K);
    const float4 t = ld4<kVec, kPlain>(th, g, K);
    const float4 r = ld4<kVec, kL2>(row, g, K);
    const float4 q = ld4<kVec, kL2>(p.phi_k, g, K);
    float4 nn;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lane(nn, j) = numerator(c, get(m, j), get(t, j), get(r, j), get(q, j),
                              p.alpha_m1, p.beta_m1, p.wb);
      if (kVec || 4 * g + j < K) part = __fadd_rn(part, get(nn, j));
    }
    st4<kVec, kPlain>(dl_row, g, K, nn);  // read back by this same thread
  }
  const float z = fmaxf(block_sum(part, red), 1e-30f);
  for (int g = threadIdx.x; g < groups4; g += kThreads)
    emit<kVec>(p, tok, th, row, dl_row, acc, g,
               ld4<kVec, kPlain>(dl_row, g, K), ld4<kVec, kPlain>(mo, g, K),
               ld4<kVec, kPlain>(th, g, K), z, c, flag, first);
}

// φ̂_w(k) += the segment's Δ(k), in its document order, kSegLoads rows in
// flight before their adds (a frequent word's segment holds hundreds of
// documents; a lane an item keeps more of them in flight than four).
__device__ __forceinline__ void fold_row(const GsLoop& p, size_t off, int s,
                                         int k) {
  const int K = p.K;
  const int q0 = p.seg_pos[off + s];
  const int q1 = p.seg_end[off + s];
  const int* order = p.seg_order + off;
  float* dst = p.phi + (size_t)p.seg_word[off + s] * K + k;
  float v = __ldcg(dst);
  for (int r = q0; r < q1; r += kSegLoads) {
    float x[kSegLoads];
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i)
      if (r + i < q1) x[i] = __ldcg(p.delta + (size_t)order[r + i] * K + k);
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i)
      if (r + i < q1) v = __fadd_rn(v, x[i]);
  }
  __stcg(dst, v);
}

// φ̂(k) += Σ_g part[g, k], by kSumThreads threads of one warp: thread c
// sums, in group order, the chunks of kChunk consecutive groups c, c +
// kSumThreads, … (a chunk's loads all in flight), then the threads' sums
// combine in a fixed butterfly, which gives all of them the same bits.
// Chunks are fixed by the group index, so groups of padding documents at
// the end add zeros to the same sums. k ≥ K: the thread only shuffles.
__device__ __forceinline__ void fold_phi_k(const GsLoop& p, int k, int c) {
  const int K = p.K;
  float acc = 0.f;
  if (k < K) {
    for (int g0 = c * kChunk; g0 < p.groups; g0 += kSumThreads * kChunk) {
      float x[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        x[j] = g0 + j < p.groups ? __ldcg(p.part + (size_t)(g0 + j) * K + k)
                                 : 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (g0 + j < p.groups) acc = __fadd_rn(acc, x[j]);
    }
  }
#pragma unroll
  for (int o = kSumThreads / 2; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (k < K && c == 0) p.phi_k[k] = __fadd_rn(__ldcg(p.phi_k + k), acc);
}

// kVec: 16-byte lanes (K % 4 = 0, μ 16-byte aligned); kWide: K > 10,240.
// Dynamic shared memory: the register path's μ_old and group sums, two of
// 4·ceil(K/4) floats (none when wide).
template <bool kVec, bool kWide>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    gs_loop_kernel(const GsLoop p) {
  const int K = p.K;
  const int groups4 = (K + 3) >> 2;
  // this thread's lanes of μ_old and of the group sums
  extern __shared__ float4 smem4[];
  float* mu_s = reinterpret_cast<float*>(smem4);
  float* sacc = mu_s + 4 * groups4;
  __shared__ float red[33];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int l = 0; l < p.L; ++l) {
    for (int g = blockIdx.x; g < p.groups; g += gridDim.x) {
      float* part = p.part + (size_t)g * K;
      const int d0 = g * p.group_docs;
      const int d1 = min(d0 + p.group_docs, p.D);
      for (int d = d0; d < d1; ++d) {
        if (kWide)
          estep_wide<kVec>(p, d, l, d == d0, part, red);
        else
          estep<kVec>(p, d, l, d == d0, sacc, mu_s, red);
      }
      if (!kWide)  // this thread's lanes: no barrier needed
        for (int q = threadIdx.x; q < groups4; q += kThreads)
          st4<kVec, kL2>(part, q, K, ld4<kVec, kPlain>(sacc, q, K));
    }
    grid_barrier(p.barrier);
    // items: kSumThreads threads a φ̂(k) lane, whole warps, then a thread a
    // (shared segment, lane); warps never straddle the two
    const size_t off = (size_t)l * p.D;
    const int sums = (K * kSumThreads + 31) & ~31;
    const int items = sums + p.seg_count[l] * K;
    for (int i = gtid; i < items; i += nthreads) {
      if (i < sums) {
        fold_phi_k(p, i / kSumThreads, i % kSumThreads);
      } else {
        const int s = (i - sums) / K;
        fold_row(p, off, s, (i - sums) - s * K);
      }
    }
    if (l + 1 < p.L) grid_barrier(p.barrier);
  }
}

}  // namespace

extern "C" {

// One dense sweep on `stream`. theta, phi and phi_k are updated in place;
// mu_out and res_out are (D, L, K). flags is the (D, L) column plan and
// seg_* the row fold's order over its kShared tokens (gs_sweep.column_plan);
// delta is a (D, K) and part a (ceil(D / group_docs), K) scratch, barrier
// one int. path: bit 0 scalar lanes, bit 1 the wide path (gs_sweep.
// dense_path). tok_ll == NULL skips the stop-rule phase, else it receives
// the (D, L) eq. 3 partials. *launches receives the operations enqueued.
// Returns the first nonzero CUDA error (0 = every launch was accepted).
int gs_sweep_launch(const void* word_ids, const void* counts,
                    const void* flags, const void* mu_in, void* mu_out,
                    void* res_out, void* theta, void* phi, void* phi_k,
                    const void* seg_order, const void* seg_pos,
                    const void* seg_end, const void* seg_word,
                    const void* seg_count, void* delta, void* part,
                    void* barrier, void* tok_ll, int D, int L, int K,
                    int group_docs, int path, float alpha_m1, float beta_m1,
                    float wb, float k_alpha, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GsLoop p;
  p.word_ids = static_cast<const int*>(word_ids);
  p.counts = static_cast<const float*>(counts);
  p.flags = static_cast<const uint8_t*>(flags);
  p.mu_in = static_cast<const float*>(mu_in);
  p.mu_out = static_cast<float*>(mu_out);
  p.res_out = static_cast<float*>(res_out);
  p.theta = static_cast<float*>(theta);
  p.phi = static_cast<float*>(phi);
  p.phi_k = static_cast<float*>(phi_k);
  p.delta = static_cast<float*>(delta);
  p.part = static_cast<float*>(part);
  p.seg_order = static_cast<const int*>(seg_order);
  p.seg_pos = static_cast<const int*>(seg_pos);
  p.seg_end = static_cast<const int*>(seg_end);
  p.seg_word = static_cast<const int*>(seg_word);
  p.seg_count = static_cast<const int*>(seg_count);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.D = D;
  p.L = L;
  p.K = K;
  p.group_docs = group_docs;
  p.groups = (D + group_docs - 1) / group_docs;
  p.alpha_m1 = alpha_m1;
  p.beta_m1 = beta_m1;
  p.wb = wb;
  *launches = 0;
  cudaError_t err = active::reset_barrier(p.barrier, st);
  if (err != cudaSuccess) return err;
  ++*launches;
  const bool vec = (path & 1) == 0;
  const bool wide = (path & 2) != 0;
  // the register path holds ≤ kThreads·kGroups lane groups (K ≤ 10,240)
  if (!wide && (K + 3) / 4 > kThreads * kGroups) return cudaErrorInvalidValue;
  const size_t smem = wide ? 0 : sizeof(float4) * 2 * ((K + 3) / 4);
  void (*kernel)(GsLoop) =
      wide ? (vec ? &gs_loop_kernel<true, true> : &gs_loop_kernel<false, true>)
           : (vec ? &gs_loop_kernel<true, false>
                  : &gs_loop_kernel<false, false>);
  err = launch_log::optin_smem(reinterpret_cast<const void*>(kernel),
                               (long long)smem);
  if (err != cudaSuccess) return err;
  // a CTA a document group in the E-step phase
  err = active::launch_cooperative(kernel, p, p.groups, kCtasPerSm, kThreads,
                                   st, "gs_loop_kernel", path & 3, smem);
  if (err != cudaSuccess) return err;
  ++*launches;
  if (tok_ll != nullptr) {
    err = sweep::launch_loglik(p.word_ids, p.counts, p.theta, p.phi,
                               p.phi_k, static_cast<float*>(tok_ll), D, L, K,
                               alpha_m1, beta_m1, wb, k_alpha, st);
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

// The stop-rule phase alone on `stream` (one launch): the (D, L) eq. 3
// partials against the given statistics. Returns cudaGetLastError().
int sweep_loglik_launch(const void* word_ids, const void* counts,
                        const void* theta, const void* phi,
                        const void* phi_k, void* tok_ll, int D, int L, int K,
                        float alpha_m1, float beta_m1, float wb,
                        float k_alpha, void* stream) {
  return sweep::launch_loglik(
      static_cast<const int*>(word_ids), static_cast<const float*>(counts),
      static_cast<const float*>(theta), static_cast<const float*>(phi),
      static_cast<const float*>(phi_k), static_cast<float*>(tok_ll), D, L, K,
      alpha_m1, beta_m1, wb, k_alpha, static_cast<cudaStream_t>(stream));
}

const char* gs_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_QUERY(gs_loop_kernel)
LAUNCH_LOG_LIBRARY(gs_sweep)
