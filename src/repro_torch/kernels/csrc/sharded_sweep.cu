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
// tokens are independent, so all D·L go in one launch. Nothing is atomic:
// two launches give the same bits.
//
// Fold (phase C): the column-serial sweep of gs_sweep.cu and
// scheduled_sweep.cu with the sharded denominator:
//
//   dense:     μ_new = num / max(rem + Σ_K num, 1e-30)
//   scheduled: μ_new = num / max(rem + Σ_A num, 1e-30) · pm  on the A lanes
//
// where rem (D, L) is the peers' probe sums (own sum live, peers' one phase
// stale) and pm (D, L) the global previous active mass; it writes μ_new, the
// eq. 36 residual, the token's live mass Σ μ_new (over the A lanes when
// scheduled), adds Δ into θ̂_d and folds Δ into φ̂ and φ̂(k) before the next
// column. With a `u` buffer one more launch, one warp per token like the
// probe, emits the pre-log eq. 3 partials u = Σ_k (θ̂_d(k)+α−1)(φ̂_w(k)+β−1)
// /max(φ̂(k)+wb, 1e-30) against the final statistics: the log must wait for
// the caller's cross-shard sum.
//
// Bound on this card: device-memory bytes. At the stream_1k shard width
// (D = 1024, L = 128, K/mp = 2,500) the dense probe must read μ once
// (1.31 GB, ≈ 0.39 ms at 3.35 TB/s; 0.47 ms with θ̂ and the rows) against
// ≈ 12 float32 operations per (token, lane); the fold reads μ and writes
// μ_new and the residual (3.9 GB, ≈ 1.2 ms). The scheduled probe reads
// A/mp = 4 lanes of μ per active token: its bound is its (D, L) inputs and
// outputs (2.2 µs), but each lane it gathers is a 32-byte sector of μ and
// of a φ̂ row, and one launch has a few µs of ramp.
//
// Design of the probe. Dense: a warp a token, four 256-thread CTAs an SM
// (≤ 64 registers: more tokens in flight beat more loads a lane, which
// spill); each lane issues its next kProbeLoads four-lane groups of μ
// (streaming), θ̂_d, φ̂_w and φ̂(k) (the read-only path) before it uses
// them, 16-byte loads where K/mp % 4 = 0
// and the bases are aligned (the wrapper's probe_path), scalar ones
// otherwise; the lane's sum runs over its groups in order, then a fixed
// shuffle order over the warp. The design before this one strode four
// scalar loads at a time over the lanes (0.48 of the bound's rate).
// Scheduled: a power-of-two `span` of threads a token, the least ≥ A/mp up
// to 32, so a warp carries 32 / span tokens (8 at A/mp = 4) instead of one
// token on 4 of its 32 lanes; the token's threads add their slots' sums in
// a fixed butterfly order. The fold runs its L columns in ONE persistent
// cooperative launch with grid barriers between phases (sweep_active.cuh),
// not 2L launches:
//   * scheduled: the streaming pass writes μ_new = μ and residual = 0 for
//     every token, then active_loop_kernel<true> runs the columns on the
//     active lanes and folds only the live Δ (D·A values a column);
//   * dense (dense_loop_kernel): per column an E-step phase, one CTA of
//     512 threads per document, leaving Δ in a (D, K) scratch (0 for a
//     zero count). It issues all its loads before the arithmetic and keeps
//     the numerators, μ_old and θ̂ of up to kRegLanes·512 lanes in
//     registers between its two passes, so the second reads neither μ_old
//     nor θ̂ again; μ is read and μ_new and the residual written with
//     streaming (evict-first) accesses, which leave L2 to θ̂, Δ and the φ̂
//     rows. Then a fold phase, a thread an item, that adds each segment's
//     Δ into its φ̂ row (four lanes an item when K % 4 = 0) and sums Δ over
//     fixed groups of kGroupDocs documents per lane; a phase that adds each
//     lane's group sums to φ̂(k) in group order. Three barriers a column.
// Padded documents (count 0, inactive) fold nothing; lanes past K are never
// touched.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_active.cuh"
#include "sweep_common.cuh"

namespace {

using active::grid_barrier;
using active::ld_l2;
using active::numerator;
using sweep::block_sum;
using sweep::get;
using sweep::kReadOnly;
using sweep::kStream;
using sweep::ld4;
using sweep::warp_sum;

constexpr int kWarpThreads = 256;               // probe and u CTAs
constexpr int kWarps = kWarpThreads / 32;       // dense tokens per CTA
constexpr int kProbeLoads = 2;  // dense probe: lane groups in flight a lane
constexpr int kProbeCtasPerSm = 4;  // dense probe: 32 warps an SM
constexpr int kDenseThreads = 512;  // dense fold CTAs
constexpr int kDenseCtasPerSm = 2;
constexpr int kRegLanes = 5;    // dense lanes a thread keeps in registers
constexpr int kGroupDocs = 32;  // documents per φ̂(k) partial sum (dense)

// Phase A, dense: one warp per token t = d·L + l. Each lane issues its
// next kProbeLoads four-lane groups of all four operands before it uses
// them (16-byte loads where kVec: K % 4 = 0 and every base aligned), μ
// streaming and the rest through the read-only path (θ̂_d and φ̂(k) are
// shared by the CTA's tokens, frequent rows by many); the lane's sum runs
// over its groups in order, then a fixed shuffle order over the warp.
template <bool kVec>
__global__ void __launch_bounds__(kWarpThreads, kProbeCtasPerSm)
    probe_dense_kernel(const int* __restrict__ word_ids,
                       const float* __restrict__ counts,
                       const float* __restrict__ mu,
                       const float* __restrict__ theta,
                       const float* __restrict__ phi,
                       const float* __restrict__ phi_k,
                       float* __restrict__ s_out, long long tokens, int L,
                       int K, float alpha_m1, float beta_m1, float wb) {
  const int lane_id = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tokens) return;  // uniform across the warp
  const float c = counts[t];
  const float* mo = mu + (size_t)t * K;
  const float* th = theta + (size_t)(t / L) * K;
  const float* row = phi + (size_t)word_ids[t] * K;
  const int groups4 = (K + 3) >> 2;
  float s = 0.f;
  for (int g0 = lane_id; g0 < groups4; g0 += 32 * kProbeLoads) {
    float4 m[kProbeLoads], a[kProbeLoads], r[kProbeLoads], q[kProbeLoads];
#pragma unroll
    for (int u = 0; u < kProbeLoads; ++u) {
      const int g = g0 + 32 * u;
      if (g < groups4) {
        m[u] = ld4<kVec, kStream>(mo, g, K);
        a[u] = ld4<kVec, kReadOnly>(th, g, K);
        r[u] = ld4<kVec, kReadOnly>(row, g, K);
        q[u] = ld4<kVec, kReadOnly>(phi_k, g, K);
      }
    }
#pragma unroll
    for (int u = 0; u < kProbeLoads; ++u) {
      const int g = g0 + 32 * u;
      if (g >= groups4) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kVec || 4 * g + j < K)
          s = __fadd_rn(s, numerator(c, get(m[u], j), get(a[u], j),
                                     get(r[u], j), get(q[u], j), alpha_m1,
                                     beta_m1, wb));
    }
  }
  s = warp_sum(s);
  if (lane_id == 0) s_out[t] = s;
}

// Phase A, scheduled: `span` threads a token (a power of two, the least ≥
// A up to 32), 32 / span tokens a warp. Thread j of a token takes slots j,
// j + span, … of its word's active set; the token's span threads then add
// their sums in a fixed butterfly (xor) order, which gives all of them the
// same bits. An inactive token (λ_w mask) writes 0.
__global__ void __launch_bounds__(kWarpThreads)
    probe_sched_kernel(const int* __restrict__ word_ids,
                       const float* __restrict__ counts,
                       const uint8_t* __restrict__ token_active,
                       const float* __restrict__ mu,
                       const float* __restrict__ theta,
                       const float* __restrict__ phi,
                       const float* __restrict__ phi_k,
                       const int* __restrict__ word_topics, int A, int span,
                       float* __restrict__ s_out, float* __restrict__ pm_out,
                       long long tokens, int L, int K, float alpha_m1,
                       float beta_m1, float wb) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  const long long t = i / span;
  const int sub = (int)(i & (span - 1));
  float s = 0.f, pm = 0.f;
  if (t < tokens) {
    const float c = counts[t];
    const int w = word_ids[t];
    if (token_active[t]) {
      const int* top = word_topics + (size_t)w * A;
      const float* mo = mu + (size_t)t * K;
      const float* th = theta + (size_t)(t / L) * K;
      const float* row = phi + (size_t)w * K;
      for (int a = sub; a < A; a += span) {
        const int k = __ldg(top + a);
        const float m0 = mo[k];
        s = __fadd_rn(s, numerator(c, m0, __ldg(th + k), __ldg(row + k),
                                   __ldg(phi_k + k), alpha_m1, beta_m1, wb));
        pm = __fadd_rn(pm, m0);
      }
    }
  }
  for (int o = span >> 1; o > 0; o >>= 1) {  // every lane of the warp
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    pm = __fadd_rn(pm, __shfl_xor_sync(0xffffffffu, pm, o));
  }
  if (t < tokens && sub == 0) {
    s_out[t] = s;
    pm_out[t] = pm;
  }
}

// The operands of the dense fold's column loop.
struct DenseLoop {
  const int* word_ids;     // (D, L)
  const float* counts;     // (D, L)
  const float* remainder;  // (D, L)
  const float* mu_in;      // (D, L, K)
  float* mu_out;           // (D, L, K)
  float* res_out;          // (D, L, K)
  float* theta;            // (D, K), updated in place
  float* phi;              // (W, K), updated in place
  float* phi_k;            // (K,), updated in place
  double* phi_k64;         // (K,) float64 total, updated in place, or null
  float* delta;            // (D, K) the column's Δ
  float* part;             // (groups, K) φ̂(k) partial sums
  float* live_out;         // (D, L)
  const int* seg_order;    // the row fold's order (gs_sweep.column_segments)
  const int* seg_pos;
  const int* seg_end;
  const int* seg_word;
  const int* seg_count;
  unsigned int* barrier;   // one int, zeroed before the launch
  int D, L, K, groups;
  float alpha_m1, beta_m1, wb;
};

// Second pass of one lane: normalise, write μ_new, the residual and Δ, add
// Δ into θ̂ (live tokens only). Returns μ_new.
__device__ __forceinline__ float dense_emit(const DenseLoop& p, size_t tok,
                                            int d, int k, float num,
                                            float m0, float th, float z,
                                            float c, bool live) {
  const float mu = __fdiv_rn(num, z);
  // μ_new and the residual are read by nothing later in the call: streaming
  // stores, so they leave L2 to θ̂, Δ and the φ̂ rows
  __stcs(p.mu_out + tok * p.K + k, mu);
  __stcs(p.res_out + tok * p.K + k, __fmul_rn(c, fabsf(__fsub_rn(mu, m0))));
  // a zero-count token's Δ is exactly 0: it neither changes θ̂ nor moves
  // the φ̂(k) group sums it enters
  const float dl = __fsub_rn(__fmul_rn(c, mu), __fmul_rn(c, m0));
  if (live) p.theta[(size_t)d * p.K + k] = __fadd_rn(th, dl);
  p.delta[(size_t)d * p.K + k] = dl;
  return mu;
}

// The dense E-step of token (d, l) by one CTA: every load of the
// register-held lanes is issued before the arithmetic that needs it.
__device__ __forceinline__ void dense_estep(const DenseLoop& p, int d, int l,
                                            float* red) {
  const int K = p.K;
  const size_t tok = (size_t)d * p.L + l;
  const float c = p.counts[tok];
  const float* mo = p.mu_in + tok * K;
  const float* th = p.theta + (size_t)d * K;
  const float* row = p.phi + (size_t)p.word_ids[tok] * K;
  float* s = p.delta + (size_t)d * K;
  float mv[kRegLanes], tv[kRegLanes], nv[kRegLanes], pv[kRegLanes];
#pragma unroll
  for (int i = 0; i < kRegLanes; ++i) {
    const int k = threadIdx.x + i * kDenseThreads;
    if (k < K) {
      mv[i] = __ldcs(mo + k);  // read once: streaming
      tv[i] = th[k];
      nv[i] = ld_l2(row + k);
      pv[i] = ld_l2(p.phi_k + k);
    }
  }
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kRegLanes; ++i) {
    const int k = threadIdx.x + i * kDenseThreads;
    if (k < K) {
      nv[i] = numerator(c, mv[i], tv[i], nv[i], pv[i], p.alpha_m1,
                        p.beta_m1, p.wb);
      part = __fadd_rn(part, nv[i]);
    }
  }
  // lanes past the registers stage their numerators in the Δ row
  for (int k = threadIdx.x + kRegLanes * kDenseThreads; k < K;
       k += kDenseThreads) {
    const float num = numerator(c, mo[k], th[k], ld_l2(row + k),
                                ld_l2(p.phi_k + k), p.alpha_m1, p.beta_m1,
                                p.wb);
    s[k] = num;  // read back below by this same thread
    part = __fadd_rn(part, num);
  }
  const float z =
      fmaxf(__fadd_rn(p.remainder[tok], block_sum(part, red)), 1e-30f);
  const bool live = c != 0.f;
  float mass = 0.f;
#pragma unroll
  for (int i = 0; i < kRegLanes; ++i) {
    const int k = threadIdx.x + i * kDenseThreads;
    if (k < K)
      mass = __fadd_rn(mass, dense_emit(p, tok, d, k, nv[i], mv[i], tv[i],
                                        z, c, live));
  }
  for (int k = threadIdx.x + kRegLanes * kDenseThreads; k < K;
       k += kDenseThreads)
    mass = __fadd_rn(mass, dense_emit(p, tok, d, k, s[k], mo[k], th[k], z, c,
                                      live));
  mass = block_sum(mass, red);
  if (threadIdx.x == 0) p.live_out[tok] = mass;
}

// v + x[order[q0]·stride] + … + x[order[q1−1]·stride], added in that
// order; sixteen loads in flight before their adds (a segment can hold
// hundreds of documents).
__device__ __forceinline__ float fold_segment(float v, const float* x,
                                              const int* order, int q0,
                                              int q1, int stride) {
  for (int q = q0; q < q1; q += 16) {
    float y[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      y[i] = q + i < q1 ? ld_l2(x + (size_t)order[q + i] * stride) : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (q + i < q1) v = __fadd_rn(v, y[i]);
  }
  return v;
}

// float4 helpers of the row fold (lanes added one by one, so the bits are
// those of the scalar fold)
__device__ __forceinline__ float4 ld_l2(const float4* q) { return __ldcg(q); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// φ̂_w[k..k+V) += the segment's Δ, in its document order (V = 4: K % 4 = 0,
// so every row and lane group is 16-byte aligned).
template <int V>
__device__ __forceinline__ void fold_row_lanes(const DenseLoop& p, size_t off,
                                               int s, int k) {
  const int q0 = p.seg_pos[off + s];
  const int q1 = p.seg_end[off + s];
  float* dst = p.phi + (size_t)p.seg_word[off + s] * p.K + k;
  if (V == 1) {
    *dst = fold_segment(ld_l2(dst), p.delta + k, p.seg_order + off, q0, q1,
                        p.K);
    return;
  }
  float4 v = ld_l2(reinterpret_cast<const float4*>(dst));
  int q = q0;
  for (; q + 2 <= q1; q += 2) {
    const float4 a = ld_l2(reinterpret_cast<const float4*>(
        p.delta + (size_t)p.seg_order[off + q] * p.K + k));
    const float4 b = ld_l2(reinterpret_cast<const float4*>(
        p.delta + (size_t)p.seg_order[off + q + 1] * p.K + k));
    v = add4(add4(v, a), b);
  }
  if (q < q1)
    v = add4(v, ld_l2(reinterpret_cast<const float4*>(
                    p.delta + (size_t)p.seg_order[off + q] * p.K + k)));
  *reinterpret_cast<float4*>(dst) = v;
}

// kVec: the row fold in float4 lane groups (K % 4 = 0).
template <bool kVec>
__global__ void __launch_bounds__(kDenseThreads, kDenseCtasPerSm)
    dense_loop_kernel(const DenseLoop p) {
  __shared__ float red[33];
  const int K = p.K;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lanes = kVec ? K / 4 : K;  // lane groups a φ̂ row
  for (int l = 0; l < p.L; ++l) {
    for (int d = blockIdx.x; d < p.D; d += gridDim.x)
      dense_estep(p, d, l, red);
    grid_barrier(p.barrier);
    // a thread an item: (row segment, lane or group of 4 lanes), then
    // (document group, lane)
    const size_t off = (size_t)l * p.D;
    const int nrow = p.seg_count[l] * lanes;
    const int items = nrow + p.groups * K;
    for (int i = gtid; i < items; i += nthreads) {
      if (i < nrow) {
        const int s = i / lanes;
        const int k = i - s * lanes;
        if (kVec)
          fold_row_lanes<4>(p, off, s, 4 * k);
        else
          fold_row_lanes<1>(p, off, s, k);
      } else {
        // Δ of documents [g·kGroupDocs, (g+1)·kGroupDocs), in order; all
        // loads in flight before the adds (past D: + 0, which changes no
        // bits)
        const int g = (i - nrow) / K;
        const int k = (i - nrow) - g * K;
        const int d0 = g * kGroupDocs;
        float x[kGroupDocs];
#pragma unroll
        for (int j = 0; j < kGroupDocs; ++j)
          x[j] = d0 + j < p.D ? ld_l2(p.delta + (size_t)(d0 + j) * K + k)
                              : 0.f;
        float acc = x[0];
#pragma unroll
        for (int j = 1; j < kGroupDocs; ++j) acc = __fadd_rn(acc, x[j]);
        p.part[(size_t)g * K + k] = acc;
      }
    }
    grid_barrier(p.barrier);
    // φ̂(k) += the groups' sums, in group order, sixteen loads in flight
    for (int k = gtid; k < K; k += nthreads) {
      float acc = ld_l2(p.part + k);
      int g = 1;
      for (; g + 16 <= p.groups; g += 16) {
        float x[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          x[j] = ld_l2(p.part + (size_t)(g + j) * K + k);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc = __fadd_rn(acc, x[j]);
      }
      for (; g < p.groups; ++g)
        acc = __fadd_rn(acc, ld_l2(p.part + (size_t)g * K + k));
      p.phi_k[k] = __fadd_rn(ld_l2(p.phi_k + k), acc);
      active::add_total64(p.phi_k64, k, acc);
    }
    if (l + 1 < p.L) grid_barrier(p.barrier);
  }
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
// (token_active and pm_out unused; path 0: 16-byte lanes, 1: scalar);
// else the scheduled probe with `path` threads a token (a power of two ≤
// 32), token_active (D, L) bytes, and pm_out receives the previous active
// mass (sharded_sweep.probe_path). Returns cudaGetLastError().
int sharded_probe_launch(const void* word_ids, const void* counts,
                         const void* token_active, const void* mu,
                         const void* theta, const void* phi,
                         const void* phi_k, const void* word_topics, int A,
                         void* s_out, void* pm_out, int D, int L, int K,
                         int path, float alpha_m1, float beta_m1, float wb,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tokens = (long long)D * L;
  const int* wid = static_cast<const int*>(word_ids);
  const float* cnt = static_cast<const float*>(counts);
  const float* m = static_cast<const float*>(mu);
  const float* th = static_cast<const float*>(theta);
  const float* ph = static_cast<const float*>(phi);
  const float* pk = static_cast<const float*>(phi_k);
  float* s = static_cast<float*>(s_out);
  if (word_topics != nullptr) {
    const long long threads = tokens * path;
    const unsigned grid =
        (unsigned)((threads + kWarpThreads - 1) / kWarpThreads);
    launch_log::record("probe_sched_kernel", 0,
                       reinterpret_cast<const void*>(&probe_sched_kernel),
                       grid, kWarpThreads, 0);
    probe_sched_kernel<<<grid, kWarpThreads, 0, st>>>(
        wid, cnt, static_cast<const uint8_t*>(token_active), m, th, ph, pk,
        static_cast<const int*>(word_topics), A, path, s,
        static_cast<float*>(pm_out), tokens, L, K, alpha_m1, beta_m1, wb);
  } else if (path == 0) {
    launch_log::record("probe_dense_kernel", 0,
                       reinterpret_cast<const void*>(&probe_dense_kernel<true>),
                       warp_grid(tokens), kWarpThreads, 0);
    probe_dense_kernel<true><<<warp_grid(tokens), kWarpThreads, 0, st>>>(
        wid, cnt, m, th, ph, pk, s, tokens, L, K, alpha_m1, beta_m1, wb);
  } else {
    launch_log::record(
        "probe_dense_kernel", 1,
        reinterpret_cast<const void*>(&probe_dense_kernel<false>),
        warp_grid(tokens), kWarpThreads, 0);
    probe_dense_kernel<false><<<warp_grid(tokens), kWarpThreads, 0, st>>>(
        wid, cnt, m, th, ph, pk, s, tokens, L, K, alpha_m1, beta_m1, wb);
  }
  return cudaGetLastError();
}

// The scheduled fold's streaming pass on `stream` (2 launches): mu_out =
// mu_in, then res_out = 0, over n floats. Returns the first CUDA error.
int sharded_pass_launch(const void* mu_in, void* mu_out, void* res_out,
                        size_t n, void* stream) {
  return active::launch_stream_pass(
      static_cast<const float*>(mu_in), static_cast<float*>(mu_out),
      static_cast<float*>(res_out), n, static_cast<cudaStream_t>(stream));
}

// Phase C on `stream` (scheduled: after its streaming pass). theta, phi and
// phi_k are updated in place, and so is phi_k64, φ̂(k)'s (K,) float64
// total, where it is not NULL; mu_out and res_out are (D, L, K); live_out is
// (D, L). word_topics == NULL is the dense fold: seg_* are its row fold's
// order over the live tokens (count ≠ 0; gs_sweep.column_segments), delta a
// (D, K) and part a (ceil(D / 32), K) scratch. Else the scheduled fold:
// token_active is (D, L) bytes, prev_mass (D, L), row_order/row_key and
// pair_order/pair_key the two folds' orders over the live tokens (token
// active and count ≠ 0; sweep_active.cuh), compact and parts (D, A)
// scratches. barrier is one int. u == NULL skips the pre-log loglik
// launch. *launches receives the operations enqueued. Returns the first
// nonzero CUDA error (0 = every launch was accepted).
int sharded_fold_launch(const void* word_ids, const void* counts,
                        const void* token_active, const void* remainder,
                        const void* prev_mass, const void* mu_in,
                        void* mu_out, void* res_out, void* theta, void* phi,
                        void* phi_k, void* phi_k64, const void* word_topics,
                        int A, const void* seg_order, const void* seg_pos,
                        const void* seg_end, const void* seg_word,
                        const void* seg_count, const void* row_order,
                        const void* row_key, const void* pair_order,
                        const void* pair_key, void* delta, void* part,
                        void* compact, void* parts, void* barrier,
                        void* live_out, void* u, int D, int L,
                        int K, float alpha_m1, float beta_m1, float wb,
                        int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* wid = static_cast<const int*>(word_ids);
  float* th = static_cast<float*>(theta);
  float* ph = static_cast<float*>(phi);
  float* pk = static_cast<float*>(phi_k);
  double* pk64 = static_cast<double*>(phi_k64);
  cudaError_t err;
  if (word_topics != nullptr) {
    active::ActiveLoop p;
    p.word_ids = wid;
    p.counts = static_cast<const float*>(counts);
    p.token_active = static_cast<const uint8_t*>(token_active);
    p.mu_in = static_cast<const float*>(mu_in);
    p.mu_out = static_cast<float*>(mu_out);
    p.res_out = static_cast<float*>(res_out);
    p.theta = th;
    p.phi = ph;
    p.phi_k = pk;
    p.phi_k64 = pk64;
    p.word_topics = static_cast<const int*>(word_topics);
    p.remainder = static_cast<const float*>(remainder);
    p.prev_mass = static_cast<const float*>(prev_mass);
    p.live_out = static_cast<float*>(live_out);
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
    err = active::launch_active_sweep<true>(p, st, launches);
    if (err != cudaSuccess) return err;
  } else {
    DenseLoop p;
    p.word_ids = wid;
    p.counts = static_cast<const float*>(counts);
    p.remainder = static_cast<const float*>(remainder);
    p.mu_in = static_cast<const float*>(mu_in);
    p.mu_out = static_cast<float*>(mu_out);
    p.res_out = static_cast<float*>(res_out);
    p.theta = th;
    p.phi = ph;
    p.phi_k = pk;
    p.phi_k64 = pk64;
    p.delta = static_cast<float*>(delta);
    p.part = static_cast<float*>(part);
    p.live_out = static_cast<float*>(live_out);
    p.seg_order = static_cast<const int*>(seg_order);
    p.seg_pos = static_cast<const int*>(seg_pos);
    p.seg_end = static_cast<const int*>(seg_end);
    p.seg_word = static_cast<const int*>(seg_word);
    p.seg_count = static_cast<const int*>(seg_count);
    p.barrier = static_cast<unsigned int*>(barrier);
    p.D = D;
    p.L = L;
    p.K = K;
    p.groups = (D + kGroupDocs - 1) / kGroupDocs;
    p.alpha_m1 = alpha_m1;
    p.beta_m1 = beta_m1;
    p.wb = wb;
    *launches = 0;
    err = active::reset_barrier(p.barrier, st);
    if (err != cudaSuccess) return err;
    ++*launches;
    // rows in float4 lane groups when K % 4 = 0 (φ̂ and Δ are the
    // wrapper's own allocations, 16-byte aligned)
    const bool vec = K % 4 == 0;
    // a CTA a document in the E-step
    err = vec ? active::launch_cooperative(dense_loop_kernel<true>, p, D,
                                           kDenseCtasPerSm, kDenseThreads, st,
                                           "dense_loop_kernel", 0)
              : active::launch_cooperative(dense_loop_kernel<false>, p, D,
                                           kDenseCtasPerSm, kDenseThreads,
                                           st, "dense_loop_kernel", 1);
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  if (u != nullptr) {
    const long long tokens = (long long)D * L;
    launch_log::record("loglik_u_kernel", 0,
                       reinterpret_cast<const void*>(&loglik_u_kernel),
                       warp_grid(tokens), kWarpThreads, 0);
    loglik_u_kernel<<<warp_grid(tokens), kWarpThreads, 0, st>>>(
        wid, th, ph, pk, static_cast<float*>(u), tokens, L, K, alpha_m1,
        beta_m1, wb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

const char* sharded_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_QUERY(probe_dense_kernel)
LAUNCH_LOG_QUERY(probe_sched_kernel)
LAUNCH_LOG_QUERY(dense_loop_kernel)
LAUNCH_LOG_QUERY(loglik_u_kernel)
LAUNCH_LOG_LIBRARY(sharded_sweep)
