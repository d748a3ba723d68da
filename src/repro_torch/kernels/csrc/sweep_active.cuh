// The active-set column loop shared by the scheduled sweep
// (scheduled_sweep.cu) and the sharded fold (sharded_sweep.cu), for NVIDIA
// Hopper (sm_90a); its copy pass, grid barrier, cooperative launch and
// φ̂(k) fold (fold_blocks, fold_topic_at, templated on the loop's operands)
// also serve topk_estep.cu's block loop:
//
//   * copy_kernel and    — the streaming pass: μ_new = μ_old, then
//     zero_kernel          residual = 0, for every (token, lane) entry,
//                          before the column loop, which then writes only
//                          the active lanes of the active tokens;
//   * grid_barrier       — a barrier across the CTAs of a cooperative launch;
//   * active_loop_kernel — ONE persistent launch for all L columns of a
//                          scheduled sweep: per column an E-step phase and
//                          two fold phases, a barrier after each.
//
// The bytes. The outputs are full-K, so the sweep's bytes are the pass's
// (μ read, μ_new and the residual written: 3·D·L·K floats), while the loop
// computes on D·A lanes a column. The pass runs first, over the whole card,
// a copy and then a zeroing launch (on this card a copy stream and then a
// write stream run nearer the peak rate than the three streams interleaved
// in one kernel); the loop then overwrites the active lanes. Run beside the
// pass on a second stream, the loop's latency-bound phases slowed several
// times over under the pass's traffic, so the two run one after the other.
//
// The column loop. Per column the active work is small: D documents × A
// active lanes (16k lanes at D = 1,024, A = 16). As 2L launches (an E-step
// and a fold a column) the launch gaps and the per-launch ramp set the time;
// here one cooperative launch (cudaLaunchCooperativeKernel, so that every
// CTA is co-resident and the barrier cannot deadlock) walks the L columns,
// and a hand-written barrier on a global counter (the arrival-counter
// scheme below, without -rdc) separates the phases: the E-step of column l
// reads φ̂ and φ̂(k) as the fold of column l−1 left them (Gauss-Seidel
// across columns), and the documents of one column are Jacobi (they read
// the same statistics). Statistics that other CTAs of the launch write (φ̂
// rows, φ̂(k), the compact Δ) are read through L2 (__ldcg), never through
// the read-only or L1 path.
//
// E-step phase: one warp per document (documents stride over the grid's
// warps, so a document stays with one warp, and its θ̂ row with one SM, for
// the whole call). For an active token of count x and word w, on the word's
// A active lanes k = word_topics[w, a]:
//
//   ex = x·μ_old;  num = (max(θ̂−ex,0)+α−1)(max(φ̂_w−ex,0)+β−1)/(φ̂(k)−ex+wb)
//   μ_new = num / max(rem + Σ_A num, 1e-30) · pm                   (eq. 38)
//   Δ = x·(μ_new − μ_old);  res = |Δ|;  θ̂_d += Δ
//
// unsharded: rem = 0 and pm = Σ_A μ_old; sharded: rem and pm are the (D, L)
// cross-shard columns. The two sums are fixed-order warp shuffles. Δ goes to
// the compact (D, A) scratch, pair (d, a) at d·A + a.
//
// Fold phases, without atomics and in a fixed order, so two launches give
// the same bits. The wrapper sorts, once per call and on the device, each
// column's live documents by word id and its live (document, slot) pairs
// by topic, stably, so the documents of one word and the pairs of one topic
// form runs in document order. Runs can be long (hundreds of documents of
// a frequent word in one column; of pairs of a topic active for many
// words).
//   * rows: the thread at a word run's first position adds the run's
//     slot-a Δ into the word's φ̂ row entry one by one: φ̂ ← ((φ̂ + Δ_d1) +
//     Δ_d2)…, the order of the TPU kernel's serial scatter and of the
//     reference's accumulating index_put_ (another order moves the rows,
//     and through them later columns' μ, past the sweep tolerance), with
//     sixteen loads in flight ahead of the adds;
//   * φ̂(k): the order is free (the reference sums Δ over the documents
//     first), so each run is a segmented reduction: in fold phase (a) a
//     warp sums each run's part in a block of 32 sorted positions (a fixed
//     shuffle pattern); in fold phase (b), after a barrier and beside the
//     rows, the thread at a run's first position adds its block parts in
//     block order and the run's total once to φ̂(k): φ̂(k) + ΣΔ, the
//     reference's `ptot + delta.sum(0)` with the zero entries left out.
// It reads D·A values a column, not D·K. Each order is two int32 arrays a
// column: the sorted documents (pairs d·A + a), -1 past the column's live
// ones, and their keys (words, topics).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace active {

constexpr int kThreads = 256;      // CTAs of the pass and the loop
constexpr int kPassCtasPerSm = 4;  // the pass: 1,024 threads an SM
constexpr int kLoopCtasPerSm = 2;  // the scheduled loop: few CTAs, cheap barriers

// The eq. 13 self-excluded numerator of one (token, lane).
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

// A load of state that other CTAs of the launch write: through L2.
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }

// Barrier across every CTA of a cooperative launch, on one zeroed int (the
// scheme of cooperative groups' grid sync, written out so that no -rdc
// build is needed). Each CTA adds 1, CTA 0 adds 2^31 − (G − 1): the top bit
// flips exactly when all G have arrived, and the low bits are back to zero
// for the next barrier. Thread 0 arrives with a release (after the CTA's
// bar.sync, so the CTA's writes go before it) and polls with acquires.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned int old, now;
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(now) : "l"(bar) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// The streaming pass: dst = src (copy_kernel), then zero = 0 (zero_kernel);
// 16 bytes a thread and access (vec: the bases 16-byte aligned), four
// accesses in flight a thread, a scalar tail past the last whole float4.
// Streaming (evict-first) accesses: the bytes are used once.
__global__ void __launch_bounds__(kThreads)
    copy_kernel(const float* __restrict__ src, float* __restrict__ dst,
                size_t n, int vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t done = 0;
  if (vec) {
    const size_t n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    size_t j = i;
    for (; j + 3 * stride < n4; j += 4 * stride) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcs(s4 + j + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) __stcs(d4 + j + u * stride, v[u]);
    }
    for (; j < n4; j += stride) __stcs(d4 + j, __ldcs(s4 + j));
    done = n4 << 2;
  }
  for (size_t j = done + i; j < n; j += stride) dst[j] = src[j];
}

__global__ void __launch_bounds__(kThreads)
    zero_kernel(float* __restrict__ zero, size_t n, int vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t done = 0;
  if (vec) {
    const size_t n4 = n >> 2;
    float4* z4 = reinterpret_cast<float4*>(zero);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (size_t j = i; j < n4; j += stride) __stcs(z4 + j, z);
    done = n4 << 2;
  }
  for (size_t j = done + i; j < n; j += stride) zero[j] = 0.f;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Launch the streaming copy dst = src on `stream` (1 launch); returns the
// error.
inline cudaError_t launch_copy(const float* src, float* dst, size_t n,
                               cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  const int vec = ((a | b) & 15u) == 0;
  const size_t cap = (size_t)sm_count() * kPassCtasPerSm;
  size_t grid = ((vec ? (n + 3) / 4 : n) + kThreads - 1) / kThreads;
  if (grid > cap) grid = cap;
  if (grid == 0) return cudaSuccess;
  launch_log::record("copy_kernel", 0,
                     reinterpret_cast<const void*>(&copy_kernel), grid,
                     kThreads, 0);
  copy_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(src, dst, n, vec);
  return cudaGetLastError();
}

// Launch the streaming pass on `stream` (2 launches); returns the first
// error.
inline cudaError_t launch_stream_pass(const float* src, float* dst,
                                      float* zero, size_t n,
                                      cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  cudaError_t err = launch_copy(src, dst, n, stream);
  if (err != cudaSuccess) return err;
  const int vec_zero = (reinterpret_cast<uintptr_t>(zero) & 15u) == 0;
  const size_t cap = (size_t)sm_count() * kPassCtasPerSm;
  size_t grid = ((vec_zero ? (n + 3) / 4 : n) + kThreads - 1) / kThreads;
  if (grid > cap) grid = cap;
  launch_log::record("zero_kernel", 0,
                     reinterpret_cast<const void*>(&zero_kernel), grid,
                     kThreads, 0);
  zero_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(zero, n, vec_zero);
  return cudaGetLastError();
}

// Launch a persistent kernel cooperatively: `want` CTAs of `threads` with
// `smem` bytes of dynamic shared memory, capped at what the card holds at
// once (occupancy × SMs) and at `per_sm` CTAs an SM. `name` and `variant`
// identify the kernel in the library's launch records.
template <typename Params>
cudaError_t launch_cooperative(void (*kernel)(Params), const Params& p,
                               int want, int per_sm, int threads,
                               cudaStream_t stream, const char* name,
                               int variant, size_t smem = 0) {
  int fit = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int cap = sm_count() * (fit < per_sm ? fit : per_sm);
  const int grid = want < 1 ? 1 : (want > cap ? cap : want);
  launch_log::record(name, variant, reinterpret_cast<const void*>(kernel),
                     grid, threads, smem);
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                    threads, args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Zero the barrier's int on `stream`.
inline cudaError_t reset_barrier(unsigned int* bar, cudaStream_t stream) {
  return cudaMemsetAsync(bar, 0, sizeof(unsigned int), stream);
}

// The operands of one scheduled column loop (see the file comment).
struct ActiveLoop {
  const int* word_ids;        // (D, L)
  const float* counts;        // (D, L)
  const uint8_t* token_active;  // (D, L)
  const float* mu_in;         // (D, L, K)
  float* mu_out;              // (D, L, K), = mu_in on entry (the pass)
  float* res_out;             // (D, L, K), = 0 on entry (the pass)
  float* theta;               // (D, K), updated in place
  float* phi;                 // (W, K), updated in place
  float* phi_k;               // (K,), updated in place
  const int* word_topics;     // (W, A)
  const float* remainder;     // (D, L) peers' sums (sharded only)
  const float* prev_mass;     // (D, L) global Σ_A μ_old (sharded only)
  float* live_out;            // (D, L) Σ_A μ_new (sharded only)
  const int* row_order;       // rows: (L, D) sorted documents, -1 past
  const int* row_key;         // (L, D) their words
  const int* pair_order;      // φ̂(k): (L, D·A) sorted pairs d·A + a, -1 past
  const int* pair_key;        // (L, D·A) their topics
  float* compact;             // (D, A) the column's Δ
  float* parts;               // (D·A) the topic runs' block parts
  unsigned int* barrier;      // one int, zeroed before the launch
  int D, L, K, A;
  float alpha_m1, beta_m1, wb;
};

__device__ __forceinline__ float warp_total(float v) {
  return __shfl_sync(0xffffffffu, sweep::warp_sum(v), 0);
}

// The E-step of token (d, l) by one warp.
template <bool kSharded>
__device__ __forceinline__ void active_estep(const ActiveLoop& p, int d,
                                             int l, int lane) {
  const size_t tok = (size_t)d * p.L + l;
  if (!p.token_active[tok]) {  // uniform across the warp
    if (kSharded && lane == 0) p.live_out[tok] = 0.f;
    return;
  }
  const int A = p.A;
  const int K = p.K;
  const float c = p.counts[tok];
  const int w = p.word_ids[tok];
  const int* top = p.word_topics + (size_t)w * A;
  const float* mo = p.mu_in + tok * K;
  const float* row = p.phi + (size_t)w * K;
  float* th = p.theta + (size_t)d * K;
  float* cp = p.compact + (size_t)d * A;
  float ns = 0.f;  // Σ_A num
  float pm = 0.f;  // Σ_A μ_old (unsharded)
  for (int a = lane; a < A; a += 32) {
    const int k = top[a];
    const float m0 = mo[k];
    const float num = numerator(c, m0, th[k], ld_l2(row + k),
                                ld_l2(p.phi_k + k), p.alpha_m1, p.beta_m1,
                                p.wb);
    cp[a] = num;  // staged; read back below by this same thread
    ns = __fadd_rn(ns, num);
    if (!kSharded) pm = __fadd_rn(pm, m0);
  }
  ns = warp_total(ns);
  float z, mass_in;
  if (kSharded) {
    z = fmaxf(__fadd_rn(p.remainder[tok], ns), 1e-30f);
    mass_in = p.prev_mass[tok];
  } else {
    z = fmaxf(ns, 1e-30f);
    mass_in = warp_total(pm);
  }
  // Δ of a zero-count token is exactly zero: it neither changes θ̂ nor
  // enters the fold (its μ still moves, as in the reference).
  const bool live = c != 0.f;
  float* mn = p.mu_out + tok * K;
  float* rs = p.res_out + tok * K;
  float mass = 0.f;
  for (int a = lane; a < A; a += 32) {
    const int k = top[a];
    const float m0 = mo[k];
    const float mu = __fmul_rn(__fdiv_rn(cp[a], z), mass_in);
    const float dl = __fmul_rn(c, __fsub_rn(mu, m0));
    mn[k] = mu;
    rs[k] = fabsf(dl);
    if (kSharded) mass = __fadd_rn(mass, mu);
    if (live) {
      th[k] = __fadd_rn(th[k], dl);
      cp[a] = dl;
    }
  }
  if (kSharded) {
    mass = sweep::warp_sum(mass);
    if (lane == 0) p.live_out[tok] = mass;
  }
}

// Fold phase (a), one warp: the sorted positions [32b, 32b + 32) of one
// column's pair order (n positions, -1 past the live ones). Each topic run
// that meets the block gets its part in the block — the Δ values summed in
// a segmented scan, a fixed shuffle pattern — stored at the part's first
// position in `part`.
__device__ __forceinline__ void scan_block(const int* order, const int* key,
                                           int n, int b, const float* vals,
                                           float* part, int lane) {
  const int q = 32 * b + lane;
  const int o = q < n ? order[q] : -1;
  const int k = o >= 0 ? key[q] : -1;
  float x = o >= 0 ? ld_l2(vals + o) : 0.f;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, s);
    const int ky = __shfl_up_sync(0xffffffffu, k, s);
    if (lane >= s && ky == k) x = __fadd_rn(y, x);
  }
  const int kprev = __shfl_up_sync(0xffffffffu, k, 1);
  const int knext = __shfl_down_sync(0xffffffffu, k, 1);
  const unsigned int heads =
      __ballot_sync(0xffffffffu, lane == 0 || kprev != k);
  if (o >= 0 && (lane == 31 || knext != k)) {
    const int first = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
    part[32 * b + first] = x;
  }
}

// Fold phase (b): the total of the run of topic k that starts at sorted
// position q — its block parts, in block order (a later part starts at a
// block boundary); four blocks in flight.
__device__ __forceinline__ float run_total(const int* key, int n, int q,
                                           int k, const float* part) {
  float s = ld_l2(part + q);
  for (int r = (q / 32 + 1) * 32; r < n; r += 4 * 32) {
    int kk[4];
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + 32 * i;
      kk[i] = rr < n ? key[rr] : -1;
      x[i] = kk[i] == k ? ld_l2(part + rr) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kk[i] != k) return s;
      s = __fadd_rn(s, x[i]);
    }
  }
  return s;
}

// The exact-order row fold (fold phase b): the thread at the first sorted
// position q of word w's documents adds their slot-a Δ into φ̂_w's entry,
// one by one in document order, sixteen loads in flight ahead of the adds.
__device__ __forceinline__ void fold_word_run(const ActiveLoop& p,
                                              const int* order,
                                              const int* key, int q, int w,
                                              int a) {
  const int A = p.A;
  float* dst = p.phi + (size_t)w * p.K + p.word_topics[(size_t)w * A + a];
  float v = ld_l2(dst);
  for (int r = q; r < p.D; r += 16) {
    float y[16];
    bool in[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      in[i] = r + i < p.D && key[r + i] == w && order[r + i] >= 0;
      y[i] = in[i] ? ld_l2(p.compact + (size_t)order[r + i] * A + a) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (!in[i]) {
        *dst = v;
        return;
      }
      v = __fadd_rn(v, y[i]);
    }
  }
  *dst = v;
}

// Fold phase (a) of one step's pair order (npairs sorted positions, the
// step's Δ in p.compact): a warp a block of 32 positions. P is a loop's
// operands: ActiveLoop, or topk_estep.cu's BlockLoop.
template <class P>
__device__ __forceinline__ void fold_blocks(const P& p, const int* order,
                                            const int* key, int npairs,
                                            int gwarp, int nwarps, int lane) {
  for (int b = gwarp; 32 * b < npairs; b += nwarps)
    scan_block(order, key, npairs, b, p.compact, p.parts, lane);
}

// Fold phase (b) at sorted pair position q (of npairs): where a topic's
// run starts, add the run's total, from fold phase (a)'s parts, to φ̂(k).
template <class P>
__device__ __forceinline__ void fold_topic_at(const P& p,
                                              const int* pair_order,
                                              const int* pair_key,
                                              int npairs, int q) {
  if (pair_order[q] < 0) return;
  const int k = pair_key[q];
  if (q == 0 || pair_key[q - 1] != k)
    p.phi_k[k] = __fadd_rn(ld_l2(p.phi_k + k),
                           run_total(pair_key, npairs, q, k, p.parts));
}

// Fold phase (a) of column l: a warp a block of the pair order.
__device__ __forceinline__ void active_fold_blocks(const ActiveLoop& p, int l,
                                                   int gwarp, int nwarps,
                                                   int lane) {
  const int npairs = p.D * p.A;
  fold_blocks(p, p.pair_order + (size_t)l * npairs,
              p.pair_key + (size_t)l * npairs, npairs, gwarp, nwarps, lane);
}

// Fold phase (b) of column l, a thread an item: (sorted row position, slot)
// items, where a word's documents start, fold them into its φ̂ row entry;
// pair positions, fold_topic_at.
__device__ __forceinline__ void active_fold_runs(const ActiveLoop& p, int l,
                                                 int gtid, int nthreads) {
  const int D = p.D;
  const int npairs = D * p.A;
  const int* row_order = p.row_order + (size_t)l * D;
  const int* row_key = p.row_key + (size_t)l * D;
  const int* pair_order = p.pair_order + (size_t)l * npairs;
  const int* pair_key = p.pair_key + (size_t)l * npairs;
  for (int i = gtid; i < 2 * npairs; i += nthreads) {
    if (i < npairs) {
      const int a = i / D;
      const int q = i - a * D;
      if (row_order[q] < 0) continue;
      const int w = row_key[q];
      if (q == 0 || row_key[q - 1] != w)
        fold_word_run(p, row_order, row_key, q, w, a);
    } else {
      fold_topic_at(p, pair_order, pair_key, npairs, i - npairs);
    }
  }
}

template <bool kSharded>
__global__ void __launch_bounds__(kThreads)
    active_loop_kernel(const ActiveLoop p) {
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int gwarp = gtid >> 5;
  const int nwarps = nthreads >> 5;
  for (int l = 0; l < p.L; ++l) {
    for (int d = gwarp; d < p.D; d += nwarps)
      active_estep<kSharded>(p, d, l, lane);
    grid_barrier(p.barrier);
    active_fold_blocks(p, l, gwarp, nwarps, lane);
    grid_barrier(p.barrier);
    active_fold_runs(p, l, gtid, nthreads);
    if (l + 1 < p.L) grid_barrier(p.barrier);
  }
}

// The scheduled sweep's column loop on `stream`, after its streaming pass
// (launch_stream_pass, which the wrapper enqueues first, so that the fold
// orders and output copies it builds next queue up behind the pass): the
// barrier's zeroing and the persistent loop (2 operations; `*launches` gets
// the count). Returns the first error.
template <bool kSharded>
cudaError_t launch_active_sweep(const ActiveLoop& p, cudaStream_t stream,
                                int* launches) {
  *launches = 0;
  cudaError_t err = reset_barrier(p.barrier, stream);
  if (err != cudaSuccess) return err;
  ++*launches;
  // a warp a document in the E-step and a block of 32 positions in the
  // fold's phase (a), 2·D·A items in its phase (b)
  const long long work = (long long)p.D * (p.A > 16 ? 2 * p.A : 32);
  const int want = (int)((work + kThreads - 1) / kThreads);
  err = launch_cooperative(active_loop_kernel<kSharded>, p, want,
                           kLoopCtasPerSm, kThreads, stream,
                           "active_loop_kernel", kSharded ? 1 : 0);
  if (err != cudaSuccess) return err;
  ++*launches;
  return cudaSuccess;
}

}  // namespace active

LAUNCH_LOG_QUERY(copy_kernel)
LAUNCH_LOG_QUERY(zero_kernel)
LAUNCH_LOG_QUERY(active_loop_kernel)
