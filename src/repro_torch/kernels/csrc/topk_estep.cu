// Scheduled active-set E-step (paper §3.1, eq. 38) for NVIDIA Hopper
// (sm_90a): over (tokens × A) slabs, and as one persistent loop over the
// blocks of a blocked or "scan" scheduled sweep.
//
// Replaces the TPU kernel kernels/topk_estep.py::topk_estep_pallas of the
// JAX package. Per token t of count x_t, on each of its word's A active
// topics a, from θ̂_a, φ̂_a, φ̂(k)_a and the previous normalised μ_prev,a:
//
//   ex  = x_t·μ_prev,a                                   (eq. 13 exclusion)
//   num = (max(θ̂_a−ex,0)+α−1)(max(φ̂_a−ex,0)+β−1)/(φ̂(k)_a−ex+W(β−1))
//   num = 0 where μ_prev,a ≤ 0 and θ̂_a ≤ 0               (the pad-lane rule)
//   μ_a = num / max(Σ_a num, 1e-30) · Σ_a μ_prev,a        (eq. 38 renorm)
//
// Tokens the λ_w word mask leaves inactive keep μ_prev; every token gets
// delta = x_t·(μ_a − μ_prev,a). The pad-lane rule is the TPU kernel's
// (topk_estep.py:36-38), not ref.topk_estep_ref's, which has none: a lane
// with no previous mass and no θ̂ mass would otherwise take renorm mass.
//
// 1. The slab kernel (topk_estep_launch): the caller gathers the (T, A)
//    slabs. Bound on this card: device-memory bytes, and below that the
//    launch. At the stream_1k width (A = 16) a block of T = 16,384 tokens
//    moves 4 input slabs, 2 output slabs, counts and the mask, ≈ 6.4 MB:
//    ≈ 1.9 µs at 3.35 TB/s, about the cost of the launch itself. One warp
//    per token, eight tokens per CTA; lane j takes the active lanes j,
//    j + 32, … The first pass stages the numerators in the μ output and
//    sums them and μ_prev per thread; two warp sums in a fixed shuffle
//    order give every lane the same denominator and previous mass; the
//    second pass normalises and writes delta. A token's bits depend on
//    nothing but its own row, and nothing is atomic.
//
// 2. The block loop (topk_loop_launch): the whole blocked sweep, B blocks
//    of nb = ⌈L/B⌉ columns (the last narrower), in ONE cooperative launch
//    (sweep_active.cuh's grid barrier and fold phases), in place of a
//    Python loop of ~20 launches a block (four slab gathers, this slab
//    kernel, three sorted index_put_ folds, the μ and |Δ| scatters). Per
//    block:
//
//    * E-step phase: one warp per document, which owns its θ̂ row for the
//      whole call, walks the document's nb tokens, reading θ̂_d, φ̂_w,
//      φ̂(k) as the previous block left them and μ_prev from μ at the
//      word's topic ids (no gathered slabs): it writes μ at the active
//      lanes, |Δ| and the token's topic ids (D, L, A), and Δ into a compact
//      (D, nb, A) scratch. Then the same warp folds θ̂_d column by column
//      in order (a document's tokens may share topics within a block; the
//      plain version's index_add_ adds them in that order). A live token
//      whose word no other token of the block has (the wrapper's kSolo)
//      adds Δ to its φ̂ row here: no other token of the block reads it.
//    * fold phases, after a barrier each: φ̂(k) by run sums over topic
//      (sweep_active.cuh's fold_blocks and fold_topic_at); the φ̂ rows, a
//      warp a word run, lane a adding slot a's Δ serially in (d, c) order
//      (a tree order moves bits past the sweep tolerance). A block's word
//      runs are long (a frequent word is in most of its D·nb tokens):
//      sweep_active.cuh's thread-a-(run, slot) walk, three dependent loads
//      an entry, suits a column's runs but took most of the loop's time at
//      nb = 16, so here the warp reads a run's entry ids 32 at a time,
//      coalesced, and loads their Δ rows ahead of the adds. The visiting orders, per block over
//      the D·nb entries d·nb + c, are built once a call by the wrapper.
//
//    Within a block every token reads the pre-block statistics (Jacobi, as
//    the JAX package's lax.scan body); blocks are Gauss-Seidel. Bound:
//    the bytes of the contract's new outputs — μ (D, L, K) read and
//    written, φ̂ read and written — 12.6 GB a sweep at stream_1k (3.8 ms at
//    3.35 TB/s); the μ copy goes first, as a streaming pass over the
//    whole card (active::copy_kernel), then the loop touches D·L·A lanes.
//    The E-step and θ̂ fold of a document stay with one warp, the folds
//    take fixed orders, nothing is atomic: two launches give the same
//    bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_active.cuh"
#include "sweep_common.cuh"

namespace {

using sweep::warp_sum;

constexpr int kWarpThreads = 256;
constexpr int kWarps = kWarpThreads / 32;  // tokens per CTA

__global__ void __launch_bounds__(kWarpThreads)
    topk_estep_kernel(const float* __restrict__ theta_a,
                      const float* __restrict__ phi_a,
                      const float* __restrict__ ptot_a,
                      const float* __restrict__ mu_prev,
                      const float* __restrict__ counts,
                      const uint8_t* __restrict__ active,
                      float* __restrict__ mu_out,
                      float* __restrict__ delta_out, long long T, int A,
                      float alpha_m1, float beta_m1, float wb) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform across the warp
  const size_t base = (size_t)t * A;
  const float c = counts[t];
  float s = 0.f, pm = 0.f;
  for (int a = lane; a < A; a += 32) {
    const size_t i = base + a;
    const float m0 = mu_prev[i];
    const float th0 = theta_a[i];
    const float ex = __fmul_rn(c, m0);
    const float th = fmaxf(__fsub_rn(th0, ex), 0.f);
    const float ph = fmaxf(__fsub_rn(phi_a[i], ex), 0.f);
    const float q = __fsub_rn(ptot_a[i], ex);
    float num = __fdiv_rn(
        __fmul_rn(__fadd_rn(th, alpha_m1), __fadd_rn(ph, beta_m1)),
        __fadd_rn(q, wb));
    if (m0 <= 0.f && th0 <= 0.f) num = 0.f;  // pad lane
    mu_out[i] = num;
    s = __fadd_rn(s, num);
    pm = __fadd_rn(pm, m0);
  }
  s = __shfl_sync(0xffffffffu, warp_sum(s), 0);
  pm = __shfl_sync(0xffffffffu, warp_sum(pm), 0);
  const float den = fmaxf(s, 1e-30f);
  const bool act = active[t] != 0;
  for (int a = lane; a < A; a += 32) {
    const size_t i = base + a;
    const float m0 = mu_prev[i];
    const float m = act ? __fmul_rn(__fdiv_rn(mu_out[i], den), pm) : m0;
    mu_out[i] = m;
    delta_out[i] = __fmul_rn(c, __fsub_rn(m, m0));
  }
}

// ---------------------------------------------------------------------------
// The block loop
// ---------------------------------------------------------------------------

constexpr uint8_t kActive = 1;  // the token passes the λ_w word mask
constexpr uint8_t kSolo = 2;    // live, its word alone in the block

// The operands of one blocked sweep (see the file comment). The field names
// the fold phases of sweep_active.cuh read are ActiveLoop's.
struct BlockLoop {
  const int* word_ids;        // (D, L)
  const float* counts;        // (D, L)
  const uint8_t* flags;       // (D, L) kActive | kSolo
  const float* mu_in;         // (D, L, K)
  float* mu_out;              // (D, L, K), = mu_in on entry (the copy)
  float* abs_delta;           // (D, L, A) |Δ|
  int* token_topics;          // (D, L, A) the token's active topic ids
  float* theta;               // (D, K), updated in place
  float* phi;                 // (W, K), updated in place
  float* phi_k;               // (K,), updated in place
  double* phi_k64;            // null: fold_topic_at's float64 total is not kept
  const int* word_topics;     // (W, A)
  const int* row_order;       // (blocks, D·nb) sorted entries, -1 past
  const int* row_key;         // their words
  const int* run_pos;         // (blocks, D·nb) each word run's first and
  const int* run_end;         // one-past-last position, -1 past the last
  const int* pair_order;      // (blocks, D·nb·A) sorted pairs e·A + a
  const int* pair_key;        // their topics
  float* compact;             // (D, nb, A) the block's Δ
  float* parts;               // (D·nb·A) the topic runs' block parts
  unsigned int* barrier;      // one int, zeroed before the launch
  int D, L, K, A, nb, blocks;
  float alpha_m1, beta_m1, wb;
};

// The E-step of token `tok` (word w, count c, flags f) by one warp, on the
// pre-block θ̂_d (th) and the block's statistics; cp is its (A) row of the
// compact scratch. Lane j's first slot (a = j) keeps its topic, μ_prev,
// φ̂_w entry and numerator in registers; slots past the warp width stage
// the numerator in cp.
__device__ __forceinline__ void token_estep(const BlockLoop& p,
                                            const float* th, float* cp,
                                            size_t tok, int w, float c,
                                            int f, int lane) {
  const int A = p.A;
  const int* top = p.word_topics + (size_t)w * A;
  int* tt = p.token_topics + tok * A;
  float* ad = p.abs_delta + tok * A;
  if (!(f & kActive)) {  // uniform across the warp: μ stays, Δ = 0
    for (int a = lane; a < A; a += 32) {
      tt[a] = top[a];
      ad[a] = 0.f;
    }
    return;
  }
  const int K = p.K;
  const float* mo = p.mu_in + tok * K;
  float* row = p.phi + (size_t)w * K;
  int k1 = 0;
  float m1 = 0.f, ph1 = 0.f, num1 = 0.f;  // slot a = lane
  float ns = 0.f;  // Σ_A num
  float pm = 0.f;  // Σ_A μ_prev
  for (int a = lane; a < A; a += 32) {
    const int k = top[a];
    tt[a] = k;
    const float m0 = mo[k];
    const float t0 = th[k];
    const float ph = active::ld_l2(row + k);
    float num = active::numerator(c, m0, t0, ph, active::ld_l2(p.phi_k + k),
                                  p.alpha_m1, p.beta_m1, p.wb);
    if (m0 <= 0.f && t0 <= 0.f) num = 0.f;  // pad lane
    if (a == lane) {
      k1 = k;
      m1 = m0;
      ph1 = ph;
      num1 = num;
    } else {
      cp[a] = num;  // read back below by this same thread
    }
    ns = __fadd_rn(ns, num);
    pm = __fadd_rn(pm, m0);
  }
  const float z = fmaxf(active::warp_total(ns), 1e-30f);
  pm = active::warp_total(pm);
  // Δ of a zero-count token is exactly zero: it folds nowhere (its μ still
  // moves, as in the plain version)
  const bool live = c != 0.f;
  const bool solo = live && (f & kSolo);
  float* mn = p.mu_out + tok * K;
  for (int a = lane; a < A; a += 32) {
    const bool first = a == lane;
    const int k = first ? k1 : tt[a];
    const float m0 = first ? m1 : mo[k];
    const float num = first ? num1 : cp[a];
    const float mu = __fmul_rn(__fdiv_rn(num, z), pm);
    const float dl = __fmul_rn(c, __fsub_rn(mu, m0));
    mn[k] = mu;
    ad[a] = fabsf(dl);
    if (live) cp[a] = dl;
    if (solo)  // φ̂_w as read above: no other token of the block has w
      row[k] = __fadd_rn(first ? ph1 : active::ld_l2(row + k), dl);
  }
}

// The E-step phase of document d in the block of columns [c0, c0 + width),
// then θ̂_d's fold, column by column; one warp. Lane j loads token j of a
// run of 32 (word, count, flags), shuffled to the warp token by token.
__device__ __forceinline__ void block_estep(const BlockLoop& p, int d,
                                            int c0, int width, int lane) {
  const int A = p.A;
  float* th = p.theta + (size_t)d * p.K;
  float* cpd = p.compact + (size_t)d * p.nb * A;
  const size_t tok0 = (size_t)d * p.L + c0;
  for (int base = 0; base < width; base += 32) {
    const int n = min(32, width - base);
    int wj = 0, fj = 0;
    float cj = 0.f;
    if (lane < n) {
      wj = p.word_ids[tok0 + base + lane];
      cj = p.counts[tok0 + base + lane];
      fj = p.flags[tok0 + base + lane];
    }
    for (int j = 0; j < n; ++j) {
      const int w = __shfl_sync(0xffffffffu, wj, j);
      const float c = __shfl_sync(0xffffffffu, cj, j);
      const int f = __shfl_sync(0xffffffffu, fj, j);
      token_estep(p, th, cpd + (size_t)(base + j) * A, tok0 + base + j, w,
                  c, f, lane);
    }
  }
  __syncwarp();  // every token read the pre-block θ̂_d
  for (int base = 0; base < width; base += 32) {
    const int n = min(32, width - base);
    bool live = false;
    if (lane < n)
      live = (p.flags[tok0 + base + lane] & kActive) &&
             p.counts[tok0 + base + lane] != 0.f;
    unsigned int todo = __ballot_sync(0xffffffffu, live);
    while (todo) {  // the live tokens in column order
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int* tt = p.token_topics + (tok0 + base + j) * A;
      const float* cp = cpd + (size_t)(base + j) * A;
      for (int a = lane; a < A; a += 32) {
        const int k = tt[a];
        th[k] = __fadd_rn(th[k], cp[a]);
      }
      __syncwarp();  // a later column may add to the same θ̂_d(k)
    }
  }
}

// The rows' fold of one block (fold phase b): a warp a word run, the
// positions [q0, q1) of the row order; lane j adds slot j's Δ (j + 32, …
// past the warp width) into φ̂_w's entry one entry after the other in
// (d, c) order — fold_word_run's order, with a warp's coalesced loads: 32
// entry ids at a time, their 32 Δ loaded ahead of the adds.
__device__ __forceinline__ void fold_row_run(const BlockLoop& p,
                                             const int* order, int q0,
                                             int q1, int w, int lane) {
  const int A = p.A;
  for (int a0 = 0; a0 < A; a0 += 32) {
    const int a = a0 + lane;
    const bool on = a < A;
    float* dst = p.phi + (size_t)w * p.K +
                 (on ? p.word_topics[(size_t)w * A + a] : 0);
    float v = on ? active::ld_l2(dst) : 0.f;
    for (int r = q0; r < q1; r += 32) {
      const int n = min(32, q1 - r);  // uniform across the warp
      const int oj = lane < n ? order[r + lane] : 0;
      float y[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int e = __shfl_sync(0xffffffffu, oj, j);
        y[j] = on && j < n ? active::ld_l2(p.compact + (size_t)e * A + a)
                           : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < n) v = __fadd_rn(v, y[j]);
    }
    if (on) *dst = v;
  }
}

__global__ void __launch_bounds__(active::kThreads)
    topk_loop_kernel(const BlockLoop p) {
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int gwarp = gtid >> 5;
  const int nwarps = nthreads >> 5;
  const int nrows = p.D * p.nb;
  const int npairs = nrows * p.A;
  for (int b = 0; b < p.blocks; ++b) {
    const int c0 = b * p.nb;
    const int width = min(p.nb, p.L - c0);
    for (int d = gwarp; d < p.D; d += nwarps)
      block_estep(p, d, c0, width, lane);
    active::grid_barrier(p.barrier);
    const int* po = p.pair_order + (size_t)b * npairs;
    const int* pk = p.pair_key + (size_t)b * npairs;
    active::fold_blocks(p, po, pk, npairs, gwarp, nwarps, lane);
    active::grid_barrier(p.barrier);
    const size_t rb = (size_t)b * nrows;
    for (int r = gwarp; r < nrows; r += nwarps) {
      const int q0 = p.run_pos[rb + r];
      if (q0 < 0) break;  // the runs are compacted to the front
      fold_row_run(p, p.row_order + rb, q0, p.run_end[rb + r],
                   p.row_key[rb + q0], lane);
    }
    for (int q = gtid; q < npairs; q += nthreads)
      active::fold_topic_at(p, po, pk, npairs, q);
    if (b + 1 < p.blocks) active::grid_barrier(p.barrier);
  }
}

}  // namespace

extern "C" {

// One launch over T tokens on `stream` (not synchronised). theta_a, phi_a,
// ptot_a, mu_prev, mu_out and delta_out are (T, A) float32; counts (T)
// float32; active (T) bytes (0 = inactive). Returns cudaGetLastError()
// (0 = the launch was accepted).
int topk_estep_launch(const void* theta_a, const void* phi_a,
                      const void* ptot_a, const void* mu_prev,
                      const void* counts, const void* active, void* mu_out,
                      void* delta_out, long long T, int A, float alpha_m1,
                      float beta_m1, float wb, void* stream) {
  const unsigned grid = (unsigned)((T + kWarps - 1) / kWarps);
  launch_log::record("topk_estep_kernel", 0,
                     reinterpret_cast<const void*>(&topk_estep_kernel), grid,
                     kWarpThreads, 0);
  topk_estep_kernel<<<grid, kWarpThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta_a), static_cast<const float*>(phi_a),
      static_cast<const float*>(ptot_a), static_cast<const float*>(mu_prev),
      static_cast<const float*>(counts), static_cast<const uint8_t*>(active),
      static_cast<float*>(mu_out), static_cast<float*>(delta_out), T, A,
      alpha_m1, beta_m1, wb);
  return cudaGetLastError();
}

// The block loop's copy pass on `stream` (1 launch): mu_out = mu_in over n
// floats, enqueued before the wrapper builds the visiting orders. Returns
// the CUDA error.
int topk_loop_pass_launch(const void* mu_in, void* mu_out, size_t n,
                          void* stream) {
  return active::launch_copy(static_cast<const float*>(mu_in),
                             static_cast<float*>(mu_out), n,
                             static_cast<cudaStream_t>(stream));
}

// One blocked sweep on `stream`, after its copy pass: the barrier's zeroing
// and the persistent loop (*launches gets the 2 operations). theta, phi and
// phi_k are updated in place; mu_out is (D, L, K), abs_delta and
// token_topics (D, L, A); flags (D, L) bytes, kActive | kSolo. The orders
// are (blocks, D·nb) — the rows' order, keys, word runs' first and end
// positions — and (blocks, D·nb·A) int32 (see the file comment);
// compact and parts are (D·nb·A) scratches, barrier one int. Returns the
// first CUDA error (0 = every launch was accepted).
int topk_loop_launch(const void* word_ids, const void* counts,
                     const void* flags, const void* mu_in, void* mu_out,
                     void* abs_delta, void* token_topics, void* theta,
                     void* phi, void* phi_k, const void* word_topics,
                     const void* row_order, const void* row_key,
                     const void* run_pos, const void* run_end,
                     const void* pair_order, const void* pair_key,
                     void* compact, void* parts, void* barrier, int D, int L,
                     int K, int A, int nb, int blocks, float alpha_m1,
                     float beta_m1, float wb, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BlockLoop p;
  p.word_ids = static_cast<const int*>(word_ids);
  p.counts = static_cast<const float*>(counts);
  p.flags = static_cast<const uint8_t*>(flags);
  p.mu_in = static_cast<const float*>(mu_in);
  p.mu_out = static_cast<float*>(mu_out);
  p.abs_delta = static_cast<float*>(abs_delta);
  p.token_topics = static_cast<int*>(token_topics);
  p.theta = static_cast<float*>(theta);
  p.phi = static_cast<float*>(phi);
  p.phi_k = static_cast<float*>(phi_k);
  p.phi_k64 = nullptr;        // no checked blocked sweep reads a total
  p.word_topics = static_cast<const int*>(word_topics);
  p.row_order = static_cast<const int*>(row_order);
  p.row_key = static_cast<const int*>(row_key);
  p.run_pos = static_cast<const int*>(run_pos);
  p.run_end = static_cast<const int*>(run_end);
  p.pair_order = static_cast<const int*>(pair_order);
  p.pair_key = static_cast<const int*>(pair_key);
  p.compact = static_cast<float*>(compact);
  p.parts = static_cast<float*>(parts);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.D = D;
  p.L = L;
  p.K = K;
  p.A = A;
  p.nb = nb;
  p.blocks = blocks;
  p.alpha_m1 = alpha_m1;
  p.beta_m1 = beta_m1;
  p.wb = wb;
  *launches = 0;
  cudaError_t err = active::reset_barrier(p.barrier, st);
  if (err != cudaSuccess) return err;
  ++*launches;
  // a warp a document in the E-step, a block of 32 pair positions in fold
  // phase (a), a word run a warp and D·nb·A pair positions in phase (b)
  const long long work = (long long)D * nb * (A > 16 ? 2 * A : 32);
  const int want = (int)((work + active::kThreads - 1) / active::kThreads);
  err = active::launch_cooperative(topk_loop_kernel, p, want,
                                   active::kLoopCtasPerSm, active::kThreads,
                                   st, "topk_loop_kernel", 0);
  if (err != cudaSuccess) return err;
  ++*launches;
  return cudaSuccess;
}

const char* topk_estep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_QUERY(topk_estep_kernel)
LAUNCH_LOG_QUERY(topk_loop_kernel)
LAUNCH_LOG_LIBRARY(topk_estep)
