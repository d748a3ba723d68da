// Frozen-phi theta-only fixed point (paper §2.4) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/theta_sweep.py::theta_sweep_pallas of the
// JAX package. One launch runs `num_sweeps` Jacobi sweeps of
//
//     mu_{w,d}(k) ∝ thn_d(k) · phi_w(k),   thn_d = (theta_d + α−1) / (Σθ_d + K(α−1))
//     theta_d(k)  = Σ_w x^{80%}_{w,d} mu_{w,d}(k)
//
// over the L token columns of each document, then L evaluation columns that
// emit x·log Σ_k thn_d(k) phi_w(k) for both count splits against the final
// theta. phi (W_s, K) arrives normalised (eq. 10) and read-only as f32, bf16,
// or int8 with a per-row f32 scale; all arithmetic is f32. The wide path
// and the scheduled fit dequantise on read; the register paths take the
// stored values, since a row's scale cancels from μ, and apply it once per
// token to eq. 21's likelihood. The scheduled variant restricts each token's fit to its word's A
// active topics (word_topics, distinct ids per row); evaluation always uses
// the full support.
//
// Bound on this card. Each input read once is small (≈ 0.17 ms at the
// serving shape, set by the operations); by design a token's φ row is read
// once per sweep (the fixed point needs the whole row per token: z, then the
// fold), so the floor of this design is the row gather, (S·fit + eval)
// tokens × K × bytes(phi) over the memory rate (≈ 2.8 ms f32 at
// chip_smoke.py's serving batch, less where Zipf-hot rows hit the 50 MB L2).
// With one row in flight per document and a barrier pair per token, memory
// latency rather than bytes would set the time, so the design below keeps
// rows in flight and batches barriers. Measured (PERF.md §6, an H100
// 80GB HBM3 at 700 W), the f32 form runs at its row gather: the bytes,
// partly from L2. bf16 and int8 read half and a quarter of them; what ends
// their wave is the longest documents' per-token issue — their dot
// products, folds and one reduction a group — and int8's exact
// byte-to-float conversion (two operations a lane, in both passes) keeps
// it a few percent behind bf16. The scheduled form's fit is short; its
// eval phase reads full rows through the same ring.
//
// Design, register paths (K ≤ kRegThreads·4·kRegGroups = 10,240). One CTA
// of 512 threads per document, two CTAs an SM (≤ 64 registers a thread,
// ≤ 113 KB of shared memory each): 264 slots hold chip_smoke.py's 256
// documents in one wave. Documents run in the order `doc_order` gives,
// longest first by fit tokens (the wrapper computes it); a document stays
// in one CTA, so its bits do not depend on its batch-mates or on the order.
// A document's token columns (word ids, both count splits, the int8 row
// scales) are staged in shared memory first: no per-token read of either
// role below goes to device memory, only the rows themselves.
//   * Dense fit: thread i owns the 4-lane groups g = i, i + 512, … (five);
//     thn and the fold accumulator acc live in its registers. The φ rows of
//     the coming tokens stream into a ring of `slots` shared-memory slots
//     by 1-D TMA (cp.async.bulk on an mbarrier a slot): thread 0 issues a
//     row as soon as its slot frees, skipping zero-count tokens, across
//     sweep boundaries and into the eval phase. G staged tokens (1 f32,
//     2 bf16, 4 int8: rows of 40, 20, 10 KB at K = 10^4) share one block
//     reduction of their normalisers z = Σ thn·φ, then fold in token
//     order; the group's rows are waited for first, so its G dot products
//     and folds interleave lane by lane as independent chains (each
//     token's own sum keeps its lane order). thn is fixed for a Jacobi
//     sweep, so the fold factors it out:
//     acc(k) += φ(k)·(c/z), one fused multiply-add a lane and one division
//     a token, and acc(k) ← thn(k)·acc(k) once at the sweep's end. The
//     same θ̂ as the reference's Σ c·(thn·φ/z), rounded in other places
//     (inside chip_smoke.py's TOL). Registers hold thn and acc only; the
//     fold reads the row from its slot again.
//   * Scheduled fit: thn and acc (K floats each) stay in shared memory,
//     since a token reads its word's A topics at random lanes. Warps 1–15
//     take a token each (lanes over its A topics): z by a warp butterfly,
//     c·(v/z)… staged as (tokens, A) values and topic ids in one of two
//     shared buffers; warp 0 meanwhile folds the previous chunk in token
//     order. A row's topics are distinct, so a token's lanes never collide;
//     __syncwarp orders one token's adds before the next's.
//   * Eval phase (both fits): thn in registers, the same row ring, G
//     tokens a reduction; log and the two products by thread 0.
// Unaligned rows (K·bytes(phi) % 16 ≠ 0, e.g. K = 10,001): the TMA copies
// the 16-byte-aligned span that holds the row (it never leaves the row's
// first and last 16-byte granules, so never the allocation) and the lanes
// are read one by one from the row's offset in the slot: the same lanes,
// the same order, the same bits as the 16-byte reads.
//
// Wide path (K > 10,240, or A > 1,024): the previous kernel, a 1,024-thread
// CTA per document with thn, acc and the staged numerators (3·K floats) in
// dynamic shared memory, or — when they do not fit (bigmodel's K = 5·10^4)
// — in a global scratch of D·3·K floats the caller passes.
//
// Every reduction has a fixed order and no atomics are used, so results are
// bitwise repeatable. Fit columns with zero count add exactly zero and are
// skipped; evaluation columns are skipped only when both splits are zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWideThreads = 1024;  // wide path: threads a CTA
constexpr int kRegThreads = 512;    // register paths: threads a CTA
constexpr int kRegGroups = 5;       // 4-lane groups a thread: K <= 10,240
constexpr int kMaxSlots = 8;        // row-ring slots
constexpr int kStage = 1024;        // scheduled fit: staged (token, lane)s
                                    // per buffer

// ---------------------------------------------------------------------------
// φ reads
// ---------------------------------------------------------------------------

template <typename T>
struct PhiRead;

// get: the dequantised value (the wide path, the scheduled fit); raw and
// raw4 (one lane, or four from a 16-byte-aligned group): the stored value
// before the int8 row scale, which the register paths apply once per token
// where it does not cancel (eq. 21), never per lane.
template <>
struct PhiRead<float> {
  static __device__ __forceinline__ float get(const float* row, int k, float) {
    return row[k];
  }
  static __device__ __forceinline__ float raw(const float* row, int k) {
    return row[k];
  }
  static __device__ __forceinline__ float4 raw4(const float* row, int g) {
    return reinterpret_cast<const float4*>(row)[g];
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <>
struct PhiRead<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* row, int k,
                                              float) {
    return __bfloat162float(row[k]);
  }
  static __device__ __forceinline__ float raw(const __nv_bfloat16* row,
                                              int k) {
    return __bfloat162float(row[k]);
  }
  static __device__ __forceinline__ float4 raw4(const __nv_bfloat16* row,
                                                int g) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[g];
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  }
};

template <>
struct PhiRead<int8_t> {
  // dequantize on read: the same f32 product as dequantize_phi
  static __device__ __forceinline__ float get(const int8_t* row, int k,
                                              float scale) {
    return __fmul_rn(static_cast<float>(row[k]), scale);
  }
  // Byte i of u, biased to 0..255, becomes the low mantissa byte of
  // 2^23 (one byte_perm); subtracting 2^23 + 128 leaves the signed value
  // exactly, without the conversion unit's quarter-rate I2F.
  static __device__ __forceinline__ float byte(uint32_t biased, uint32_t i) {
    return __fsub_rn(
        __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + i)),
        8388736.f);
  }
  static __device__ __forceinline__ float raw(const int8_t* row, int k) {
    return static_cast<float>(row[k]);
  }
  static __device__ __forceinline__ float4 raw4(const int8_t* row, int g) {
    const uint32_t u =
        reinterpret_cast<const uint32_t*>(row)[g] ^ 0x80808080u;
    return make_float4(byte(u, 0), byte(u, 1), byte(u, 2), byte(u, 3));
  }
};

__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Lanes 4g..4g+3 of a row in shared memory, as stored (raw); lanes past K
// read as 0 (only the scalar form has any).
template <typename T, bool kVec>
__device__ __forceinline__ float4 read4(const T* row, int g, int K) {
  if constexpr (kVec) {
    return PhiRead<T>::raw4(row, g);
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = 4 * g + j < K ? PhiRead<T>::raw(row, 4 * g + j) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// Reductions
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Every lane receives the same bits: at each step a lane and its partner
// add the same two values (addition commutes).
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// G fixed-order block sums in one pair of barriers (`red`: (G + 1)·32
// floats, the same reuse argument as block_sum). Thread 0 runs `between`
// after the first barrier, when every thread has computed its partials.
template <int G, typename F>
__device__ __forceinline__ void block_sum_n(float (&v)[G], float* red,
                                            F between) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    v[q] = warp_sum(v[q]);
    if (lane == 0) red[q * 32 + warp] = v[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) between();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float x = lane < static_cast<int>(blockDim.x >> 5) ? red[q * 32 + lane]
                                                         : 0.f;
      x = warp_sum(x);
      if (lane == 0) red[G * 32 + q] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < G; ++q) v[q] = red[G * 32 + q];
}

// ---------------------------------------------------------------------------
// The φ-row ring: 1-D TMA copies into shared-memory slots on mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One row copy: expect its bytes on the slot's barrier, then start it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The rows a document's launch reads, in order: for each fit sweep s < S
// the tokens with est ≠ 0, then (s = S) the tokens with est ≠ 0 or ev ≠ 0.
// Load n goes to slot n % slots and completes phase n / slots of its
// barrier. Thread 0 produces; every thread consumes in the same order.
struct RowRing {
  unsigned char* base;
  uint64_t* bar;
  int* state;                  // producer: issued, sweep, token (shared)
  int slots;
  uint32_t stride;             // bytes a slot (16-byte multiple)
  const unsigned char* phi;    // (W_s, K) rows
  size_t row_bytes;
  const int* wid;
  const float* cnt;
  const float* ev;
  int L, sweeps;

  // Issue loads up to (not including) number `limit`; thread 0 only.
  __device__ void produce(int limit) {
    int issued = state[0], ps = state[1], pl = state[2];
    for (; issued < limit; ++issued) {
      while (ps <= sweeps) {   // the next row to read
        while (pl < L && !(cnt[pl] != 0.f || (ps == sweeps && ev[pl] != 0.f)))
          ++pl;
        if (pl < L) break;
        ++ps;
        pl = 0;
      }
      if (ps > sweeps) break;
      const uintptr_t src =
          reinterpret_cast<uintptr_t>(phi + (size_t)wid[pl] * row_bytes);
      const uintptr_t lo = src & ~static_cast<uintptr_t>(15);
      const uintptr_t hi = (src + row_bytes + 15) & ~static_cast<uintptr_t>(15);
      const int slot = issued % slots;
      bulk_load(base + (size_t)slot * stride,
                reinterpret_cast<const void*>(lo),
                static_cast<uint32_t>(hi - lo), &bar[slot]);
      ++pl;
    }
    state[0] = issued;
    state[1] = ps;
    state[2] = pl;
  }

  // Wait for load n (of word w); the byte offset of its row in the ring.
  __device__ uint32_t wait(int n, int w) const {
    const int slot = n % slots;
    mbar_wait(&bar[slot], static_cast<uint32_t>(n / slots) & 1u);
    const uintptr_t src =
        reinterpret_cast<uintptr_t>(phi + (size_t)w * row_bytes);
    return static_cast<uint32_t>(slot * stride + (src & 15));
  }
};

// Thread 0 sets the producer's state to the first row of sweep `first`.
__device__ __forceinline__ void ring_init(RowRing& rg, unsigned char* base,
                                          uint64_t* bar, int* state,
                                          int slots, uint32_t stride,
                                          const void* phi, size_t row_bytes,
                                          const int* wid, const float* cnt,
                                          const float* ev, int L, int sweeps,
                                          int first) {
  rg.base = base;
  rg.bar = bar;
  rg.state = state;
  rg.slots = slots;
  rg.stride = stride;
  rg.phi = static_cast<const unsigned char*>(phi);
  rg.row_bytes = row_bytes;
  rg.wid = wid;
  rg.cnt = cnt;
  rg.ev = ev;
  rg.L = L;
  rg.sweeps = sweeps;
  if (threadIdx.x == 0) {
    state[0] = 0;
    state[1] = first;
    state[2] = 0;
  }
}

// ---------------------------------------------------------------------------
// Register paths
// ---------------------------------------------------------------------------

// For each staged token q < nt: Σ over the thread's lanes of thn·φ_q
// (lane order, fused multiply-adds), φ_q as stored at byte off[q] of the
// ring. The G tokens' sums interleave lane by lane (independent chains).
template <typename T, int G, bool kVec>
__device__ __forceinline__ void dot_rows(float (&z)[G],
                                         const float (&thn)[4 * kRegGroups],
                                         const unsigned char* ring,
                                         const uint32_t (&off)[G], int nt,
                                         int K) {
  const int groups = (K + 3) >> 2;
#pragma unroll
  for (int q = 0; q < G; ++q) z[q] = 0.f;
#pragma unroll
  for (int i = 0; i < kRegGroups; ++i) {
    const int g = threadIdx.x + kRegThreads * i;
    if (g < groups) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (q < nt) {
          const float4 f =
              read4<T, kVec>(reinterpret_cast<const T*>(ring + off[q]), g, K);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kVec || 4 * g + j < K)
              z[q] = __fmaf_rn(thn[4 * i + j], get(f, j), z[q]);
        }
      }
    }
  }
}

// Scans for the next G tokens from position l on that pass `keep`; -1 past
// the last.
template <int G, typename F>
__device__ __forceinline__ int next_tokens(int (&lq)[G], int l, int L,
                                           F keep) {
#pragma unroll
  for (int q = 0; q < G; ++q) {
    while (l < L && !keep(l)) ++l;
    lq[q] = l < L ? l : -1;
    if (l < L) ++l;
  }
  return l;
}

// A document's token columns staged in shared memory at `meta` (16·L
// bytes): word ids, both count splits and, per column, its word's int8
// scale (1 otherwise). Every per-token read of the register paths — the
// producer's and the consumers' — is then a shared-memory read, never a
// dependent global load between a row's arrival and its use.
struct DocMeta {
  int* wid;
  float* cnt;
  float* ev;
  float* sc;
};

__device__ __forceinline__ DocMeta stage_doc(unsigned char* meta,
                                             const int* wid, const float* cnt,
                                             const float* ev,
                                             const float* phi_scale, int L) {
  DocMeta doc;
  doc.wid = reinterpret_cast<int*>(meta);
  doc.cnt = reinterpret_cast<float*>(doc.wid + L);
  doc.ev = doc.cnt + L;
  doc.sc = doc.ev + L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int w = wid[l];
    doc.wid[l] = w;
    doc.cnt[l] = cnt[l];
    doc.ev[l] = ev[l];
    doc.sc[l] = phi_scale != nullptr ? phi_scale[w] : 1.f;
  }
  return doc;
}

// The eq. 21 phase against thn (registers), rows from the ring from load
// number n on.
template <typename T, int G, bool kVec>
__device__ __forceinline__ void eval_phase(
    const float (&thn)[4 * kRegGroups], RowRing& rg, int n, float* red,
    const unsigned char* ring, const DocMeta& doc, float* est_ll,
    float* ev_ll,
    int L, int K) {
  const float* cnt = doc.cnt;
  const float* evc = doc.ev;
  for (int l = threadIdx.x; l < L; l += kRegThreads)
    if (cnt[l] == 0.f && evc[l] == 0.f) {
      est_ll[l] = 0.f;
      ev_ll[l] = 0.f;
    }
  auto keep = [&](int l) { return cnt[l] != 0.f || evc[l] != 0.f; };
  int l = 0;
  while (true) {
    int lq[G];
    l = next_tokens<G>(lq, l, L, keep);
    if (lq[0] < 0) break;
    float lik[G];
    uint32_t off[G];
    int nt = 0;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      off[q] = 0;
      if (lq[q] >= 0) off[q] = rg.wait(n + nt++, doc.wid[lq[q]]);
    }
    dot_rows<T, G, kVec>(lik, thn, ring, off, nt, K);
    // every thread has read this group's rows: their slots are free
    block_sum_n<G>(lik, red, [&] { rg.produce(n + nt + rg.slots); });
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (lq[q] >= 0) {
          const float ll =
              logf(fmaxf(__fmul_rn(lik[q], doc.sc[lq[q]]), 1e-30f));
          est_ll[lq[q]] = __fmul_rn(cnt[lq[q]], ll);
          ev_ll[lq[q]] = __fmul_rn(evc[lq[q]], ll);
        }
    }
    n += nt;
  }
}

template <typename T, int G, bool kVec>
__global__ void __launch_bounds__(kRegThreads, 2)
    theta_sweep_dense(const int* __restrict__ word_ids,
                      const float* __restrict__ est,
                      const float* __restrict__ ev,
                      const float* __restrict__ theta_in,
                      const T* __restrict__ phi,
                      const float* __restrict__ phi_scale,
                      const int* __restrict__ doc_order,
                      float* __restrict__ theta_out,
                      float* __restrict__ est_ll, float* __restrict__ ev_ll,
                      int slots, int stride, int meta_off, int L, int K,
                      int num_sweeps, float alpha_m1, float k_alpha) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float red[(G + 1) * 32];  // the groups' reductions
  __shared__ float red1[33];           // the normalisers'
  __shared__ uint64_t bar[kMaxSlots];
  __shared__ int state[3];
  const int d = doc_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int groups = (K + 3) >> 2;
  const DocMeta doc =
      stage_doc(ring + meta_off, word_ids + (size_t)d * L,
                est + (size_t)d * L, ev + (size_t)d * L, phi_scale, L);
  const float* cnt = doc.cnt;

  RowRing rg;
  ring_init(rg, ring, bar, state, slots, stride, phi, (size_t)K * sizeof(T),
            doc.wid, doc.cnt, doc.ev, L, num_sweeps, 0);
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  float acc[4 * kRegGroups], thn[4 * kRegGroups];
#pragma unroll
  for (int i = 0; i < kRegGroups; ++i) {
    const int g = tid + kRegThreads * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      acc[4 * i + j] =
          g < groups && k < K ? theta_in[(size_t)d * K + k] : 0.f;
    }
  }
  __syncthreads();  // the barriers are initialised, the columns staged
  if (tid == 0) rg.produce(slots);

  auto fit = [&](int l) { return cnt[l] != 0.f; };
  int n = 0;  // ring loads consumed
  for (int s = 0; s < num_sweeps; ++s) {
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < 4 * kRegGroups; ++m) part = __fadd_rn(part, acc[m]);
    const float den =
        fmaxf(__fadd_rn(block_sum(part, red1), k_alpha), 1e-30f);
#pragma unroll
    for (int m = 0; m < 4 * kRegGroups; ++m) {
      thn[m] = __fdiv_rn(__fadd_rn(acc[m], alpha_m1), den);
      acc[m] = 0.f;
    }
    int l = 0;
    while (true) {
      int lq[G];
      l = next_tokens<G>(lq, l, L, fit);
      if (lq[0] < 0) break;
      float z[G];
      uint32_t off[G];
      int nt = 0;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        off[q] = 0;
        if (lq[q] >= 0) off[q] = rg.wait(n + nt++, doc.wid[lq[q]]);
      }
      dot_rows<T, G, kVec>(z, thn, ring, off, nt, K);
      // the previous group's rows are folded: their slots are free
      block_sum_n<G>(z, red, [&] { rg.produce(n + rg.slots); });
      float cz[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        cz[q] = q < nt ? __fdiv_rn(cnt[lq[q]], fmaxf(z[q], 1e-30f)) : 0.f;
      // each lane adds the group's tokens in token order
#pragma unroll
      for (int i = 0; i < kRegGroups; ++i) {
        const int g = tid + kRegThreads * i;
        if (g < groups) {
#pragma unroll
          for (int q = 0; q < G; ++q) {
            if (q < nt) {
              const float4 f = read4<T, kVec>(
                  reinterpret_cast<const T*>(ring + off[q]), g, K);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (kVec || 4 * g + j < K)
                  acc[4 * i + j] = __fmaf_rn(get(f, j), cz[q],
                                             acc[4 * i + j]);
            }
          }
        }
      }
      n += nt;
    }
#pragma unroll
    for (int m = 0; m < 4 * kRegGroups; ++m)  // θ̂ = thn · Σ_t φ_t·c_t/z_t
      acc[m] = __fmul_rn(thn[m], acc[m]);
  }

  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kRegGroups; ++i) {
    const int g = tid + kRegThreads * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      if (g < groups && k < K) theta_out[(size_t)d * K + k] = acc[4 * i + j];
      part = __fadd_rn(part, acc[4 * i + j]);
    }
  }
  const float den = fmaxf(__fadd_rn(block_sum(part, red1), k_alpha), 1e-30f);
#pragma unroll
  for (int m = 0; m < 4 * kRegGroups; ++m)
    thn[m] = __fdiv_rn(__fadd_rn(acc[m], alpha_m1), den);
  eval_phase<T, G, kVec>(thn, rg, n, red, ring, doc, est_ll + (size_t)d * L,
                         ev_ll + (size_t)d * L, L, K);
}

template <typename T, int G, bool kVec>
__global__ void __launch_bounds__(kRegThreads, 2)
    theta_sweep_sched(const int* __restrict__ word_ids,
                      const float* __restrict__ est,
                      const float* __restrict__ ev,
                      const float* __restrict__ theta_in,
                      const T* __restrict__ phi,
                      const float* __restrict__ phi_scale,
                      const int* __restrict__ word_topics, int A,
                      const int* __restrict__ doc_order,
                      float* __restrict__ theta_out,
                      float* __restrict__ est_ll, float* __restrict__ ev_ll,
                      int slots, int stride, int meta_off, int L, int K,
                      int num_sweeps, float alpha_m1, float k_alpha) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float red[(G + 1) * 32];  // the eval groups' reductions
  __shared__ float red1[33];           // the normalisers'
  __shared__ uint64_t bar[kMaxSlots];
  __shared__ int state[3];
  const int d = doc_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = (K + 3) >> 2;
  const DocMeta doc =
      stage_doc(ring + meta_off, word_ids + (size_t)d * L,
                est + (size_t)d * L, ev + (size_t)d * L, phi_scale, L);
  const float* cnt = doc.cnt;
  float* thn_s = reinterpret_cast<float*>(ring);   // K
  float* acc_s = thn_s + K;                         // K
  float* stage_v = acc_s + K;                       // 2 × kStage
  int* stage_t = reinterpret_cast<int*>(stage_v + 2 * kStage);
  const int chunk = kStage / A;                     // tokens a buffer
  const int nchunks = (L + chunk - 1) / chunk;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = tid; k < K; k += kRegThreads)
    acc_s[k] = theta_in[(size_t)d * K + k];
  __syncthreads();

  for (int s = 0; s < num_sweeps; ++s) {
    float part = 0.f;
    for (int k = tid; k < K; k += kRegThreads)
      part = __fadd_rn(part, acc_s[k]);
    const float den =
        fmaxf(__fadd_rn(block_sum(part, red1), k_alpha), 1e-30f);
    for (int k = tid; k < K; k += kRegThreads) {
      thn_s[k] = __fdiv_rn(__fadd_rn(acc_s[k], alpha_m1), den);
      acc_s[k] = 0.f;
    }
    __syncthreads();  // thn complete before any token reads it
    // warps 1..15 stage chunk c while warp 0 folds chunk c − 1
    for (int c = 0; c <= nchunks; ++c) {
      if (warp == 0) {
        if (c > 0) {
          const float* sv = stage_v + ((c - 1) & 1) * kStage;
          const int* st = stage_t + ((c - 1) & 1) * kStage;
          for (int i = 0; i < chunk; ++i) {
            const int l = (c - 1) * chunk + i;
            if (l >= L) break;
            if (cnt[l] == 0.f) continue;
            for (int a = lane; a < A; a += 32) {
              const int t = st[i * A + a];
              acc_s[t] = __fadd_rn(acc_s[t], sv[i * A + a]);
            }
            __syncwarp();
          }
        }
      } else if (c < nchunks) {
        float* sv = stage_v + (c & 1) * kStage;
        int* st = stage_t + (c & 1) * kStage;
        for (int i = warp - 1; i < chunk; i += kRegThreads / 32 - 1) {
          const int l = c * chunk + i;
          if (l >= L) break;
          const float cn = cnt[l];
          if (cn == 0.f) continue;  // uniform across the warp
          const int w = doc.wid[l];
          const int* top = word_topics + (size_t)w * A;
          const T* row = phi + (size_t)w * K;
          const float sc = doc.sc[l];
          float z = 0.f;
          for (int a = lane; a < A; a += 32) {
            const int t = top[a];
            const float v = __fmul_rn(thn_s[t], PhiRead<T>::get(row, t, sc));
            sv[i * A + a] = v;
            st[i * A + a] = t;
            z = __fadd_rn(z, v);
          }
          z = fmaxf(warp_allsum(z), 1e-30f);
          const float cz = __fdiv_rn(cn, z);
          for (int a = lane; a < A; a += 32)
            sv[i * A + a] = __fmul_rn(sv[i * A + a], cz);
        }
      }
      __syncthreads();
    }
  }

  // final theta, then the eval phase with thn in registers and the whole
  // dynamic region as the row ring
  float part = 0.f;
  for (int k = tid; k < K; k += kRegThreads) {
    theta_out[(size_t)d * K + k] = acc_s[k];
    part = __fadd_rn(part, acc_s[k]);
  }
  const float den = fmaxf(__fadd_rn(block_sum(part, red1), k_alpha), 1e-30f);
  float thn[4 * kRegGroups];
#pragma unroll
  for (int i = 0; i < kRegGroups; ++i) {
    const int g = tid + kRegThreads * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      thn[4 * i + j] = g < groups && k < K
                           ? __fdiv_rn(__fadd_rn(acc_s[k], alpha_m1), den)
                           : 0.f;
    }
  }
  // the generic-proxy writes above precede the ring's TMA writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  RowRing rg;
  ring_init(rg, ring, bar, state, slots, stride, phi, (size_t)K * sizeof(T),
            doc.wid, doc.cnt, doc.ev, L, num_sweeps, num_sweeps);
  if (tid == 0) rg.produce(slots);
  eval_phase<T, G, kVec>(thn, rg, 0, red, ring, doc, est_ll + (size_t)d * L,
                         ev_ll + (size_t)d * L, L, K);
}

// ---------------------------------------------------------------------------
// Wide path: the state in dynamic shared memory or a global scratch
// ---------------------------------------------------------------------------

template <typename T, bool kScheduled>
__global__ void __launch_bounds__(kWideThreads)
    theta_sweep_wide(const int* __restrict__ word_ids,
                     const float* __restrict__ est,
                     const float* __restrict__ ev,
                     const float* __restrict__ theta_in,
                     const T* __restrict__ phi,
                     const float* __restrict__ phi_scale,
                     const int* __restrict__ word_topics, int A,
                     const int* __restrict__ doc_order,
                     float* __restrict__ theta_out,
                     float* __restrict__ est_ll, float* __restrict__ ev_ll,
                     float* __restrict__ scratch, int L, int K,
                     int num_sweeps, float alpha_m1, float k_alpha) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int d = doc_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* base = scratch != nullptr ? scratch + (size_t)d * 3 * K : smem;
  float* thn = base;          // normalised theta of the sweep (Jacobi)
  float* acc = base + K;      // carried theta / next sweep's fold
  float* num = base + 2 * K;  // staged per-token numerators
  const int* wid = word_ids + (size_t)d * L;
  const float* cnt = est + (size_t)d * L;
  const float* evc = ev + (size_t)d * L;

  for (int k = tid; k < K; k += nt) acc[k] = theta_in[(size_t)d * K + k];

  for (int s = 0; s < num_sweeps; ++s) {
    float part = 0.f;
    for (int k = tid; k < K; k += nt) part = __fadd_rn(part, acc[k]);
    const float den = fmaxf(__fadd_rn(block_sum(part, red), k_alpha), 1e-30f);
    for (int k = tid; k < K; k += nt) {
      thn[k] = __fdiv_rn(__fadd_rn(acc[k], alpha_m1), den);
      acc[k] = 0.f;
    }
    __syncthreads();  // scheduled lanes read thn/acc across threads
    for (int l = 0; l < L; ++l) {
      const float c = cnt[l];
      if (c == 0.f) continue;  // adds exactly zero; uniform across the CTA
      const int w = wid[l];
      const T* row = phi + (size_t)w * K;
      const float sc = phi_scale != nullptr ? phi_scale[w] : 1.f;
      if (!kScheduled) {
        float z = 0.f;
        for (int k = tid; k < K; k += nt) {
          const float v = __fmul_rn(thn[k], PhiRead<T>::get(row, k, sc));
          num[k] = v;
          z = __fadd_rn(z, v);
        }
        z = fmaxf(block_sum(z, red), 1e-30f);
        for (int k = tid; k < K; k += nt)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(c, __fdiv_rn(num[k], z)));
      } else {
        const int* top = word_topics + (size_t)w * A;
        float z = 0.f;
        for (int a = tid; a < A; a += nt) {
          const int t = top[a];
          const float v = __fmul_rn(thn[t], PhiRead<T>::get(row, t, sc));
          num[a] = v;
          z = __fadd_rn(z, v);
        }
        z = fmaxf(block_sum(z, red), 1e-30f);
        for (int a = tid; a < A; a += nt) {
          const int t = top[a];
          acc[t] = __fadd_rn(acc[t], __fmul_rn(c, __fdiv_rn(num[a], z)));
        }
      }
    }
    __syncthreads();  // the fold is complete before the next normaliser
  }

  float part = 0.f;
  for (int k = tid; k < K; k += nt) {
    theta_out[(size_t)d * K + k] = acc[k];
    part = __fadd_rn(part, acc[k]);
  }
  const float den = fmaxf(__fadd_rn(block_sum(part, red), k_alpha), 1e-30f);
  for (int k = tid; k < K; k += nt)
    thn[k] = __fdiv_rn(__fadd_rn(acc[k], alpha_m1), den);

  // eq. 21 phase: full topic support against the final theta
  for (int l = 0; l < L; ++l) {
    const float e = cnt[l];
    const float v = evc[l];
    const size_t o = (size_t)d * L + l;
    if (e == 0.f && v == 0.f) {
      if (tid == 0) {
        est_ll[o] = 0.f;
        ev_ll[o] = 0.f;
      }
      continue;
    }
    const int w = wid[l];
    const T* row = phi + (size_t)w * K;
    const float sc = phi_scale != nullptr ? phi_scale[w] : 1.f;
    float lik = 0.f;
    for (int k = tid; k < K; k += nt)
      lik = __fadd_rn(lik, __fmul_rn(thn[k], PhiRead<T>::get(row, k, sc)));
    const float ll = logf(fmaxf(block_sum(lik, red), 1e-30f));
    if (tid == 0) {
      est_ll[o] = __fmul_rn(e, ll);
      ev_ll[o] = __fmul_rn(v, ll);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Launch {
  const void *word_ids, *est, *ev, *theta_in, *phi, *phi_scale, *word_topics;
  int A;
  const void* doc_order;
  void *theta_out, *est_ll, *ev_ll, *scratch;
  int path, slots, stride, meta_off, smem, D, L, K, num_sweeps;
  float alpha_m1, k_alpha;
};

template <typename K_>
cudaError_t set_smem(K_ kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, bool kVec>
cudaError_t launch_regs(const Launch& a, cudaStream_t st) {
  // rows staged a reduction: one 40 KB f32 row, two bf16, four int8
  constexpr int G = sizeof(T) == 4 ? 1 : sizeof(T) == 2 ? 2 : 4;
  if (a.slots < 2 * G || a.slots > kMaxSlots) return cudaErrorInvalidValue;
  if (a.word_topics == nullptr) {
    auto kernel = theta_sweep_dense<T, G, kVec>;
    cudaError_t err = set_smem(kernel, a.smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.D, kRegThreads, a.smem, st>>>(
        static_cast<const int*>(a.word_ids), static_cast<const float*>(a.est),
        static_cast<const float*>(a.ev),
        static_cast<const float*>(a.theta_in),
        static_cast<const T*>(a.phi), static_cast<const float*>(a.phi_scale),
        static_cast<const int*>(a.doc_order),
        static_cast<float*>(a.theta_out), static_cast<float*>(a.est_ll),
        static_cast<float*>(a.ev_ll), a.slots, a.stride, a.meta_off, a.L,
        a.K, a.num_sweeps, a.alpha_m1, a.k_alpha);
  } else {
    if (a.A > kStage) return cudaErrorInvalidValue;
    auto kernel = theta_sweep_sched<T, G, kVec>;
    cudaError_t err = set_smem(kernel, a.smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.D, kRegThreads, a.smem, st>>>(
        static_cast<const int*>(a.word_ids), static_cast<const float*>(a.est),
        static_cast<const float*>(a.ev),
        static_cast<const float*>(a.theta_in),
        static_cast<const T*>(a.phi), static_cast<const float*>(a.phi_scale),
        static_cast<const int*>(a.word_topics), a.A,
        static_cast<const int*>(a.doc_order),
        static_cast<float*>(a.theta_out), static_cast<float*>(a.est_ll),
        static_cast<float*>(a.ev_ll), a.slots, a.stride, a.meta_off, a.L,
        a.K, a.num_sweeps, a.alpha_m1, a.k_alpha);
  }
  return cudaGetLastError();
}

template <typename T, bool kScheduled>
cudaError_t launch_wide(const Launch& a, cudaStream_t st) {
  auto kernel = theta_sweep_wide<T, kScheduled>;
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.D, kWideThreads, a.smem, st>>>(
      static_cast<const int*>(a.word_ids), static_cast<const float*>(a.est),
      static_cast<const float*>(a.ev), static_cast<const float*>(a.theta_in),
      static_cast<const T*>(a.phi), static_cast<const float*>(a.phi_scale),
      static_cast<const int*>(a.word_topics), a.A,
      static_cast<const int*>(a.doc_order), static_cast<float*>(a.theta_out),
      static_cast<float*>(a.est_ll), static_cast<float*>(a.ev_ll),
      static_cast<float*>(a.scratch), a.L, a.K, a.num_sweeps, a.alpha_m1,
      a.k_alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Launch& a, cudaStream_t st) {
  switch (a.path) {
    case 0:
      return launch_regs<T, true>(a, st);
    case 1:
      return launch_regs<T, false>(a, st);
    case 2:
    case 3:
      return a.word_topics != nullptr ? launch_wide<T, true>(a, st)
                                      : launch_wide<T, false>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch one chunk on `stream`: D CTAs, CTA b on document doc_order[b].
// phi_dtype: 0 = f32, 1 = bf16, 2 = int8 (phi_scale required).
// word_topics == NULL selects the dense fit. path: 0 = registers with
// 16-byte row reads (K·bytes(phi) % 16 == 0, phi 16-byte aligned), 1 =
// registers with lane-by-lane row reads, both K <= 10,240, with `slots`
// ring slots of `stride` bytes and `smem` bytes of dynamic shared memory
// (scheduled: also 8·K + 16·1,024 bytes of state, A <= 1,024), the
// document's staged columns (16·L bytes) at byte `meta_off`; 2 = wide,
// the state (3·K floats = `smem` bytes) in shared memory; 3 = wide, the
// state in `scratch` (D·3·K floats of device memory). Returns
// cudaGetLastError() after the launch (0 = launched).
int theta_sweep_launch(const void* word_ids, const void* est, const void* ev,
                       const void* theta_in, const void* phi, int phi_dtype,
                       const void* phi_scale, const void* word_topics, int A,
                       void* theta_out, void* est_ll, void* ev_ll,
                       void* scratch, const void* doc_order, int path,
                       int slots, int stride, int meta_off, int smem, int D,
                       int L, int K, int num_sweeps, float alpha_m1,
                       float k_alpha, void* stream) {
  const Launch a{word_ids, est,       ev,        theta_in, phi,
                 phi_scale, word_topics, A,      doc_order, theta_out,
                 est_ll,   ev_ll,     scratch,   path,     slots,
                 stride,   meta_off,  smem,      D,        L,
                 K,        num_sweeps, alpha_m1, k_alpha};
  if ((path == 3) != (scratch != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phi_dtype) {
    case 0:
      return dispatch<float>(a, s);
    case 1:
      return dispatch<__nv_bfloat16>(a, s);
    case 2:
      return dispatch<int8_t>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* theta_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
