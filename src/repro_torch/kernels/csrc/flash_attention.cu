// Blockwise online-softmax grouped-query attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention of the
// JAX package (its pallas_call, _flash_kernel). For query head h and query
// row i, over the keys of KV head h / G (G = BH / BHkv query heads a KV head):
//
//   s_j = scale · q_i · k_j                                  (float32)
//   keep j iff  j < Sk,  (causal) j <= i + q_offset,
//               (window > 0) j > i + q_offset − window
//   o_i = Σ_j softmax(s)_j v_j
//
// computed as the TPU kernel does: masked scores are NEG_INF = −1e30; the
// running max m, denominator l and accumulator acc are float32; each key
// tile's p = exp(s − m_new) enters l unrounded and p·v rounded to v's
// type; o = acc / max(l, 1e-30) rounded to q's type, so a row whose keys are
// all masked gives 0, not NaN. The ragged key edge is masked here, with no
// padding copies. When the caller asks (training), each row's log-sum-exp
// m + log(max(l, 1e-30)) goes to a float32 (BH, Sq) output that the
// backward kernels (csrc/flash_attention_bwd.cu) read; serving passes none.
//
// Layout: q, o (BH, Sq, d); k, v (BHkv, Sk, d); all contiguous, one type
// (float32 or bfloat16), 1 <= d <= 128.
//
// Bound on this card. Prefill is bounded by operations: a causal granite-8b
// layer (B = 8, 32 heads, S = 2,048, d = 128) is 2.7e11 flops over 0.2 GB of
// q, k, v and o, which the bf16 tensor cores do in 0.28 ms at their peak.
// Decode (Sq = 1 against a 2,048–4,096-deep cache) is bounded by bytes:
// every visible key and value is read once, ≈ 4 operations a byte.
//
// Rules both paths keep.
// * A CTA takes one KV head and a tile of rows of the (i, g) pairs of its G
//   query heads, row r = i·G + g. The G heads that share a KV head share
//   its K/V tiles, which are read once per tile of rows and not G times.
// * A loop over key tiles (BK = 64 keys in float32, 128 in bf16) takes the
//   place of the TPU's sequential KV grid axis. Only tiles inside the rows'
//   causal / window band are visited, from the band's first BK-aligned
//   tile: a tile that the mask hides entirely from a row leaves its m, l
//   and acc unchanged, so the skip is exact and a row's bits do not depend
//   on the other rows of its CTA (the TPU code visits every tile). Decode
//   reads the keys up to cache_pos, not the whole cache.
// * Row maxima and sums are butterflies and trees in a fixed order: every
//   lane gets the same bits and two launches give the same bits. No
//   atomics.
// * The heaviest row tiles (the causal band's end) are launched first.
//
// float32 (CUDA cores). K and V tiles are staged in shared memory (K with an
// XOR swizzle of its 16-byte chunks, so a warp's float4 reads of 32 keys are
// conflict-free); Q stays staged for the CTA's life; 256 threads, BQ = 64
// rows (16 for a decode step, Sq·G <= 16). Each warp owns BQ/8 rows; a lane
// owns keys lane and lane + 32 of a tile and output columns 4·lane.. (at
// d = 128); p goes through a warp-private shared row. Rows of 16-byte
// multiples are staged with 16-byte loads, each thread's issued before any
// is used. Scores and p·v are fmaf chains: the tensor cores' TF32 would
// round the inputs to 10 bits.
//
// bfloat16 (tensor cores: wgmma, TMA, warp specialisation; the building
// blocks are csrc/hopper_mma.cuh, shared with the backward).
// * Threads: NWG consumer warpgroups of 64 rows each, then a producer
//   warpgroup whose first warp fills the K/V ring. Prefill (Sq·G > 16)
//   takes NWG = 2 (128 rows; setmaxnreg moves the producer's registers to
//   the consumers: 24 against 240 a thread); a decode step's G rows are
//   padded into one 64-row tile (NWG = 1: decode is bound by bytes, and the
//   padding rows cost no bytes). Both forms run the same per-row
//   arithmetic (the same instructions, tile shape, BK and order of key
//   tiles), so a row's bits do not depend on Sq: a decode row equals the
//   same row of a prefill call.
// * Shared tiles are bf16 in the 128-byte-swizzled layout that TMA writes
//   and wgmma reads: blocks of 64 columns (128 bytes a row; d <= 64 pads to
//   one block, d <= 128 to two), chunk c of row r at c ^ (r mod 8). Columns
//   past d and key rows past Sk are zeros, which is exact (d = 120, 17). A
//   ring of three stages of 128 keys (64 KB of K and V at d = 128) and Q:
//   225 KB for prefill, 209 KB for decode, one CTA an SM.
// * The producer: when k and v have 16-byte-aligned bases and rows (d a
//   multiple of 8), one lane issues TMA loads of each 128-key × 64-column
//   block (3-D maps over (d, Sk, BHkv), whose out-of-bounds fill supplies
//   the zeros) against a full barrier that counts the bytes; otherwise the
//   warp's 32 lanes load elements into the same swizzled layout. Consumers
//   free a stage through its empty barrier. The consumers load Q once
//   (cp.async when aligned; rows r = i·G + g are not one TMA box).
// * Consumers: S = Q·Kᵀ by wgmma m64n128k16 from shared memory (both
//   K-major) into float32 registers; scale, mask (only on tiles that some
//   row of the warp does not wholly see) and the online softmax on the
//   accumulator fragment (a row lives in a quad of lanes: a tree over the
//   thread's 32 columns, then two shuffles), p = 2^(s·log2 e − m·log2 e)
//   by ex2.approx; P to bf16 in registers is the A operand of wgmma
//   m64n{64,128}k16 against V (MN-major B) accumulating into acc, which is
//   rescaled only when a row's max moved (a factor 1 is exact). Software
//   pipeline: tile t + 1's scores are issued with tile t's p·v, and t + 1's
//   softmax runs while p·v is on the tensor cores. The epilogue divides
//   and stores bf16.
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_mma.cuh"
#include "launch_log.cuh"

namespace {

constexpr int kThreads = 256;         // float32 path
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;               // keys a tile, float32 path
constexpr int kBKT = 128;             // keys a tile, bf16 path
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// p rounded to v's type, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

// float offset of K element (row, col) in its swizzled tile of DP columns
template <int DP>
__device__ __forceinline__ int kswz(int row, int col) {
  return row * DP + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

template <int BQ, int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * DP + 2 * kBK * DP + BQ * kBK);
}

// Four floats at columns 4·chunk..4·chunk+3 of row r of a staged tile.
template <int DP, bool SWZ>
__device__ __forceinline__ void put4(float* tile, int r, int chunk,
                                     float4 x) {
  const int c = SWZ ? chunk ^ (r & 7) : chunk;
  *reinterpret_cast<float4*>(tile + r * DP + (c << 2)) = x;
}

// 16 bytes of T as floats, into columns 16/sizeof(T)·cc.. of row r.
template <int DP, bool SWZ>
__device__ __forceinline__ void put16(float* tile, int r, int cc,
                                      uint4 raw, const float*) {
  put4<DP, SWZ>(tile, r, cc, make_float4(__uint_as_float(raw.x),
                                         __uint_as_float(raw.y),
                                         __uint_as_float(raw.z),
                                         __uint_as_float(raw.w)));
}

// Stage rows [0, n) × columns [0, d) of one or two (n, d) blocks into shared
// tiles of DP float columns; row r of block b starts at src[b] + row_off(r).
// SWZ: block 0 (K) is stored swizzled (kswz), the others plainly.
// VEC: 16-byte loads (d·sizeof(T) a multiple of 16, 16-byte aligned bases),
// all of a thread's loads of a round issued before any is used. Columns
// past d and rows past n are left as they are (zeros).
template <typename T, int DP, bool VEC, bool SWZ, int NB, typename RowOff>
__device__ __forceinline__ void stage(float* const (&dst)[NB],
                                      const T* const (&src)[NB], int n,
                                      int d, RowOff row_off) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);          // elements a 16-byte load
    constexpr int U = 2;                          // rounds in flight
    const int cpr = d / EPC;
    const int total = n * cpr;
    for (int base = tid; base < total; base += U * kThreads) {
      uint4 raw[U][NB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ci = base + u * kThreads;
        if (ci < total) {
          const size_t off = row_off(ci / cpr) + (size_t)(ci % cpr) * EPC;
#pragma unroll
          for (int b = 0; b < NB; ++b)
            raw[u][b] = __ldg(reinterpret_cast<const uint4*>(src[b] + off));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ci = base + u * kThreads;
        if (ci < total) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (SWZ && b == 0)
              put16<DP, true>(dst[b], ci / cpr, ci % cpr, raw[u][b], src[b]);
            else
              put16<DP, false>(dst[b], ci / cpr, ci % cpr, raw[u][b], src[b]);
        }
      }
    }
  } else {
    for (int idx = tid; idx < n * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      if (c >= d) continue;
      const size_t off = row_off(r) + c;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int at = SWZ && b == 0 ? kswz<DP>(r, c) : r * DP + c;
        dst[b][at] = to_float(src[b][off]);
      }
    }
  }
}

template <typename T, int BQ, int DP, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int group, int sq,
                           int sk, int d, int causal, int window,
                           int q_offset, float scale, int ntiles) {
  constexpr int RQ = BQ / kWarps;     // rows a warp
  constexpr int CD = DP / 32;         // output columns a lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][DP]
  float* Ks = Qs + BQ * DP;                      // [BK][DP], swizzled
  float* Vs = Ks + kBK * DP;                     // [BK][DP]
  float* Ps = Vs + kBK * DP;                     // [BQ][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x / ntiles;
  const int tile = ntiles - 1 - (int)(blockIdx.x % ntiles);
  const int r0 = tile * BQ;           // sq·group < 2^31 (the launcher checks)
  const int nrows = min(BQ, sq * group - r0);
  const T* kh = k + (size_t)hk * sk * d;
  const T* vh = v + (size_t)hk * sk * d;

  // zeros in every column past d and row past the ragged edges
  for (int idx = tid; idx < (BQ + 2 * kBK) * DP / 4; idx += kThreads)
    smem4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  {
    float* const dq[1] = {Qs};
    const T* const sq1[1] = {q};
    stage<T, DP, VEC, false, 1>(dq, sq1, nrows, d, [&](int r) {
      const int i = (r0 + r) / group, g = (r0 + r) % group;
      return (((size_t)hk * group + g) * sq + i) * d;
    });
  }

  // the band of keys some row of this tile sees
  const int i_lo = r0 / group;
  const int i_hi = (r0 + nrows - 1) / group;
  long long k_begin = 0, k_end = sk;
  if (causal) k_end = min(k_end, (long long)i_hi + q_offset + 1);
  if (window > 0)
    k_begin = max(k_begin, (long long)i_lo + q_offset - window + 1);

  const int row0 = warp * RQ;         // this warp's first row
  const bool live = row0 < nrows;     // warp-uniform
  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int j = 0; j < RQ; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[j][c] = 0.f;
  }

  for (long long kb = k_begin < k_end ? (k_begin / kBK) * kBK : k_end;
       kb < k_end; kb += kBK) {
    __syncthreads();                  // the last tile's readers are done
    const int nk = (int)min((long long)kBK, (long long)sk - kb);
    if (nk < kBK) {                   // the ragged last tile: zero its tail
      for (int idx = nk * DP + tid; idx < kBK * DP; idx += kThreads) {
        const int r = idx / DP, c = idx % DP;
        Ks[kswz<DP>(r, c)] = 0.f;
        Vs[idx] = 0.f;
      }
    }
    {
      float* const dkv[2] = {Ks, Vs};
      const T* const skv[2] = {kh, vh};
      stage<T, DP, VEC, true, 2>(dkv, skv, nk, d,
                                 [&](int r) { return (size_t)(kb + r) * d; });
    }
    __syncthreads();
    if (!live) continue;

    // scores for keys lane and lane + 32 of the tile
    float s[RQ][2];
#pragma unroll
    for (int j = 0; j < RQ; ++j) s[j][0] = s[j][1] = 0.f;
    const int c0 = lane, c1 = lane + 32;
#pragma unroll 4
    for (int ch = 0; ch < DP / 4; ++ch) {
      const float4 k0 = *reinterpret_cast<const float4*>(
          Ks + c0 * DP + ((ch ^ (c0 & 7)) << 2));
      const float4 k1 = *reinterpret_cast<const float4*>(
          Ks + c1 * DP + ((ch ^ (c1 & 7)) << 2));
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (row0 + j) * DP + 4 * ch);
        s[j][0] = fmaf(qv.x, k0.x, s[j][0]);
        s[j][0] = fmaf(qv.y, k0.y, s[j][0]);
        s[j][0] = fmaf(qv.z, k0.z, s[j][0]);
        s[j][0] = fmaf(qv.w, k0.w, s[j][0]);
        s[j][1] = fmaf(qv.x, k1.x, s[j][1]);
        s[j][1] = fmaf(qv.y, k1.y, s[j][1]);
        s[j][1] = fmaf(qv.z, k1.z, s[j][1]);
        s[j][1] = fmaf(qv.w, k1.w, s[j][1]);
      }
    }

    // online softmax, one row at a time: p to this warp's rows of Ps, the
    // row's accumulators rescaled by alpha = exp(m_old − m_new)
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      const bool valid = row0 + j < nrows;
      const long long qpos = (r0 + row0 + j) / group + (long long)q_offset;
      bool keep[2];
      float mc = kNegInf;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const long long kpos = kb + lane + 32 * t;
        keep[t] = valid && kpos < sk && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[j][t] = keep[t] ? __fmul_rn(s[j][t], scale) : kNegInf;
        mc = fmaxf(mc, s[j][t]);
      }
      const float m_new = fmaxf(m[j], warp_max(mc));
      const float alpha = expf(m[j] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = keep[t] ? expf(s[j][t] - m_new) : 0.f;
        ps = __fadd_rn(ps, p);
        Ps[(row0 + j) * kBK + lane + 32 * t] = round_as(p, v);
      }
      l[j] = __fadd_rn(__fmul_rn(alpha, l[j]), warp_sum(ps));
      m[j] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[j][c] = __fmul_rn(acc[j][c], alpha);
    }
    __syncwarp();

    // acc += p · v over the tile's keys
#pragma unroll 2
    for (int ch = 0; ch < kBK / 4; ++ch) {
      float vv[4][CD];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = Vs + (4 * ch + t) * DP + CD * lane;
        if constexpr (CD == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr);
          vv[t][0] = x.x; vv[t][1] = x.y; vv[t][2] = x.z; vv[t][3] = x.w;
        } else {
#pragma unroll
          for (int c = 0; c < CD; ++c) vv[t][c] = vr[c];
        }
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (row0 + j) * kBK + 4 * ch);
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          acc[j][c] = fmaf(pv.x, vv[0][c], acc[j][c]);
          acc[j][c] = fmaf(pv.y, vv[1][c], acc[j][c]);
          acc[j][c] = fmaf(pv.z, vv[2][c], acc[j][c]);
          acc[j][c] = fmaf(pv.w, vv[3][c], acc[j][c]);
        }
      }
    }
    __syncwarp();                     // Ps rows are rewritten next tile
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < RQ; ++j) {
    if (row0 + j >= nrows) continue;
    const int i = (r0 + row0 + j) / group, g = (r0 + row0 + j) % group;
    T* orow = o + (((size_t)hk * group + g) * sq + i) * d;
    const float den = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = CD * lane + c;
      if (col < d) store(orow + col, __fdiv_rn(acc[j][c], den));
    }
    // the row's log-sum-exp for the backward kernel (m and l are the
    // warp's: every lane holds them)
    if (lse != nullptr && lane == 0)
      lse[((size_t)hk * group + g) * sq + i] = __fadd_rn(m[j], logf(den));
  }
}

template <typename T, int BQ, int DP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bhkv, int group, int sq, int sk, int d,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, BQ, DP, VEC>;
  constexpr size_t smem = smem_bytes<BQ, DP>();
  // the attributes are per function and device, set at its first launch
  // there (not again: a launch may be captured into a CUDA graph)
  cudaError_t err = launch_log::optin_smem(
      reinterpret_cast<const void*>(kernel), (long long)smem,
      /*max_shared=*/true);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)sq * group;
  const int ntiles = (int)((rows + BQ - 1) / BQ);
  const long long grid = (long long)bhkv * ntiles;
  if (rows > 0x7fffffffLL - BQ || grid > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  // variant: BQ·10,000 + DP·10 + VEC
  launch_log::record("flash_attention_kernel", BQ * 10000 + DP * 10 + VEC,
                     reinterpret_cast<const void*>(kernel), grid, kThreads,
                     smem);
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, group, sq, sk, d,
      causal, window, q_offset, scale, ntiles);
  return cudaGetLastError();
}

template <typename T, int BQ, int DP>
cudaError_t launch_vec(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bhkv, int group, int sq, int sk,
                       int d, int causal, int window, int q_offset,
                       float scale, cudaStream_t st) {
  // 16-byte loads when every row is a whole number of aligned 16 bytes
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if ((d * sizeof(T)) % 16 == 0 && bases % 16 == 0)
    return launch<T, BQ, DP, true>(q, k, v, o, lse, bhkv, group, sq, sk, d,
                                   causal, window, q_offset, scale, st);
  return launch<T, BQ, DP, false>(q, k, v, o, lse, bhkv, group, sq, sk, d,
                                  causal, window, q_offset, scale, st);
}

template <typename T, int BQ>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      float* lse, int bhkv, int group, int sq, int sk, int d,
                      int causal, int window, int q_offset, float scale,
                      cudaStream_t st) {
  if (d <= 32)
    return launch_vec<T, BQ, 32>(q, k, v, o, lse, bhkv, group, sq, sk, d,
                                 causal, window, q_offset, scale, st);
  if (d <= 64)
    return launch_vec<T, BQ, 64>(q, k, v, o, lse, bhkv, group, sq, sk, d,
                                 causal, window, q_offset, scale, st);
  return launch_vec<T, BQ, 128>(q, k, v, o, lse, bhkv, group, sq, sk, d,
                                causal, window, q_offset, scale, st);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bhkv, int group, int sq, int sk, int d,
                     int causal, int window, int q_offset, float scale,
                     cudaStream_t st) {
  // a decode step's few rows (Sq·G <= 16) take the 16-row tile
  if ((long long)sq * group <= 16)
    return launch_dp<T, 16>(q, k, v, o, lse, bhkv, group, sq, sk, d, causal,
                            window, q_offset, scale, st);
  return launch_dp<T, 64>(q, k, v, o, lse, bhkv, group, sq, sk, d, causal,
                          window, q_offset, scale, st);
}


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------

// One key tile's scores of a thread's two rows h = 0, 1 (fragment element
// 4j + 2h + e is key column 8j + 2·quad + e of the tile). With MASK, column
// 8j + e + 2·quad is visible iff a[h] <= 8j + e < b[h] (a, b shifted by
// 2·quad); without, every column is. Scale and mask the scores (NEG_INF),
// then the online softmax: the row max (a tree over the thread's columns,
// then lanes ^1, ^2 of the quad), alpha = exp(m − m_new), p = exp(s − m_new)
// as 2^(s·log2 e − m_new·log2 e) left in sc, summed unrounded into l by a
// fixed tree (the same lanes). A visible column's arithmetic is the same
// with and without MASK.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBKT / 2],
                                             const int (&a)[2],
                                             const int (&b)[2], float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int NJ = kBKT / 8;                // 8-column groups a tile
  auto visible = [&](int h, int c) { return c >= a[h] && c < b[h]; };
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * h + e;
        const float v = __fmul_rn(sc[x], scale);
        sc[x] = !MASK || visible(h, 8 * j + e) ? v : kNegInf;
      }
  float mx[2], nm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      t[j] = fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
#pragma unroll
    for (int w = NJ / 2; w > 0; w /= 2)    // constant trip counts: unrolled
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j)
        if (j < w) t[j] = fmaxf(t[2 * j], t[2 * j + 1]);
    mx[h] = t[0];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], o));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2(__fmul_rn(__fsub_rn(m[h], m_new), kLog2e));
    nm[h] = __fmul_rn(m_new, -kLog2e);
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * h + e;
        const float p = ex2(__fmaf_rn(sc[x], kLog2e, nm[h]));
        sc[x] = !MASK || visible(h, 8 * j + e) ? p : 0.f;
      }
  float ps[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      t[j] = __fadd_rn(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
#pragma unroll
    for (int w = NJ / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j)
        if (j < w) t[j] = __fadd_rn(t[2 * j], t[2 * j + 1]);
    ps[h] = t[0];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ps[h] = __fadd_rn(ps[h], __shfl_xor_sync(~0u, ps[h], o));
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = __fadd_rn(__fmul_rn(alpha[h], l[h]), ps[h]);
}

// p (a tile's sc after softmax_tile) rounded to bf16 as the A fragments of
// the 16-key steps: pa[4kk..4kk + 3] of step kk hold columns 16kk.. =
// fragment groups 2kk and 2kk + 1, i.e. sc[8kk..8kk + 7] in pairs
__device__ __forceinline__ void pack_p(const float (&sc)[kBKT / 2],
                                       uint32_t (&pa)[kBKT / 4]) {
#pragma unroll
  for (int x = 0; x < kBKT / 4; ++x)
    pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
}

template <int NWG, int STAGES, int DP>
constexpr size_t bf16_smem_bytes() {
  // 1,024 bytes of slack to align the swizzled tiles, Q, the K/V ring, and
  // a full and an empty barrier a stage
  return 1024 + (size_t)NWG * 64 * DP * 2 +
         (size_t)STAGES * 2 * kBKT * DP * 2 + (size_t)STAGES * 2 * 8;
}

template <int NWG, int STAGES, int DP>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int group,
                                int sq, int sk, int d, int causal, int window,
                                int q_offset, float scale, int ntiles, int tma,
                                int qvec) {
  constexpr int ROWS = NWG * 64;              // query rows a CTA
  constexpr int NA = DP / 2;                  // acc floats a consumer thread
  constexpr int NS = kBKT / 2;                // score floats a thread
  constexpr int KSTEPS = kBKT / 16;           // 16-key steps of p·v
  constexpr int BLK = kBKT * 128;             // BK keys × 64 columns
  constexpr int TBYTES = kBKT * DP * 2;       // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + ROWS * DP * 2;           // [STAGES] tiles
  uint8_t* Vs = Ks + STAGES * TBYTES;         // [STAGES] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * TBYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x / ntiles;
  const int tile = ntiles - 1 - (int)(blockIdx.x % ntiles);
  const int r0 = tile * ROWS;         // sq·group < 2^31 (the launcher checks)
  const int nrows = min(ROWS, sq * group - r0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), tma ? 1 : 32);
      mbar_init(smem_u32(empty + s), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the band of keys some row of this tile sees, from its first BK-aligned
  // tile
  const int i_lo = r0 / group;
  const int i_hi = (r0 + nrows - 1) / group;
  long long k_begin = 0, k_end = sk;
  if (causal) k_end = min(k_end, (long long)i_hi + q_offset + 1);
  if (window > 0)
    k_begin = max(k_begin, (long long)i_lo + q_offset - window + 1);
  const long long kfirst = k_begin < k_end ? (k_begin / kBKT) * kBKT : k_end;
  const int ntile = (int)((k_end - kfirst + kBKT - 1) / kBKT);

  if (tid >= NWG * 128) {
    // producer warpgroup: its registers go to the consumers (two consumer
    // warpgroups hold acc, S and P in 240 each); its first warp fills the
    // ring
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid >= NWG * 128 + 32) return;
    const int lane = tid - NWG * 128;
    const __nv_bfloat16* kh = k + (size_t)hk * sk * d;
    const __nv_bfloat16* vh = v + (size_t)hk * sk * d;
    for (int t = 0; t < ntile; ++t) {
      const int s = t % STAGES, n = t / STAGES;
      const long long kb = kfirst + (long long)t * kBKT;
      if (n > 0) mbar_wait(smem_u32(empty + s), (n - 1) & 1);
      uint8_t* kt = Ks + s * TBYTES;
      uint8_t* vt = Vs + s * TBYTES;
      if (tma) {
        if (lane == 0) {
          const uint32_t bar = smem_u32(full + s);
          mbar_expect_tx(bar, 2 * TBYTES);
#pragma unroll
          for (int b = 0; b < DP / 64; ++b) {
            tma_load_3d(smem_u32(kt + b * BLK), &kmap, bar, 64 * b, (int)kb,
                        hk);
            tma_load_3d(smem_u32(vt + b * BLK), &vmap, bar, 64 * b, (int)kb,
                        hk);
          }
        }
      } else {
        const int nk = (int)min((long long)kBKT, (long long)sk - kb);
        stage_rows<DP>(kt, kBKT, nk, d, false, [&](int r) {
          return kh + (size_t)(kb + r) * d;
        }, lane, 32);
        stage_rows<DP>(vt, kBKT, nk, d, false, [&](int r) {
          return vh + (size_t)(kb + r) * d;
        }, lane, 32);
        fence_proxy_async();
        mbar_arrive(smem_u32(full + s));
      }
    }
    return;
  }

  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumer warpgroup wg: rows wg·64.. of the tile. In a wgmma m64nN
  // fragment a thread holds rows rl[0] = wg·64 + 16·warp + lane/4 and
  // rl[1] = rl[0] + 8; element 4j + 2h + e is row rl[h], column
  // 8j + 2·(lane mod 4) + e.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int quad = lane & 3;
  long long lo[2], hi[2];             // a row's visible keys [lo, hi)
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    const long long qpos = (long long)((r0 + rl) / group) + q_offset;
    valid[h] = rl < nrows;
    lo[h] = window > 0 ? max(0LL, qpos - window + 1) : 0;
    hi[h] = causal ? min((long long)sk, qpos + 1) : (long long)sk;
    if (!valid[h]) hi[h] = 0;
  }
  // warps without a row of the call (a decode step's padding) skip the
  // softmax and feed p = 0
  const bool live = __any_sync(~0u, valid[0] || valid[1]);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NA], sc[NS];
#pragma unroll
  for (int x = 0; x < NA; ++x) acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < NS; ++x) sc[x] = 0.f;
  uint32_t pa[4 * KSTEPS];
  const uint32_t qaddr = smem_u32(Qs) + wg * 64 * 128;
  // Q, while the producer starts on the ring; then a barrier of the
  // consumer warps alone (named barrier 1)
  stage_rows<DP>(Qs, ROWS, nrows, d, qvec != 0, [&](int r) {
    const int i = (r0 + r) / group, g = (r0 + r) % group;
    return q + (((size_t)hk * group + g) * sq + i) * d;
  }, tid, NWG * 128);
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");

  // S = Q · Kᵀ of ring stage s into sc: DP/16 steps of 16 columns, 32 bytes
  // into a 128-byte row (issued, not waited for)
  auto issue_scores = [&](int s) {
    const uint32_t kaddr = smem_u32(Ks + s * TBYTES);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n128(sc,
                    gmma_desc(qaddr + (kk >> 2) * ROWS * 128 + (kk & 3) * 32,
                              16, 1024),
                    gmma_desc(kaddr + (kk >> 2) * BLK + (kk & 3) * 32, 16,
                              1024),
                    kk > 0);
    wgmma_commit();
  };
  // acc += P · V of ring stage s: KSTEPS steps of 16 keys (16 rows × 128
  // bytes of the V tile); V's 64-column blocks are BLK apart (issued, not
  // waited for)
  auto issue_pv = [&](int s) {
    const uint32_t vaddr = smem_u32(Vs + s * TBYTES);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t dv = gmma_desc(vaddr + kk * 16 * 128, BLK, 1024);
      if constexpr (DP == 128)
        wgmma_rs_n128(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3], dv);
      else
        wgmma_rs_n64(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3], dv);
    }
    wgmma_commit();
  };
  // the softmax of tile t's scores (waited for): p left in sc, alpha
  auto softmax = [&](int t, float (&alpha)[2]) {
    fence_regs(sc);
    alpha[0] = alpha[1] = 1.f;
    if (!live) {
#pragma unroll
      for (int x = 0; x < NS; ++x) sc[x] = 0.f;
      return;
    }
    const long long kb = kfirst + (long long)t * kBKT;
    int a[2], b[2];                   // visible columns, shifted by 2·quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h] = (int)max(0LL, min((long long)kBKT, lo[h] - kb)) - 2 * quad;
      b[h] = (int)max(0LL, min((long long)kBKT, hi[h] - kb)) - 2 * quad;
    }
    // the mask only where some row of the warp does not see the whole tile
    if (__any_sync(~0u, a[0] > -2 * quad || b[0] < kBKT - 2 * quad ||
                            a[1] > -2 * quad || b[1] < kBKT - 2 * quad))
      softmax_tile<true>(sc, a, b, scale, m, l, alpha);
    else
      softmax_tile<false>(sc, a, b, scale, m, l, alpha);
  };

  // software pipeline: tile t + 1's scores run on the tensor cores while
  // tile t's p·v is issued and t + 1's softmax runs; acc is rescaled by
  // t + 1's alpha once t's p·v has landed, so acc = alpha·acc + p·v in the
  // order of an unpipelined loop. The loop body has no branch around a
  // wgmma, so the compiler can keep the two groups in flight.
  if (ntile > 0) {
    float alpha[2];
    mbar_wait(smem_u32(full), 0);
    issue_scores(0);
    wgmma_wait<0>();
    softmax(0, alpha);                // acc is 0: no rescale
    pack_p(sc, pa);
  }
  for (int t = 0; t + 1 < ntile; ++t) {
    const int s = t % STAGES, s1 = (t + 1) % STAGES;
    mbar_wait(smem_u32(full + s1), ((t + 1) / STAGES) & 1);
    issue_scores(s1);
    issue_pv(s);
    float alpha[2];
    wgmma_wait<1>();                  // tile t + 1's scores
    softmax(t + 1, alpha);
    wgmma_wait<0>();                  // tile t's p·v
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(smem_u32(empty + s));
    if (__any_sync(~0u, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll                        // (a factor 1 is exact: skipped)
      for (int x = 0; x < NA; ++x)
        acc[x] = __fmul_rn(acc[x], alpha[(x >> 1) & 1]);
    }
    pack_p(sc, pa);
  }
  if (ntile > 0) {                    // the last tile's p·v
    issue_pv((ntile - 1) % STAGES);
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    const int r = r0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    const int i = r / group, g = r % group;
    __nv_bfloat16* orow = o + (((size_t)hk * group + g) * sq + i) * d;
    const float den = fmaxf(l[h], 1e-30f);
    // the row's log-sum-exp for the backward kernel (the quad's four lanes
    // hold the same m and l)
    if (lse != nullptr && quad == 0)
      lse[((size_t)hk * group + g) * sq + i] = __fadd_rn(m[h], logf(den));
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * quad + e;
        if (col < d)
          orow[col] = __float2bfloat16(__fdiv_rn(acc[4 * j + 2 * h + e], den));
      }
  }
}


template <int NWG, int STAGES, int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bhkv, int group, int sq, int sk,
                        int d, int causal, int window, int q_offset,
                        float scale, cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<NWG, STAGES, DP>;
  constexpr size_t smem = bf16_smem_bytes<NWG, STAGES, DP>();
  // the attribute is per function and device, set at its first launch
  // there (not again: a launch may be captured into a CUDA graph)
  cudaError_t err = launch_log::optin_smem(
      reinterpret_cast<const void*>(kernel), (long long)smem);
  if (err != cudaSuccess) return err;
  constexpr int ROWS = NWG * 64;
  const long long rows = (long long)sq * group;
  const int ntiles = (int)((rows + ROWS - 1) / ROWS);
  const long long grid = (long long)bhkv * ntiles;
  if (rows > 0x7fffffffLL - ROWS || grid > 0x7fffffffLL ||
      (long long)sk + kBKT > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  // TMA for K and V: 16-byte-aligned bases and rows (d a multiple of 8)
  CUtensorMap kmap, vmap;
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  const int tma = d % 8 == 0 && kv % 16 == 0 && sk > 0;
  if (tma) {
    err = tma_map_3d(&kmap, k, bhkv, sk, d, kBKT);
    if (err == cudaSuccess) err = tma_map_3d(&vmap, v, bhkv, sk, d, kBKT);
    if (err != cudaSuccess) return err;
  }
  const int qvec = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  // variant: NWG·10,000 + STAGES·1,000 + DP
  launch_log::record("flash_attention_bf16_kernel",
                     NWG * 10000 + STAGES * 1000 + DP,
                     reinterpret_cast<const void*>(kernel), grid,
                     NWG * 128 + 128, smem);
  kernel<<<(unsigned)grid, NWG * 128 + 128, smem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, group, sq, sk, d, causal, window, q_offset, scale, ntiles, tma,
      qvec);
  return cudaGetLastError();
}

cudaError_t launch_bf16_form(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bhkv, int group,
                             int sq, int sk, int d, int causal, int window,
                             int q_offset, float scale, cudaStream_t st) {
  // a decode step's few rows (Sq·G <= 16): one 64-row warpgroup, a deeper
  // ring; prefill: two warpgroups (128 rows), two stages
  const bool decode = (long long)sq * group <= 16;
  if (d <= 64)
    return decode ? launch_bf16<1, 3, 64>(q, k, v, o, lse, bhkv, group, sq,
                                          sk, d, causal, window, q_offset,
                                          scale, st)
                  : launch_bf16<2, 3, 64>(q, k, v, o, lse, bhkv, group, sq,
                                          sk, d, causal, window, q_offset,
                                          scale, st);
  return decode ? launch_bf16<1, 3, 128>(q, k, v, o, lse, bhkv, group, sq,
                                         sk, d, causal, window, q_offset,
                                         scale, st)
                : launch_bf16<2, 3, 128>(q, k, v, o, lse, bhkv, group, sq,
                                         sk, d, causal, window, q_offset,
                                         scale, st);
}

}  // namespace

extern "C" {

// One launch on `stream` (not synchronised): o = attention(q, k, v) for
// q, o (bhkv·group, sq, d) and k, v (bhkv, sk, d), contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1), 1 <= d <= 128, sq >= 1, sk >= 0.
// causal is 0/1; window <= 0 means no window. A non-null `lse` (float32,
// (bhkv·group, sq)) receives each row's log-sum-exp m + log(max(l, 1e-30))
// of its scaled scores, for the backward kernel; null writes nothing, and
// o's bits are the same either way. Returns a cudaError_t (0 = the launch
// was accepted).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bhkv, int group, int sq,
                           int sk, int d, int causal, int window,
                           int q_offset, float scale, int bf16,
                           void* stream) {
  float* lse_f = static_cast<float*>(lse);
  if (d < 1 || d > 128 || sq < 1 || sk < 0 || bhkv < 1 || group < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bf16_form(q, k, v, o, lse_f, bhkv, group, sq, sk, d,
                            causal, window, q_offset, scale, st);
  return launch_t<float>(q, k, v, o, lse_f, bhkv, group, sq, sk, d, causal,
                         window, q_offset, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

LAUNCH_LOG_QUERY(flash_attention_kernel)
LAUNCH_LOG_QUERY(flash_attention_bf16_kernel)
LAUNCH_LOG_LIBRARY(flash_attention)
