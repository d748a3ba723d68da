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
// padding copies.
//
// Layout: q, o (BH, Sq, d); k, v (BHkv, Sk, d); all contiguous, one type
// (float32 or bfloat16), 1 <= d <= 128.
//
// Bound on this card. Prefill is bounded by operations: a causal granite-8b
// layer (B = 8, 32 heads, S = 2,048, d = 128) is 2.7e11 flops over 0.2 GB of
// q, k, v and o. Decode (Sq = 1 against a 2,048–4,096-deep cache) is bounded
// by bytes: every visible key and value is read once, ≈ 4 operations a byte.
//
// Design, simple and exact first (no tensor cores, no TMA: later work).
// * A CTA takes one KV head and a tile of BQ rows of the (i, g) pairs of its
//   G query heads, row r = i·G + g. The G heads that share a KV head share
//   its K/V tiles, which are read once per tile of rows and not G times; a
//   decode step (Sq = 1) is G rows, so it runs the BQ = 16 form and warps
//   without a live row skip the arithmetic.
// * A loop over the key tiles (BK = 64) takes the place of the TPU's
//   sequential KV grid axis. Only tiles inside the rows' causal / window band
//   are visited: a tile that the mask hides entirely would leave m, l and
//   acc unchanged, so the skip is exact (the TPU code visits every tile).
//   Decode thus reads cache_pos + 1 keys, not the whole cache.
// * K and V tiles are staged in shared memory as float32 (K with an XOR
//   swizzle of its 16-byte chunks, so a warp's float4 reads of 32 keys are
//   conflict-free); Q stays staged for the CTA's life. 112 KB at d = 128:
//   two CTAs an SM. Rows of 16-byte multiples (d = 32, 120, 128 in bf16)
//   are staged with 16-byte loads, each thread's issued before any is used,
//   so a tile costs about one memory latency; other d load element-wise.
// * Each warp owns BQ/8 rows (its scores, online-softmax carries and
//   accumulators live in registers); a lane owns keys lane and lane + 32 of
//   a tile and output columns 4·lane..4·lane+3 (at d = 128). p goes through
//   a warp-private shared row, so only the K/V staging needs block barriers.
// * Row maxima and sums are warp butterflies: every lane gets the same bits,
//   and the order of every sum is fixed, so two launches give the same bits.
// * The heaviest row tiles (the causal band's end) are launched first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;               // keys a tile
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// p rounded to v's type, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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
template <int DP, bool SWZ>
__device__ __forceinline__ void put16(float* tile, int r, int cc,
                                      uint4 raw, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  put4<DP, SWZ>(tile, r, 2 * cc, make_float4(a.x, a.y, b.x, b.y));
  put4<DP, SWZ>(tile, r, 2 * cc + 1, make_float4(c.x, c.y, e.x, e.y));
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
                           int group, int sq, int sk, int d, int causal,
                           int window, int q_offset, float scale,
                           int ntiles) {
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
  }
}

template <typename T, int BQ, int DP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bhkv, int group, int sq, int sk, int d, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, BQ, DP, VEC>;
  constexpr size_t smem = smem_bytes<BQ, DP>();
  // the attributes are per function and device, set at its first launch
  // there (not again: a launch may be captured into a CUDA graph)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const long long rows = (long long)sq * group;
  const int ntiles = (int)((rows + BQ - 1) / BQ);
  const long long grid = (long long)bhkv * ntiles;
  if (rows > 0x7fffffffLL - BQ || grid > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, sk, d, causal,
      window, q_offset, scale, ntiles);
  return cudaGetLastError();
}

template <typename T, int BQ, int DP>
cudaError_t launch_vec(const void* q, const void* k, const void* v, void* o,
                       int bhkv, int group, int sq, int sk, int d, int causal,
                       int window, int q_offset, float scale,
                       cudaStream_t st) {
  // 16-byte loads when every row is a whole number of aligned 16 bytes
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if ((d * sizeof(T)) % 16 == 0 && bases % 16 == 0)
    return launch<T, BQ, DP, true>(q, k, v, o, bhkv, group, sq, sk, d, causal,
                                   window, q_offset, scale, st);
  return launch<T, BQ, DP, false>(q, k, v, o, bhkv, group, sq, sk, d, causal,
                                  window, q_offset, scale, st);
}

template <typename T, int BQ>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      int bhkv, int group, int sq, int sk, int d, int causal,
                      int window, int q_offset, float scale,
                      cudaStream_t st) {
  if (d <= 32)
    return launch_vec<T, BQ, 32>(q, k, v, o, bhkv, group, sq, sk, d,
                                 causal, window, q_offset, scale, st);
  if (d <= 64)
    return launch_vec<T, BQ, 64>(q, k, v, o, bhkv, group, sq, sk, d,
                                 causal, window, q_offset, scale, st);
  return launch_vec<T, BQ, 128>(q, k, v, o, bhkv, group, sq, sk, d, causal,
                                window, q_offset, scale, st);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     int bhkv, int group, int sq, int sk, int d, int causal,
                     int window, int q_offset, float scale, cudaStream_t st) {
  // a decode step's few rows (Sq·G <= 16) take the 16-row tile
  if ((long long)sq * group <= 16)
    return launch_dp<T, 16>(q, k, v, o, bhkv, group, sq, sk, d, causal,
                            window, q_offset, scale, st);
  return launch_dp<T, 64>(q, k, v, o, bhkv, group, sq, sk, d, causal, window,
                          q_offset, scale, st);
}

}  // namespace

extern "C" {

// One launch on `stream` (not synchronised): o = attention(q, k, v) for
// q, o (bhkv·group, sq, d) and k, v (bhkv, sk, d), contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1), 1 <= d <= 128, sq >= 1, sk >= 0.
// causal is 0/1; window <= 0 means no window. Returns a cudaError_t
// (0 = the launch was accepted).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bhkv, int group, int sq, int sk,
                           int d, int causal, int window, int q_offset,
                           float scale, int bf16, void* stream) {
  if (d < 1 || d > 128 || sq < 1 || sk < 0 || bhkv < 1 || group < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_t<__nv_bfloat16>(q, k, v, o, bhkv, group, sq, sk, d,
                                   causal, window, q_offset, scale, st);
  return launch_t<float>(q, k, v, o, bhkv, group, sq, sk, d, causal, window,
                         q_offset, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
