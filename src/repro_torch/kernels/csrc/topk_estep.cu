// Scheduled active-set E-step (paper §3.1, eq. 38) over (tokens × A) slabs
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/topk_estep.py::topk_estep_pallas of the
// JAX package. The caller gathers, per token t, its word's A active topics:
// θ̂_a, φ̂_a, φ̂(k)_a and the previous normalised μ_prev,a (T, A). Then, on
// each active lane a:
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
// Bound on this card: device-memory bytes, and below that the launch. At the
// stream_1k width (A = 16) a blocked sweep's block of T = 16,384 tokens
// moves 4 input slabs, 2 output slabs, counts and the mask, ≈ 6.4 MB:
// ≈ 1.9 µs at 3.35 TB/s, about the cost of the launch itself.
//
// Design. One warp per token, eight tokens per CTA; lane j takes the active
// lanes j, j + 32, … (A ≤ 32 is one lane each, A = 16 at stream_1k; larger A
// is strided, not refused). The first pass stages the numerators in the μ
// output and sums the numerators and μ_prev per thread; two warp sums in a
// fixed shuffle order, broadcast from lane 0, give every lane the same
// denominator and previous mass; the second pass (same lane, same entries)
// normalises and writes delta. A token's bits depend on nothing but its own
// row, and nothing is atomic: two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

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
  topk_estep_kernel<<<grid, kWarpThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta_a), static_cast<const float*>(phi_a),
      static_cast<const float*>(ptot_a), static_cast<const float*>(mu_prev),
      static_cast<const float*>(counts), static_cast<const uint8_t*>(active),
      static_cast<float*>(mu_out), static_cast<float*>(delta_out), T, A,
      alpha_m1, beta_m1, wb);
  return cudaGetLastError();
}

const char* topk_estep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
