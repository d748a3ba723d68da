"""Scheduled active-set E-step (paper §3.1, eq. 38) — the Hopper kernel's
wrapper and its plain PyTorch version.

One call of :func:`topk_estep` computes what one launch of the JAX package's
``kernels/topk_estep.py::topk_estep_pallas`` computes, on (T, A) slabs the
caller gathered at each token's A active topics: the eq. 13 self-excluded
numerators, zeroed on pad lanes, renormalised to the token's previous active
mass (eq. 38); tokens the λ_w mask leaves inactive keep μ_prev; and
delta = counts·(μ_new − μ_prev).  The blocked and ``"scan"`` scheduled
sweeps (``foem.scheduled_iem_sweep``) run it once per block.

The pad-lane rule is the TPU kernel's (``topk_estep.py:36-38``): a lane
with μ_prev ≤ 0 and θ̂ ≤ 0 gets a zero numerator.  ``ref.topk_estep_ref``
of the JAX package has no such rule; the two agree wherever no lane is a
pad lane.

* On CUDA tensors the wrapper runs the hand-written kernel
  ``csrc/topk_estep.cu`` (one warp per token): it never falls back.
* On CPU tensors it runs :func:`topk_estep_reference`, the plain version.

``topk_estep.launches`` counts kernel launches (a plain integer).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.gs_sweep import check_cuda_args, ptr


def topk_estep_reference(
    theta_a: torch.Tensor,     # (T, A) θ̂ on the active topics
    phi_a: torch.Tensor,       # (T, A)
    ptot_a: torch.Tensor,      # (T, A)
    mu_prev_a: torch.Tensor,   # (T, A) previous normalised μ on the set
    counts: torch.Tensor,      # (T,)
    active: torch.Tensor,      # (T,) bool — the word passes the λ_w mask
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`topk_estep`, any device: the TPU
    kernel's arithmetic, pad-lane rule included."""
    cnt = counts[:, None]
    ex = cnt * mu_prev_a
    th = (theta_a - ex).clamp_min(0.0)
    ph = (phi_a - ex).clamp_min(0.0)
    pt = ptot_a - ex
    num = (th + alpha_m1) * (ph + beta_m1) / (pt + wb)
    pad = (mu_prev_a <= 0.0) & (theta_a <= 0.0)
    num = torch.where(pad, 0.0, num)
    prev_mass = mu_prev_a.sum(-1, keepdim=True)
    mu_new = num / num.sum(-1, keepdim=True).clamp_min(1e-30) * prev_mass
    mu_new = torch.where(active[:, None].bool(), mu_new, mu_prev_a)
    return mu_new, cnt * (mu_new - mu_prev_a)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def _launcher():
    from repro_torch.kernels import build

    lib = build.load("topk_estep")
    fn = lib.topk_estep_launch
    if fn.argtypes is None:
        p, f = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [p] * 8 + [ctypes.c_longlong, ctypes.c_int, f, f, f, p]
        fn.restype = ctypes.c_int
        lib.topk_estep_error_string.argtypes = [ctypes.c_int]
        lib.topk_estep_error_string.restype = ctypes.c_char_p
    return lib


def topk_estep(
    theta_a: torch.Tensor,     # (T, A) float32
    phi_a: torch.Tensor,       # (T, A) float32
    ptot_a: torch.Tensor,      # (T, A) float32
    mu_prev_a: torch.Tensor,   # (T, A) float32
    counts: torch.Tensor,      # (T,) float32
    active: torch.Tensor,      # (T,) bool
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                 # W·(β−1), with the *global* W
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The active-set E-step: ``(mu_new (T, A), delta (T, A))``.

    CUDA tensors run the kernel (on the current stream, not synchronised;
    the outputs are new tensors); CPU tensors run
    :func:`topk_estep_reference`.  Any A ≥ 1 (lanes past the warp width are
    strided).
    """
    wb = float(wb)
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb)
    if mu_prev_a.device.type == "cpu":
        return topk_estep_reference(theta_a, phi_a, ptot_a, mu_prev_a,
                                    counts, active, **kw)
    if mu_prev_a.device.type != "cuda":
        raise ValueError(f"topk_estep runs on cuda or cpu, not "
                         f"{mu_prev_a.device}")
    T, A = mu_prev_a.shape
    f32 = torch.float32
    check_cuda_args("topk_estep", [
        ("mu_prev_a", mu_prev_a, f32, (T, A)),
        ("theta_a", theta_a, f32, (T, A)),
        ("phi_a", phi_a, f32, (T, A)),
        ("ptot_a", ptot_a, f32, (T, A)),
        ("counts", counts, f32, (T,)),
        ("active", active, torch.bool, (T,)),
    ])
    mu = torch.empty_like(mu_prev_a)
    delta = torch.empty_like(mu_prev_a)
    if T and A:
        lib = _launcher()
        with torch.cuda.device(mu_prev_a.device):
            rc = lib.topk_estep_launch(
                ptr(theta_a), ptr(phi_a), ptr(ptot_a), ptr(mu_prev_a),
                ptr(counts), ptr(active), ptr(mu), ptr(delta), T, A,
                float(alpha_m1), float(beta_m1), wb,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = lib.topk_estep_error_string(rc).decode()
            raise RuntimeError(f"topk_estep kernel launch failed: {msg} "
                               f"({rc})")
        topk_estep.launches += 1
    return mu, delta


topk_estep.launches = 0
