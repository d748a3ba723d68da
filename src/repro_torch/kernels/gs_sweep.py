"""Dense column-serial Gauss-Seidel IEM sweep — the Hopper kernel's wrapper
and its plain PyTorch version.

One call of :func:`gs_sweep` computes what one launch of the JAX package's
``kernels/gs_sweep.py::gs_sweep_pallas`` computes: one sweep over the L
token columns of a bucketed (D, L) minibatch, each column an eq. 13
self-excluded E-step normalised over K (eq. 11) whose Δ-statistics fold into
θ̂ (D, K), φ̂ (W_s, K) and φ̂(k) before the next column reads them
(Gauss-Seidel), with the eq. 36 residual counts·|Δμ| emitted per token and,
with ``emit_loglik``, the post-sweep eq. 3 data log-likelihood.

* On CUDA tensors the wrapper runs the hand-written kernel
  ``csrc/gs_sweep.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, see
  ``kernels/build.py``): one C call that enqueues, per column, an E-step
  launch and a deterministic fold launch (``csrc/sweep_common.cuh``), and
  the stop-rule launch.  It never falls back.
* On CPU tensors it runs :func:`gs_sweep_reference`, the plain version: a
  port of the JAX package's ``ops._gs_sweep_portable`` with the E-step of
  ``ref.fused_estep_ref`` written out, and of ``ops._map_loglik`` as
  per-column :func:`loglik_partial` sums.

``gs_sweep.launches`` counts kernel calls (a plain integer): one per sweep,
each of which enqueues 2L CUDA launches (+1 with ``emit_loglik``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

SweepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, Optional[torch.Tensor]]


def loglik_partial(cnt: torch.Tensor, theta: torch.Tensor,
                   ptot: torch.Tensor, rows: torch.Tensor, wb: float, *,
                   alpha_m1: float, beta_m1: float) -> torch.Tensor:
    """One column's eq. 3 data-loglik partial against the given stats:
    Σ_d x_d · log max(Σ_k θ_d(k) φ_{w_d}(k), 1e-30), with θ̂ (D, K)
    normalised by eq. 9 and the gathered (D, K) φ̂ ``rows`` by eq. 10
    (``wb`` = W·(β−1) with the global W).  The arithmetic of the JAX
    package's ``gs_sweep.loglik_partial`` and ``em.map_log_likelihood``."""
    K = theta.shape[-1]
    th_den = theta.sum(-1, keepdim=True) + K * alpha_m1
    th_n = (theta + alpha_m1) / th_den.clamp_min(1e-30)
    ph_n = (rows + beta_m1) / (ptot + wb).clamp_min(1e-30)
    lik = (th_n * ph_n).sum(-1).clamp_min(1e-30)
    return (cnt * torch.log(lik)).sum()


def sweep_loglik(word_ids: torch.Tensor, counts: torch.Tensor,
                 theta: torch.Tensor, phi_wk: torch.Tensor,
                 phi_k: torch.Tensor, wb: float, *, alpha_m1: float,
                 beta_m1: float) -> torch.Tensor:
    """The post-sweep eq. 3 data log-likelihood as the sum of the L
    per-column :func:`loglik_partial` values (the kernels' stop-rule
    phase; ``ops._map_loglik`` of the JAX package)."""
    idx = word_ids.long()
    parts = [
        loglik_partial(counts[:, l], theta, phi_k, phi_wk[idx[:, l]], wb,
                       alpha_m1=alpha_m1, beta_m1=beta_m1)
        for l in range(word_ids.shape[1])
    ]
    if not parts:
        return torch.zeros((), dtype=theta.dtype, device=theta.device)
    return torch.stack(parts).sum()


def gs_sweep_reference(
    word_ids: torch.Tensor,    # (D, L) int — rows into phi_wk
    counts: torch.Tensor,      # (D, L) float32
    mu: torch.Tensor,          # (D, L, K)
    theta: torch.Tensor,       # (D, K)
    phi_wk: torch.Tensor,      # (W_s, K)
    phi_k: torch.Tensor,       # (K,)
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
    emit_loglik: bool = False,
) -> SweepOut:
    """The plain PyTorch version of :func:`gs_sweep`, any device.

    A port of ``ops._gs_sweep_portable``: a Python loop over the columns,
    each gathering its D φ̂ rows, running the fused E-step and folding Δ
    into θ̂, the D rows (``index_put_`` with accumulation: duplicate words
    add in document order on the CPU) and φ̂(k).
    """
    D, L = word_ids.shape
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    phi = phi_wk.clone()
    ptot = phi_k.clone()
    idx = word_ids.long()
    for l in range(L):
        wid = idx[:, l]
        cnt = counts[:, l, None]
        mu_old = mu[:, l]
        ex = cnt * mu_old
        th = (theta - ex).clamp_min(0.0)
        ph = (phi[wid] - ex).clamp_min(0.0)
        pt = ptot[None, :] - ex
        num = (th + alpha_m1) * (ph + beta_m1) / (pt + wb)
        mu_new = num / num.sum(-1, keepdim=True).clamp_min(1e-30)
        delta = cnt * mu_new - ex
        theta = theta + delta
        phi.index_put_((wid,), delta, accumulate=True)
        ptot = ptot + delta.sum(0)
        mu_out[:, l] = mu_new
        res[:, l] = cnt * (mu_new - mu_old).abs()
    if not L:
        theta = theta.clone()
    loglik = None
    if emit_loglik:
        loglik = sweep_loglik(word_ids, counts, theta, phi, ptot, wb,
                              alpha_m1=alpha_m1, beta_m1=beta_m1)
    return mu_out, res, theta, phi, ptot, loglik


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def column_segments(word_ids: torch.Tensor, live: torch.Tensor,
                    num_rows: int) -> Tuple[torch.Tensor, ...]:
    """The fold's per-column visiting order, on the device, without a sync.

    Each column's live tokens are sorted by word id, stably, so the
    documents of one word form a segment in document order; dead tokens
    (``live`` false) sort last and belong to no segment.  Returns four
    (L, D) int32 tensors: ``order`` (the document at each sorted position)
    and, compacted to the front of each column in position order and -1
    past the column's last segment, ``lead_pos``/``lead_end`` (a segment's
    first and one-past-last sorted position) and ``lead_word``.
    """
    D, L = word_ids.shape
    dev = word_ids.device
    key = torch.where(live, word_ids, num_rows).t()
    skey, order = torch.sort(key, dim=1, stable=True)
    pos = torch.arange(D, device=dev).expand(L, D)
    start = torch.ones((L, D), dtype=torch.bool, device=dev)
    start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    lead = start & (skey < num_rows)
    nxt = torch.full((L, D), D, dtype=torch.long, device=dev)
    nxt[:, :-1] = torch.where(start, pos, D)[:, 1:]
    seg_end = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values,
                         [1])
    first = torch.sort((~lead).to(torch.int32), dim=1, stable=True).indices
    valid = pos < lead.sum(1, keepdim=True)

    def compact(x):
        return torch.where(valid, x, -1).to(torch.int32).contiguous()

    return (order.to(torch.int32).contiguous(), compact(first),
            compact(seg_end.gather(1, first)), compact(skey.gather(1, first)))


def check_cuda_args(kernel: str, named: Sequence) -> None:
    """Every operand on one CUDA device, of the given dtype and shape, and
    contiguous; raise ValueError naming the first that is not."""
    dev = named[0][1].device
    for name, t, dtype, shape in named:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel}: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def dense_operands(word_ids, counts, mu, theta, phi_wk, phi_k):
    D, L = word_ids.shape
    K = mu.shape[-1]
    return [
        ("word_ids", word_ids, torch.int32, (D, L)),
        ("counts", counts, torch.float32, (D, L)),
        ("mu", mu, torch.float32, (D, L, K)),
        ("theta", theta, torch.float32, (D, K)),
        ("phi_wk", phi_wk, torch.float32, (phi_wk.shape[0], K)),
        ("phi_k", phi_k, torch.float32, (K,)),
    ]


def _launcher():
    from repro_torch.kernels import build

    lib = build.load("gs_sweep")
    fn = lib.gs_sweep_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 15 + [i, i, i, f, f, f, f, p]
        fn.restype = ctypes.c_int
        lib.gs_sweep_error_string.argtypes = [ctypes.c_int]
        lib.gs_sweep_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def gs_sweep(
    word_ids: torch.Tensor,    # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,      # (D, L) float32
    mu: torch.Tensor,          # (D, L, K) float32
    theta: torch.Tensor,       # (D, K) float32
    phi_wk: torch.Tensor,      # (W_s, K) float32
    phi_k: torch.Tensor,       # (K,) float32
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                 # W·(β−1), with the *global* W
    emit_loglik: bool = False,
) -> SweepOut:
    """One dense column-serial Gauss-Seidel sweep.

    Returns ``(mu_new (D,L,K), residual (D,L,K), theta (D,K), phi_wk
    (W_s,K), phi_k (K,), loglik)`` — the six outputs of
    ``gs_sweep_pallas``; ``loglik`` is None unless ``emit_loglik``.  CUDA
    tensors run the kernel (on the current stream, not synchronised; every
    output is a new tensor); CPU tensors run :func:`gs_sweep_reference`.
    Word ids must index rows of ``phi_wk``: the kernel writes φ̂ rows at
    them without a bound check (``ops.sweep`` checks).
    """
    wb = float(wb)
    if theta.device.type == "cpu":
        return gs_sweep_reference(
            word_ids, counts, mu, theta, phi_wk, phi_k, alpha_m1=alpha_m1,
            beta_m1=beta_m1, wb=wb, emit_loglik=emit_loglik,
        )
    if theta.device.type != "cuda":
        raise ValueError(f"gs_sweep runs on cuda or cpu, not {theta.device}")
    check_cuda_args("gs_sweep", dense_operands(word_ids, counts, mu, theta,
                                               phi_wk, phi_k))
    D, L = word_ids.shape
    K = mu.shape[-1]
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    theta_o, phi_o, ptot_o = theta.clone(), phi_wk.clone(), phi_k.clone()
    tok_ll = (torch.zeros((D, L), dtype=torch.float32, device=theta.device)
              if emit_loglik else None)
    if D and L and K:
        live = counts != 0
        segs = column_segments(word_ids, live, phi_wk.shape[0])
        delta = torch.empty((D, K), dtype=torch.float32, device=theta.device)
        live8 = live.to(torch.uint8)
        lib = _launcher()
        with torch.cuda.device(theta.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gs_sweep_launch(
                ptr(word_ids), ptr(counts), ptr(mu), ptr(mu_out), ptr(res),
                ptr(theta_o), ptr(phi_o), ptr(ptot_o), *map(ptr, segs),
                ptr(live8), ptr(delta), ptr(tok_ll), D, L, K,
                float(alpha_m1), float(beta_m1), wb, float(K * alpha_m1),
                stream,
            )
        if rc != 0:
            msg = lib.gs_sweep_error_string(rc).decode()
            raise RuntimeError(f"gs_sweep kernel launch failed: {msg} ({rc})")
        gs_sweep.launches += 1
    loglik = tok_ll.sum() if emit_loglik else None
    return mu_out, res, theta_o, phi_o, ptot_o, loglik


gs_sweep.launches = 0
