"""The two kernels of the two-phase topic-sharded sweep — the Hopper kernels'
wrappers and their plain PyTorch versions.

Under a topic-sharded ``SweepPlan`` each rank owns φ̂ (W, K/mp), θ̂
(D, K/mp) and μ (D, L, K/mp); the only cross-shard quantities of the
E-step are the per-token normalisers.  ``ops.sweep`` runs one sweep as:

* phase A — :func:`sharded_probe`: per token, against the sweep-start
  statistics (Jacobi, no fold), the shard's eq. 13 numerator sum s^m
  (D, L) and, scheduled, its eq. 38 previous active mass p^m (D, L).  It
  replaces the JAX package's ``kernels/sharded_sweep.py::
  sharded_probe_pallas``.
* phase B — one ``all_reduce`` of (s, p) over the model axis (``ops``).
* phase C — :func:`sharded_fold`: the shard-local column-serial
  Gauss-Seidel sweep whose per-token denominator is the live own-lane
  numerator sum plus ``remainder`` (the peers' probe sums); scheduled, it
  renormalises to the global ``prev_mass``.  It emits the live masses m^m
  and, with ``emit_loglik``, the per-token *pre-log* eq. 3 partials u^m
  against the final statistics.  It replaces ``sharded_fold_pallas``.
* phase D — one ``all_reduce`` of (m[, u, Σθ̂]) and the exact renorm
  (``ops``).

* On CUDA tensors the wrappers run the hand-written kernels of
  ``csrc/sharded_sweep.cu`` (built with ``nvcc`` for ``sm_90a`` at first
  use, see ``kernels/build.py``), or raise.  They never fall back.  The
  probe takes the path :func:`probe_path` picks: dense, a warp a token with
  16-byte lanes (scalar ones at K % 4 ≠ 0 or an unaligned base);
  scheduled, a power-of-two span of threads a token.  The
  fold runs its L columns in one persistent launch: scheduled, the
  active-set column loop of ``scheduled_sweep`` (a streaming pass, then
  the columns on the A lanes, folding in the orders of
  :func:`scheduled_sweep.fold_orders`); dense, a column loop whose φ̂(k)
  fold sums Δ over fixed document groups, then the groups in order.
* On CPU tensors they run :func:`sharded_probe_reference` and
  :func:`sharded_fold_reference`, the plain versions: ports of the JAX
  package's ``ops._probe_portable``, ``ops._fold_portable`` and
  ``ops._loglik_partials``.

``sharded_probe.launches`` and ``sharded_fold.launches`` count kernel calls
(plain integers).  ``sharded_fold.launches_per_call`` is the number of CUDA
operations the last fold call enqueued: 4 scheduled (the pass's copy and
zeroing launches, enqueued first, the barrier's zeroing, the column loop),
2 dense (no pass), +1 with ``emit_loglik``.

Launch budget (``analysis.contracts``: ``probe_dense_kernel``,
``probe_sched_kernel``, ``dense_loop_kernel``,
``active_loop_kernel_sharded``, ``loglik_u_kernel``, ``copy_kernel``,
``zero_kernel``): the probes and the u partials take no shared memory, the
dense fold 132 bytes of static shared memory a 512-thread CTA (a
cooperative launch, two an SM); the folds write the eq. 36 residuals.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import contracts, launches
from repro_torch.analysis.budget import Cell

from repro_torch.kernels.build import count_launch
from repro_torch.kernels.gs_sweep import (
    add_increment,
    check_cuda_args,
    column_segments,
    dense_operands,
    ptr,
    total_operand,
)
from repro_torch.kernels.scheduled_sweep import fold_orders, note_pass
from repro_torch.kernels.theta_sweep import word_lane_masks

#: Documents per φ̂(k) partial sum of the dense fold (kGroupDocs in
#: ``csrc/sharded_sweep.cu``).
FOLD_GROUP_DOCS = 32

class ProbePath(NamedTuple):
    kind: str   # "float4", "scalar" (dense) or "packed" (scheduled)
    code: int   # the kernel's path argument: dense 0 / 1; packed: threads
    # a token


def probe_path(K: int, A: int,
               operands: Sequence[torch.Tensor]) -> ProbePath:
    """The path of a ``sharded_probe`` launch: dense (A = 0), 16-byte
    lanes where K % 4 == 0 and every operand's base is 16-byte aligned,
    scalar lanes otherwise; scheduled, ``span`` threads a token — the least
    power of two ≥ A, at most 32 — so that 32 / span tokens share a warp.  A
    plain function of K, A and the addresses."""
    if A:
        return ProbePath("packed", contracts.probe_span(A))
    vec = K % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in operands)
    return ProbePath("float4" if vec else "scalar", 0 if vec else 1)


FoldOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def token_lane_masks(word_ids: torch.Tensor, word_topics: torch.Tensor,
                     num_topics: int,
                     token_active: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(D, L, K) float {0,1}: each token's word's active lanes, zero for a
    token ``token_active`` masks out — the JAX package's
    ``_word_lane_masks`` gathered at the tokens, without the (W, K)
    intermediate."""
    top = word_topics[word_ids.long()].long()                 # (D, L, A)
    mask = torch.zeros(tuple(word_ids.shape) + (num_topics,),
                       dtype=torch.float32, device=word_ids.device)
    mask.scatter_(2, top, 1.0)
    if token_active is None:
        return mask
    return mask * token_active.to(torch.float32)[..., None]


def loglik_partials(word_ids: torch.Tensor, theta: torch.Tensor,
                    phi_wk: torch.Tensor, phi_k: torch.Tensor, *,
                    alpha_m1: float, beta_m1: float, wb: float
                    ) -> torch.Tensor:
    """Per-token PRE-LOG eq. 3 partials over the shard's lanes, (D, L):
    u = Σ_k (θ̂+α−1)(φ̂_w+β−1)/max(φ̂(k)+W(β−1), 1e-30).  Summed over the
    model axis and divided by the global θ̂ normaliser this is the token
    likelihood (``ops._loglik_partials`` of the JAX package)."""
    rows = phi_wk[word_ids.long()]                            # (D, L, K)
    ph_n = (rows + beta_m1) / (phi_k + wb).clamp_min(1e-30)
    return ((theta[:, None, :] + alpha_m1) * ph_n).sum(-1)


def sharded_probe_reference(
    word_ids: torch.Tensor,      # (D, L) int — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    mu: torch.Tensor,            # (D, L, K) shard-local lanes
    theta: torch.Tensor,         # (D, K)
    phi_wk: torch.Tensor,        # (W, K)
    phi_k: torch.Tensor,         # (K,)
    word_topics: Optional[torch.Tensor] = None,   # (W, A) int: scheduled
    token_active: Optional[torch.Tensor] = None,  # (D, L) bool: scheduled
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of :func:`sharded_probe`, any device: a
    port of ``ops._probe_portable`` — the whole (D, L) batch in one
    vectorised pass against the sweep-start statistics."""
    rows = phi_wk[word_ids.long()]                            # (D, L, K)
    mask = None
    if word_topics is not None:
        mask = word_lane_masks(phi_wk, word_topics)[word_ids.long()] * (
            token_active.to(mu.dtype)[..., None])
        ex = counts[..., None] * mu * mask
    else:
        ex = counts[..., None] * mu
    th = (theta[:, None, :] - ex).clamp_min(0.0)
    ph = (rows - ex).clamp_min(0.0)
    pt = phi_k[None, None, :] - ex
    num = (th + alpha_m1) * (ph + beta_m1) / (pt + wb)
    if mask is not None:
        num = num * mask
        return num.sum(-1), (mu * mask).sum(-1)
    return num.sum(-1), None


def sharded_fold_reference(
    word_ids: torch.Tensor,      # (D, L) int — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    mu: torch.Tensor,            # (D, L, K) shard-local lanes
    theta: torch.Tensor,         # (D, K)
    phi_wk: torch.Tensor,        # (W, K)
    phi_k: torch.Tensor,         # (K,)
    remainder: torch.Tensor,     # (D, L) peers' numerator sums (phase B)
    prev_mass: Optional[torch.Tensor] = None,     # (D, L) global eq. 38 mass
    word_topics: Optional[torch.Tensor] = None,   # (W, A) int: scheduled
    token_active: Optional[torch.Tensor] = None,  # (D, L) bool: scheduled
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
    emit_loglik: bool = False,
    phi_k64: Optional[torch.Tensor] = None,
) -> FoldOut:
    """The plain PyTorch version of :func:`sharded_fold`, any device.

    A port of ``ops._fold_portable`` — a Python loop over the columns, each
    gathering its D φ̂ rows, running the E-step with the own-lane sum live
    and the peers' ``remainder`` injected, and folding Δ into θ̂, the rows
    (``index_put_`` with accumulation) and φ̂(k) — followed, with
    ``emit_loglik``, by :func:`loglik_partials` on the final statistics.
    ``phi_k64`` is ``gs_sweep_reference``'s: each column's float32 φ̂(k)
    increment added in float64, in place.
    """
    scheduled = word_topics is not None
    D, L = word_ids.shape
    masks = word_lane_masks(phi_wk, word_topics) if scheduled else None
    act = token_active.to(mu.dtype) if scheduled else None
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    live = torch.empty_like(counts)
    phi = phi_wk.clone()
    ptot = phi_k.clone()
    idx = word_ids.long()
    for l in range(L):
        wid = idx[:, l]
        cnt = counts[:, l, None]
        mu_old = mu[:, l]
        if scheduled:
            mask = masks[wid] * act[:, l, None]
            ex = cnt * mu_old * mask
        else:
            ex = cnt * mu_old
        th = (theta - ex).clamp_min(0.0)
        ph = (phi[wid] - ex).clamp_min(0.0)
        pt = ptot[None, :] - ex
        num = (th + alpha_m1) * (ph + beta_m1) / (pt + wb)
        if scheduled:
            num = num * mask
        denom = (remainder[:, l, None] + num.sum(-1, keepdim=True)
                 ).clamp_min(1e-30)
        if scheduled:
            mu_new = mask * (num / denom * prev_mass[:, l, None]) + (
                1.0 - mask) * mu_old
            delta = cnt * (mu_new - mu_old)
            res[:, l] = delta.abs()
            live[:, l] = (mu_new * mask).sum(-1)
        else:
            mu_new = num / denom
            delta = cnt * mu_new - ex
            res[:, l] = cnt * (mu_new - mu_old).abs()
            live[:, l] = mu_new.sum(-1)
        theta = theta + delta
        phi.index_put_((wid,), delta, accumulate=True)
        ptot = add_increment(ptot, delta.sum(0), phi_k64)
        mu_out[:, l] = mu_new
    if not L:
        theta = theta.clone()
    u = None
    if emit_loglik:
        u = loglik_partials(word_ids, theta, phi, ptot, alpha_m1=alpha_m1,
                            beta_m1=beta_m1, wb=wb)
    return mu_out, res, theta, phi, ptot, live, u


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    """The library's ctypes signatures, set once (``build.load``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sharded_probe_launch.argtypes = (
        [p] * 8 + [i, p, p, i, i, i, i, f, f, f, p])
    lib.sharded_probe_launch.restype = ctypes.c_int
    lib.sharded_fold_launch.argtypes = (
        [p] * 13 + [i] + [p] * 16 + [i, i, i, f, f, f,
                                     ctypes.POINTER(i), p])
    lib.sharded_fold_launch.restype = ctypes.c_int
    lib.sharded_pass_launch.argtypes = [p, p, p, ctypes.c_size_t, p]
    lib.sharded_pass_launch.restype = ctypes.c_int
    lib.sharded_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sharded_sweep_error_string.restype = ctypes.c_char_p


def _launcher():
    from repro_torch.kernels import build

    return build.load("sharded_sweep", _bind)


def _sched_operands(kernel, word_ids, K, W, word_topics, token_active):
    """The scheduled operands' checks; returns A (0 when dense)."""
    if word_topics is None:
        if token_active is not None:
            raise ValueError(f"{kernel}: token_active without word_topics")
        return 0, []
    D, L = word_ids.shape
    A = word_topics.shape[-1] if word_topics.ndim == 2 else -1
    if not 0 < A <= K:
        raise ValueError(f"{kernel}: word_topics needs 1 <= A <= K")
    return A, [("word_topics", word_topics, torch.int32, (W, A)),
               ("token_active", token_active, torch.bool, (D, L))]


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.sharded_sweep_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def sharded_probe(
    word_ids: torch.Tensor,      # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    mu: torch.Tensor,            # (D, L, K) float32 shard-local lanes
    theta: torch.Tensor,         # (D, K) float32
    phi_wk: torch.Tensor,        # (W, K) float32
    phi_k: torch.Tensor,         # (K,) float32
    word_topics: Optional[torch.Tensor] = None,   # (W, A) int32: scheduled
    token_active: Optional[torch.Tensor] = None,  # (D, L) bool: scheduled
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                   # W·(β−1), with the *global* W
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Phase A: the shard's per-token normaliser partials.

    Returns ``(s (D, L), prev_mass (D, L) or None)`` — the outputs of
    ``sharded_probe_pallas``.  CUDA tensors run the kernel (on the current
    stream, not synchronised); CPU tensors run
    :func:`sharded_probe_reference`.  Word ids must index rows of
    ``phi_wk`` and ``word_topics`` lanes, distinct in each row: the kernel
    does not check (``ops.sweep`` checks the ranges).
    """
    wb = float(wb)
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb)
    if theta.device.type == "cpu":
        return sharded_probe_reference(word_ids, counts, mu, theta, phi_wk,
                                       phi_k, word_topics, token_active, **kw)
    if theta.device.type != "cuda":
        raise ValueError(f"sharded_probe runs on cuda or cpu, not "
                         f"{theta.device}")
    D, L = word_ids.shape
    K = mu.shape[-1]
    W = phi_wk.shape[0]
    A, sched = _sched_operands("sharded_probe", word_ids, K, W,
                               word_topics, token_active)
    check_cuda_args("sharded_probe", dense_operands(
        word_ids, counts, mu, theta, phi_wk, phi_k) + sched)
    # the kernel writes every token's s (and p)
    s = torch.empty((D, L), dtype=torch.float32, device=theta.device)
    pm = torch.empty_like(s) if A else None
    if D and L:
        path = probe_path(K, A, [mu, theta, phi_wk, phi_k])
        lib = _launcher()
        with torch.cuda.device(theta.device):
            # a bool tensor's bytes are the kernel's (D, L) 0/1 bytes
            rc = lib.sharded_probe_launch(
                ptr(word_ids), ptr(counts), ptr(token_active), ptr(mu),
                ptr(theta),
                ptr(phi_wk), ptr(phi_k), ptr(word_topics), A, ptr(s),
                ptr(pm), D, L, K, path.code, float(alpha_m1),
                float(beta_m1), wb, torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc, "sharded_probe")
        if launches.enabled():
            cell = Cell(D=D, L=L, K=K, W_s=W, A=A)
            if A:
                launches.note("sharded_sweep", "probe_sched_kernel", cell)
            else:
                launches.note("sharded_sweep", "probe_dense_kernel", cell,
                              vec=path.code == 0)
        count_launch(sharded_probe)
    return s, pm


sharded_probe.launches = 0


def sharded_fold(
    word_ids: torch.Tensor,      # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    mu: torch.Tensor,            # (D, L, K) float32 shard-local lanes
    theta: torch.Tensor,         # (D, K) float32
    phi_wk: torch.Tensor,        # (W, K) float32
    phi_k: torch.Tensor,         # (K,) float32
    remainder: torch.Tensor,     # (D, L) float32 peers' numerator sums
    prev_mass: Optional[torch.Tensor] = None,     # (D, L) float32: scheduled
    word_topics: Optional[torch.Tensor] = None,   # (W, A) int32: scheduled
    token_active: Optional[torch.Tensor] = None,  # (D, L) bool: scheduled
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                   # W·(β−1), with the *global* W
    emit_loglik: bool = False,
    phi_k64: Optional[torch.Tensor] = None,  # (K,) float64 total, in place
) -> FoldOut:
    """Phase C: the shard-local Gauss-Seidel fold.

    Returns ``(mu_new (D,L,K), residual (D,L,K), theta (D,K), phi_wk (W,K),
    phi_k (K,), live_mass (D,L), u (D,L) or None)`` — the outputs of
    ``sharded_fold_pallas``.  With ``remainder == 0`` (and ``prev_mass``
    the local active mass) this is ``gs_sweep``/``scheduled_sweep``.  CUDA
    tensors run the kernel (on the current stream, not synchronised; every
    output is a new tensor); CPU tensors run
    :func:`sharded_fold_reference`.  ``phi_k64`` is
    ``gs_sweep.gs_sweep``'s: φ̂(k)'s float64 total, the fold's own
    increments added in place.
    """
    wb = float(wb)
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb,
              emit_loglik=emit_loglik, phi_k64=phi_k64)
    if theta.device.type == "cpu":
        return sharded_fold_reference(
            word_ids, counts, mu, theta, phi_wk, phi_k, remainder, prev_mass,
            word_topics, token_active, **kw)
    if theta.device.type != "cuda":
        raise ValueError(f"sharded_fold runs on cuda or cpu, not "
                         f"{theta.device}")
    D, L = word_ids.shape
    K = mu.shape[-1]
    W = phi_wk.shape[0]
    A, sched = _sched_operands("sharded_fold", word_ids, K, W,
                               word_topics, token_active)
    cols = [("remainder", remainder, torch.float32, (D, L))]
    if A:
        cols.append(("prev_mass", prev_mass, torch.float32, (D, L)))
    check_cuda_args("sharded_fold", dense_operands(
        word_ids, counts, mu, theta, phi_wk, phi_k) + sched + cols
        + total_operand(phi_k64, phi_k))
    dev = theta.device
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    passes = 2 if A and D and L else 0
    if passes:
        # the pass first: the orders and copies below queue up behind it
        lib = _launcher()
        with torch.cuda.device(dev):
            rc = lib.sharded_pass_launch(
                ptr(mu), ptr(mu_out), ptr(res), mu.numel(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc, "sharded_fold")
    theta_o, phi_o, ptot_o = theta.clone(), phi_wk.clone(), phi_k.clone()
    live_m = torch.zeros((D, L), dtype=torch.float32, device=dev)
    u = torch.zeros_like(live_m) if emit_loglik else None
    if D and L:
        f32 = dict(dtype=torch.float32, device=dev)
        if A:
            live = token_active & (counts != 0)
            orders = (None,) * 5 + fold_orders(word_ids, live, W,
                                               word_topics, K)
            compact = torch.empty((D, A), **f32)
            parts = torch.empty_like(compact)
            delta = part = None
        else:
            orders = column_segments(word_ids, counts != 0, W) + (None,) * 4
            compact = parts = None
            delta = torch.empty((D, K), **f32)
            part = torch.empty(((D + FOLD_GROUP_DOCS - 1) // FOLD_GROUP_DOCS,
                                K), **f32)
        barrier = torch.empty((1,), dtype=torch.int32, device=dev)
        act8 = token_active.to(torch.uint8) if A else None
        enqueued = ctypes.c_int(0)
        lib = _launcher()
        with torch.cuda.device(dev):
            rc = lib.sharded_fold_launch(
                ptr(word_ids), ptr(counts), ptr(act8), ptr(remainder),
                ptr(prev_mass), ptr(mu), ptr(mu_out), ptr(res),
                ptr(theta_o), ptr(phi_o), ptr(ptot_o), ptr(phi_k64),
                ptr(word_topics), A,
                *map(ptr, orders), ptr(delta), ptr(part), ptr(compact),
                ptr(parts), ptr(barrier), ptr(live_m), ptr(u), D, L, K,
                float(alpha_m1), float(beta_m1), wb, ctypes.byref(enqueued),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc, "sharded_fold")
        if launches.enabled():
            cell = Cell(D=D, L=L, K=K, W_s=W, A=A)
            if A:
                note_pass("sharded_sweep", cell, mu, mu_out, res,
                          loop="active_loop_kernel_sharded")
            else:
                launches.note("sharded_sweep", "dense_loop_kernel", cell)
            if emit_loglik:
                launches.note("sharded_sweep", "loglik_u_kernel", cell)
        count_launch(sharded_fold)
        sharded_fold.launches_per_call = passes + enqueued.value
    return mu_out, res, theta_o, phi_o, ptot_o, live_m, u


sharded_fold.launches = 0
sharded_fold.launches_per_call = 0
