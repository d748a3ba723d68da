"""Scheduled (active-set) column-serial Gauss-Seidel IEM sweep — the Hopper
kernel's wrapper and its plain PyTorch version.

One call of :func:`scheduled_sweep` computes what one launch of the JAX
package's ``kernels/scheduled_sweep.py::scheduled_sweep_pallas`` computes:
the sweep of :func:`gs_sweep.gs_sweep` restricted to each word's (W_s, A)
active topics (paper §3.1), with the eq. 38 partial renormalisation to the
active set's previous mass and the λ_w ``token_active`` mask.  Inactive
(token, topic) entries keep μ_old and carry a zero residual; the residual
is the eq. 36 replacement value |Δ| = counts·|μ_new − μ_old|, full-K.

* On CUDA tensors the wrapper runs the hand-written kernel
  ``csrc/scheduled_sweep.cu`` (built like ``gs_sweep``): a streaming pass
  writes μ_new = μ and residual = 0, then one persistent launch runs the L
  columns on the A active lanes only, folding Δ in the visiting orders of
  :func:`fold_orders`.  It never falls back.
* On CPU tensors it runs :func:`scheduled_sweep_reference`, a port of the
  JAX package's ``ops._sched_sweep_portable`` (masked full-K arithmetic
  over a (W_s, K) word lane mask).

``scheduled_sweep.launches`` counts kernel calls: one per sweep.
``scheduled_sweep.launches_per_call`` is the number of CUDA operations the
last call enqueued: 4 (the pass's copy and zeroing launches, enqueued
first, the barrier's zeroing, the column loop), +1 with ``emit_loglik``.

Launch budget (``analysis.contracts``: ``copy_kernel``, ``zero_kernel``,
``active_loop_kernel``, ``sweep_loglik_kernel``): the pass and the column
loop take no shared memory; the loop is one cooperative launch of
256-thread CTAs, at most two an SM, running the eq. 13 self-excluded
E-step and the eq. 38 renormalisation on the active lanes.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from repro_torch.analysis import launches
from repro_torch.analysis.budget import Cell

from repro_torch.kernels.build import count_launch
from repro_torch.kernels.gs_sweep import (
    SweepOut,
    add_increment,
    check_cuda_args,
    dense_operands,
    note_loglik,
    ptr,
    sweep_loglik,
    total_operand,
)
from repro_torch.kernels.theta_sweep import word_lane_masks


def scheduled_sweep_reference(
    word_ids: torch.Tensor,      # (D, L) int — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    mu: torch.Tensor,            # (D, L, K)
    theta: torch.Tensor,         # (D, K)
    phi_wk: torch.Tensor,        # (W_s, K)
    phi_k: torch.Tensor,         # (K,)
    word_topics: torch.Tensor,   # (W_s, A) int — active topic ids per word
    token_active: torch.Tensor,  # (D, L) bool — λ_w word mask per token
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
    emit_loglik: bool = False,
    hook: Optional[Callable[..., Tuple[torch.Tensor, ...]]] = None,
    phi_k64: Optional[torch.Tensor] = None,
) -> SweepOut:
    """The plain PyTorch version of :func:`scheduled_sweep`, any device.

    A port of ``ops._sched_sweep_portable``: the active sets expand once
    into a (W_s, K) word lane mask; each column gathers its D mask and φ̂
    rows, runs the masked full-K E-step (eq. 13 exclusion on the active
    lanes, eq. 38 renorm, λ_w folded into the mask) and folds Δ.

    ``hook`` is the per-column hooks mode's reduction (the JAX package's
    ``renorm_psum``): each column's (D, 1) eq. 38 previous mass and new
    sum go through ONE ``hook(prev_mass, new_sum) -> (prev_mass,
    new_sum)`` call — a topic-sharded sweep's sums over the model axis,
    the union active set — before the renorm.  ``None`` leaves the loop as
    it is, bit for bit.  ``phi_k64`` is :func:`gs_sweep_reference`'s.
    """
    D, L = word_ids.shape
    masks = word_lane_masks(phi_wk, word_topics)
    act = token_active.to(mu.dtype)
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    phi = phi_wk.clone()
    ptot = phi_k.clone()
    idx = word_ids.long()
    for l in range(L):
        wid = idx[:, l]
        cnt = counts[:, l, None]
        mu_old = mu[:, l]
        mask = masks[wid] * act[:, l, None]
        ex = cnt * mu_old * mask
        th = (theta - ex).clamp_min(0.0)
        ph = (phi[wid] - ex).clamp_min(0.0)
        pt = ptot[None, :] - ex
        num = (th + alpha_m1) * (ph + beta_m1) / (pt + wb) * mask
        prev_mass = (mu_old * mask).sum(-1, keepdim=True)
        new_sum = num.sum(-1, keepdim=True)
        if hook is not None:
            prev_mass, new_sum = hook(prev_mass, new_sum)
        mu_new = mask * (num / new_sum.clamp_min(1e-30) * prev_mass) + (
            1.0 - mask) * mu_old
        delta = cnt * (mu_new - mu_old)          # zero off the active set
        theta = theta + delta
        phi.index_put_((wid,), delta, accumulate=True)
        ptot = add_increment(ptot, delta.sum(0), phi_k64)
        mu_out[:, l] = mu_new
        res[:, l] = delta.abs()
    if not L:
        theta = theta.clone()
    loglik = None
    if emit_loglik:
        loglik = sweep_loglik(word_ids, counts, theta, phi, ptot, wb,
                              alpha_m1=alpha_m1, beta_m1=beta_m1)
    return mu_out, res, theta, phi, ptot, loglik


def sorted_runs(key: torch.Tensor,
                sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row of an (L, N) integer ``key`` sorted, stably, so the entries
    of one key form a run in index order; entries keyed ``sentinel`` (the
    largest key) sort last and belong to no run.  Returns two (L, N) int32
    tensors: ``order`` (the entry at each sorted position, -1 past the
    row's last keyed entry) and ``key`` (its key, ``sentinel`` past it).
    On the device, without a sync."""
    if sentinel < 2 ** 15:          # half the radix sort's passes
        key = key.to(torch.int16)
    # contiguous: a transposed or reshaped view would keep its strides
    key, order = torch.sort(key.contiguous(), dim=1, stable=True)
    order = torch.where(key < sentinel, order, -1)
    return (order.to(torch.int32).contiguous(),
            key.to(torch.int32).contiguous())


def note_pass(library: str, cell: Cell, mu_in: torch.Tensor,
              mu_out: torch.Tensor, res, loop: Optional[str]) -> None:
    """Note a streaming pass (the copy, and the residual's zeroing where
    ``res`` is given; 16-byte accesses where the bases are aligned) and,
    where named, the persistent ``loop`` behind it."""
    launches.note(library, "copy_kernel", cell,
                  offset=(mu_in.data_ptr() | mu_out.data_ptr()) % 16)
    if res is not None:
        launches.note(library, "zero_kernel", cell,
                      offset=res.data_ptr() % 16)
    if loop is not None:
        launches.note(library, loop, cell)


def fold_orders(word_ids: torch.Tensor, live: torch.Tensor, num_rows: int,
                word_topics: torch.Tensor,
                num_topics: int) -> Tuple[torch.Tensor, ...]:
    """The scheduled column loop's two visiting orders, built once per call
    on the device, without a sync (:func:`sorted_runs`):

    * the rows': each column's live documents by word id — (L, D) ``order``
      and ``key``, the documents of one word in document order;
    * φ̂(k)'s: each column's live (document, active slot) pairs by topic —
      pair (d, a) is entry d·A + a, its topic ``word_topics[word_ids[d, l],
      a]`` — (L, D·A) ``order`` and ``key``, the pairs of one topic in
      document order.

    Dead tokens (``live`` false) are keyed past the last row / topic.
    Returns ``(row_order, row_key, pair_order, pair_key)``."""
    D, L = word_ids.shape
    A = word_topics.shape[-1]
    rows = sorted_runs(torch.where(live, word_ids, num_rows).t(), num_rows)
    top = word_topics[word_ids.long()]                        # (D, L, A)
    key = torch.where(live[..., None], top, num_topics)
    pairs = sorted_runs(key.permute(1, 0, 2).reshape(L, D * A), num_topics)
    return rows + pairs


def _bind(lib) -> None:
    """The library's ctypes signatures, set once (``build.load``)."""
    fn = lib.scheduled_sweep_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p] * 11 + [i] + [p] * 8 + [i, i, i, f, f, f, f,
                                                ctypes.POINTER(i), p])
    fn.restype = ctypes.c_int
    lib.scheduled_pass_launch.argtypes = [p, p, p, ctypes.c_size_t, p]
    lib.scheduled_pass_launch.restype = ctypes.c_int
    lib.scheduled_sweep_error_string.argtypes = [ctypes.c_int]
    lib.scheduled_sweep_error_string.restype = ctypes.c_char_p


def _launcher():
    from repro_torch.kernels import build

    return build.load("scheduled_sweep", _bind)


def _raise_on(lib, rc: int) -> None:
    if rc != 0:
        msg = lib.scheduled_sweep_error_string(rc).decode()
        raise RuntimeError(
            f"scheduled_sweep kernel launch failed: {msg} ({rc})")


def scheduled_sweep(
    word_ids: torch.Tensor,      # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    mu: torch.Tensor,            # (D, L, K) float32
    theta: torch.Tensor,         # (D, K) float32
    phi_wk: torch.Tensor,        # (W_s, K) float32
    phi_k: torch.Tensor,         # (K,) float32
    word_topics: torch.Tensor,   # (W_s, A) int32 — active topic ids per word
    token_active: torch.Tensor,  # (D, L) bool — λ_w word mask per token
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                   # W·(β−1), with the *global* W
    emit_loglik: bool = False,
    phi_k64: Optional[torch.Tensor] = None,  # (K,) float64 total, in place
) -> SweepOut:
    """One scheduled sparse sweep.

    Returns ``(mu_new (D,L,K), residual (D,L,K), theta (D,K), phi_wk
    (W_s,K), phi_k (K,), loglik)`` — the outputs of
    ``scheduled_sweep_pallas``.  CUDA tensors run the kernel (on the current
    stream, not synchronised; every output is a new tensor); CPU tensors
    run :func:`scheduled_sweep_reference`.  Word ids must index rows of
    ``phi_wk`` and ``word_topics`` must index topics, with distinct ids in
    each row: the kernel does not check (``ops.sweep`` checks the ranges).
    ``phi_k64`` is :func:`gs_sweep.gs_sweep`'s: φ̂(k)'s float64 total, the
    fold's own increments added in place.
    """
    wb = float(wb)
    if theta.device.type == "cpu":
        return scheduled_sweep_reference(
            word_ids, counts, mu, theta, phi_wk, phi_k, word_topics,
            token_active, alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb,
            emit_loglik=emit_loglik, phi_k64=phi_k64,
        )
    if theta.device.type != "cuda":
        raise ValueError(
            f"scheduled_sweep runs on cuda or cpu, not {theta.device}")
    D, L = word_ids.shape
    K = mu.shape[-1]
    W_s = phi_wk.shape[0]
    A = word_topics.shape[-1] if word_topics.ndim == 2 else -1
    check_cuda_args("scheduled_sweep", dense_operands(
        word_ids, counts, mu, theta, phi_wk, phi_k) + [
        ("word_topics", word_topics, torch.int32, (W_s, A)),
        ("token_active", token_active, torch.bool, (D, L)),
    ] + total_operand(phi_k64, phi_k))
    if not 0 < A <= K:
        raise ValueError("scheduled_sweep: word_topics needs 1 <= A <= K")
    dev = theta.device
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    if D and L:
        # the pass first: the orders and copies below queue up behind it
        lib = _launcher()
        with torch.cuda.device(dev):
            rc = lib.scheduled_pass_launch(
                ptr(mu), ptr(mu_out), ptr(res), mu.numel(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc)
    theta_o, phi_o, ptot_o = theta.clone(), phi_wk.clone(), phi_k.clone()
    tok_ll = (torch.zeros((D, L), dtype=torch.float32, device=dev)
              if emit_loglik else None)
    if D and L:
        live = token_active & (counts != 0)
        orders = fold_orders(word_ids, live, W_s, word_topics, K)
        compact = torch.empty((D, A), dtype=torch.float32, device=dev)
        parts = torch.empty_like(compact)
        barrier = torch.empty((1,), dtype=torch.int32, device=dev)
        act8 = token_active.to(torch.uint8)
        enqueued = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.scheduled_sweep_launch(
                ptr(word_ids), ptr(counts), ptr(act8), ptr(mu), ptr(mu_out),
                ptr(res), ptr(theta_o), ptr(phi_o), ptr(ptot_o),
                ptr(phi_k64), ptr(word_topics), A, *map(ptr, orders),
                ptr(compact),
                ptr(parts), ptr(barrier), ptr(tok_ll), D, L, K,
                float(alpha_m1),
                float(beta_m1), wb, float(K * alpha_m1),
                ctypes.byref(enqueued),
                torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(lib, rc)
        if launches.enabled():
            note_pass("scheduled_sweep", Cell(D=D, L=L, K=K, W_s=W_s, A=A),
                      mu, mu_out, res, loop="active_loop_kernel")
            if emit_loglik:
                note_loglik("scheduled_sweep",
                            Cell(D=D, L=L, K=K, W_s=W_s, A=A), theta_o,
                            phi_o, ptot_o)
        count_launch(scheduled_sweep)
        scheduled_sweep.launches_per_call = 2 + enqueued.value  # + the pass
    loglik = tok_ll.sum() if emit_loglik else None
    return mu_out, res, theta_o, phi_o, ptot_o, loglik


scheduled_sweep.launches = 0
scheduled_sweep.launches_per_call = 0
