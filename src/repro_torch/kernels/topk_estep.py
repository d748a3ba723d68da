"""Scheduled active-set E-step (paper §3.1, eq. 38) — the Hopper kernels'
wrappers and their plain PyTorch versions.

One call of :func:`topk_estep` computes what one launch of the JAX package's
``kernels/topk_estep.py::topk_estep_pallas`` computes, on (T, A) slabs the
caller gathered at each token's A active topics: the eq. 13 self-excluded
numerators, zeroed on pad lanes, renormalised to the token's previous active
mass (eq. 38); tokens the λ_w mask leaves inactive keep μ_prev; and
delta = counts·(μ_new − μ_prev).

:func:`blocked_sweep` runs a whole blocked or ``"scan"`` scheduled sweep
(``foem.scheduled_iem_sweep`` with a coarse block count or
``sweep_impl="scan"``): per block of ⌈L/B⌉ columns that E-step on every
token, reading the pre-block statistics, then Δ folded into θ̂, the φ̂
rows and φ̂(k) before the next block.

The pad-lane rule is the TPU kernel's (``topk_estep.py:36-38``): a lane
with μ_prev ≤ 0 and θ̂ ≤ 0 gets a zero numerator.  ``ref.topk_estep_ref``
of the JAX package has no such rule; the two agree wherever no lane is a
pad lane.

* On CUDA tensors the wrappers run the hand-written kernels of
  ``csrc/topk_estep.cu``: the slab kernel (one warp per token) and the
  block loop (one persistent cooperative launch a sweep, folding Δ in the
  visiting orders of :func:`block_orders`).  They never fall back.
* On CPU tensors they run :func:`topk_estep_reference` and
  :func:`blocked_sweep_reference`, the plain versions.

``topk_estep.launches`` and ``blocked_sweep.launches`` count kernel
launches (plain integers; the block loop one a sweep);
``blocked_sweep.launches_per_call`` is the number of CUDA operations the
last call enqueued through the library: 3 (the μ copy, the barrier's
zeroing, the loop).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from repro_torch.kernels.gs_sweep import (
    check_cuda_args,
    ptr,
    scatter_add_pairs,
    scatter_add_rows,
)
from repro_torch.kernels.scheduled_sweep import sorted_runs

#: :func:`blocked_sweep`'s token flags (kActive, kSolo in
#: ``csrc/topk_estep.cu``).
ACTIVE, SOLO = 1, 2

BlockedOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor, torch.Tensor]


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


def block_width(L: int, num_blocks: int) -> Tuple[int, int]:
    """``(nb, blocks)``: the columns of a block, ⌈L/B⌉ with B clamped to
    [1, L], and the number of blocks, ⌈L/nb⌉ (the last one narrower)."""
    nb = -(-L // max(1, min(num_blocks, L))) if L else 1
    return nb, -(-L // nb)


def blocked_sweep_reference(
    word_ids: torch.Tensor,      # (D, L) int — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    word_topics: torch.Tensor,   # (W_s, A) int — active topic ids per word
    token_active: torch.Tensor,  # (D, L) bool — λ_w word mask per token
    mu: torch.Tensor,            # (D, L, K)
    theta: torch.Tensor,         # (D, K)
    phi_wk: torch.Tensor,        # (W_s, K)
    phi_k: torch.Tensor,         # (K,)
    *,
    num_blocks: int,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
    estep: Callable = topk_estep_reference,
) -> BlockedOut:
    """The plain PyTorch version of :func:`blocked_sweep`, any device: the
    blocked scan of the JAX package's ``core.foem.scheduled_iem_sweep``.

    The L columns go in blocks of ⌈L/B⌉ (the last one narrower where the
    JAX package pads with inert slots).  Per block, θ̂_a, φ̂_a, φ̂(k)_a and
    μ_prev,a are gathered at each token's (A,) active topics, ``estep``
    (the E-step's plain version) runs on the block's D·nb tokens, and its
    Δ folds into θ̂ over (doc, topic), into φ̂ over (word, topic) and into
    φ̂(k) over topic (``scatter_add_pairs``/``scatter_add_rows``: duplicate
    pairs add in a fixed order, never with atomics).  Returns ``(θ̂, φ̂,
    φ̂(k), μ, |Δ| (D, L, A), token_topics (D, L, A))``; no input is
    modified.  With ``estep=ops.topk_estep`` on CUDA tensors it is the sweep
    as the port ran it before the block loop (a yardstick only)."""
    D, L = word_ids.shape
    A = word_topics.shape[1]
    blk, _ = block_width(L, num_blocks)
    token_topics = word_topics[word_ids.long()]                # (D, L, A)
    theta, phi, ptot, mu = (
        x.clone(memory_format=torch.contiguous_format)
        for x in (theta, phi_wk, phi_k, mu))
    abs_delta = torch.empty((D, L, A), dtype=mu.dtype, device=mu.device)
    drows = torch.arange(D, device=mu.device)[:, None, None]
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb)
    for c0 in range(0, L, blk):
        c1 = min(c0 + blk, L)
        top = token_topics[:, c0:c1].long()                    # (D, nb, A)
        wid = word_ids[:, c0:c1].long()[..., None].expand_as(top)
        doc = drows.expand_as(top)
        mu_prev_a = mu[:, c0:c1].gather(-1, top)
        T = top.shape[0] * top.shape[1]
        mu_new_a, delta = estep(
            theta[doc, top].reshape(T, A), phi[wid, top].reshape(T, A),
            ptot[top].reshape(T, A), mu_prev_a.reshape(T, A),
            counts[:, c0:c1].reshape(T),
            token_active[:, c0:c1].reshape(T), **kw)
        delta = delta.reshape(top.shape)
        scatter_add_pairs(theta, doc, top, delta)
        scatter_add_pairs(phi, wid, top, delta)
        scatter_add_rows(ptot, top, delta.reshape(-1))
        mu[:, c0:c1].scatter_(-1, top, mu_new_a.reshape(top.shape))
        abs_delta[:, c0:c1] = delta.abs()
    return theta, phi, ptot, mu, abs_delta, token_topics


def block_orders(word_ids: torch.Tensor, live: torch.Tensor, num_rows: int,
                 word_topics: torch.Tensor, num_topics: int,
                 num_blocks: int) -> Tuple[torch.Tensor, ...]:
    """The block loop's plan of one call, on the device, without a sync:
    ``scheduled_sweep.fold_orders`` from (L, D) columns to blocks of nb =
    ⌈L/B⌉ columns, the entries of block b the D·nb tokens (d, c0 + c),
    entry d·nb + c (the last block's entries past L are dead).

    * ``solo``, (D, L) bool: a live token whose word no other token of its
      block has, dead or live — the kernel folds its Δ into its φ̂ row in
      the E-step, since no other token of the block reads that row;
    * the rows' order: each block's other live entries by word id —
      (blocks, D·nb) ``order`` and ``key``, the entries of one word in
      (d, c) order — and its word runs, compacted to the front of each
      block and -1 past its last: ``run_pos`` and ``run_end``, a run's
      first and one-past-last sorted position;
    * φ̂(k)'s: each block's live (entry, active slot) pairs by topic — pair
      (e, a) is e·A + a, its topic ``word_topics[word_ids[d, c0 + c], a]``
      — (blocks, D·nb·A) ``order`` and ``key``.

    Returns ``(solo, row_order, row_key, run_pos, run_end, pair_order,
    pair_key)``."""
    D, L = word_ids.shape
    A = word_topics.shape[-1]
    nb, blocks = block_width(L, num_blocks)
    pad = blocks * nb - L

    def by_block(x, fill):                 # (D, L) -> (blocks, D·nb)
        x = torch.cat([x, x.new_full((D, pad), fill)], 1) if pad else x
        return x.reshape(D, blocks, nb).transpose(0, 1).reshape(blocks,
                                                                D * nb)

    wid = by_block(word_ids.long(), num_rows)      # pads: a spare row id
    lv = by_block(live, False)
    seen = torch.zeros((blocks, num_rows + 1), dtype=torch.int32,
                       device=wid.device)
    seen.scatter_add_(1, wid, torch.ones_like(wid, dtype=torch.int32))
    solo = lv & (seen.gather(1, wid) == 1)
    row_order, row_key = sorted_runs(torch.where(lv & ~solo, wid, num_rows),
                                     num_rows)
    run_pos, run_end = _runs(row_order, row_key)
    top = word_topics[wid.clamp_max(num_rows - 1)]      # (blocks, D·nb, A)
    key = torch.where(lv[..., None], top.long(), num_topics)
    pairs = sorted_runs(key.reshape(blocks, D * nb * A), num_topics)
    solo = solo.reshape(blocks, D, nb).transpose(0, 1).reshape(D, -1)[:, :L]
    return (solo.contiguous(), row_order, row_key, run_pos,
            run_end) + pairs


def _runs(order: torch.Tensor,
          key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The runs of equal keys in each row of a :func:`sorted_runs` order
    (its entries -1 past the keyed ones), compacted to the front of the
    row, -1 past its last run: each run's first and one-past-last
    position, (blocks, N) int32 each."""
    blocks, n = order.shape
    keyed = order >= 0
    start = keyed.clone()
    start[:, 1:] &= key[:, 1:] != key[:, :-1]
    pos = torch.arange(n, device=order.device).expand(blocks, n)
    slot = torch.where(start, torch.cumsum(start, 1) - 1, n)
    run_pos = torch.full((blocks, n + 1), -1, dtype=torch.long,
                         device=order.device).scatter_(1, slot, pos)[:, :n]
    run_end = torch.full_like(run_pos, -1)
    run_end[:, :-1] = run_pos[:, 1:]
    last = (run_pos >= 0) & (run_end < 0)
    run_end = torch.where(last, keyed.sum(1, keepdim=True), run_end)
    return (run_pos.to(torch.int32).contiguous(),
            run_end.to(torch.int32).contiguous())


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
        lib.topk_loop_pass_launch.argtypes = [p, p, ctypes.c_size_t, p]
        lib.topk_loop_pass_launch.restype = ctypes.c_int
        i = ctypes.c_int
        lib.topk_loop_launch.argtypes = ([p] * 20 + [i] * 6 + [f] * 3
                                         + [ctypes.POINTER(i), p])
        lib.topk_loop_launch.restype = ctypes.c_int
    return lib


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.topk_estep_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


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
        _raise_on(lib, rc, "topk_estep")
        topk_estep.launches += 1
    return mu, delta


topk_estep.launches = 0


def blocked_sweep(
    word_ids: torch.Tensor,      # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,        # (D, L) float32
    word_topics: torch.Tensor,   # (W_s, A) int32 — active topic ids per word
    token_active: torch.Tensor,  # (D, L) bool — λ_w word mask per token
    mu: torch.Tensor,            # (D, L, K) float32
    theta: torch.Tensor,         # (D, K) float32
    phi_wk: torch.Tensor,        # (W_s, K) float32
    phi_k: torch.Tensor,         # (K,) float32
    *,
    num_blocks: int,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                   # W·(β−1), with the *global* W
) -> BlockedOut:
    """One blocked (or, at ``num_blocks`` = L, ``"scan"``) scheduled sweep.

    Returns ``(θ̂ (D,K), φ̂ (W_s,K), φ̂(k) (K,), μ (D,L,K), |Δ| (D,L,A),
    token_topics (D,L,A) int32)``; every output is a new tensor and no
    input is modified.  CUDA tensors run the block loop (on the current
    stream, not synchronised); CPU tensors run
    :func:`blocked_sweep_reference`.  Word ids must index rows of
    ``phi_wk`` and ``word_topics`` must index topics, with distinct ids in
    each row: the kernel does not check.
    """
    kw = dict(num_blocks=num_blocks, alpha_m1=alpha_m1, beta_m1=beta_m1,
              wb=float(wb))
    if theta.device.type == "cpu":
        return blocked_sweep_reference(word_ids, counts, word_topics,
                                       token_active, mu, theta, phi_wk,
                                       phi_k, **kw)
    if theta.device.type != "cuda":
        raise ValueError(
            f"blocked_sweep runs on cuda or cpu, not {theta.device}")
    D, L = word_ids.shape
    K = mu.shape[-1]
    W_s = phi_wk.shape[0]
    A = word_topics.shape[-1] if word_topics.ndim == 2 else -1
    f32 = torch.float32
    check_cuda_args("blocked_sweep", [
        ("word_ids", word_ids, torch.int32, (D, L)),
        ("counts", counts, f32, (D, L)),
        ("word_topics", word_topics, torch.int32, (W_s, A)),
        ("token_active", token_active, torch.bool, (D, L)),
        ("mu", mu, f32, (D, L, K)),
        ("theta", theta, f32, (D, K)),
        ("phi_wk", phi_wk, f32, (W_s, K)),
        ("phi_k", phi_k, f32, (K,)),
    ])
    if not 0 < A <= K:
        raise ValueError("blocked_sweep: word_topics needs 1 <= A <= K")
    nb, blocks = block_width(L, num_blocks)
    if 2 * D * nb * A >= 2 ** 31:
        raise ValueError(f"blocked_sweep: 2·D·nb·A = {2 * D * nb * A} "
                         f"overflows the kernel's int32 fold items")
    dev = theta.device
    mu_out = torch.empty_like(mu)
    abs_delta = torch.empty((D, L, A), dtype=f32, device=dev)
    token_topics = torch.empty((D, L, A), dtype=torch.int32, device=dev)
    lib = _launcher() if D and L else None
    if lib is not None:
        # the copy first: the orders and clones below queue up behind it
        with torch.cuda.device(dev):
            rc = lib.topk_loop_pass_launch(
                ptr(mu), ptr(mu_out), mu.numel(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc, "blocked_sweep")
    theta_o, phi_o, ptot_o = theta.clone(), phi_wk.clone(), phi_k.clone()
    if lib is not None:
        live = token_active & (counts != 0)
        solo, *orders = block_orders(word_ids, live, W_s, word_topics, K,
                                     num_blocks)
        flags = (token_active.to(torch.uint8) * ACTIVE
                 + solo.to(torch.uint8) * SOLO)
        compact = torch.empty((D * nb * A,), dtype=f32, device=dev)
        parts = torch.empty_like(compact)
        barrier = torch.empty((1,), dtype=torch.int32, device=dev)
        enqueued = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.topk_loop_launch(
                ptr(word_ids), ptr(counts), ptr(flags), ptr(mu),
                ptr(mu_out), ptr(abs_delta), ptr(token_topics),
                ptr(theta_o), ptr(phi_o), ptr(ptot_o), ptr(word_topics),
                *map(ptr, orders), ptr(compact), ptr(parts), ptr(barrier),
                D, L, K, A, nb, blocks, float(alpha_m1), float(beta_m1),
                float(wb), ctypes.byref(enqueued),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc, "blocked_sweep")
        blocked_sweep.launches += 1
        blocked_sweep.launches_per_call = 1 + enqueued.value  # + the copy
    return theta_o, phi_o, ptot_o, mu_out, abs_delta, token_topics


blocked_sweep.launches = 0
blocked_sweep.launches_per_call = 0
