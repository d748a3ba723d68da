"""FOEM — Fast Online EM for LDA (paper Fig. 4), PyTorch port of
``repro.core.foem``.

FOEM = SEM's minibatch stream (outer loop) with the inner batch-EM replaced
by the *time-efficient IEM*: column-serial incremental sweeps restricted,
after the warm-up sweeps, to the top-``λ_k K`` topics per vocabulary word
and the top-``λ_w W_s`` words, ranked by responsibility residuals (dynamic
scheduling, §3.1), with the eq. 38 partial renormalisation.  Global
topic-word statistics accumulate with the implicit 1/s learning rate (eq.
33, ``rho_mode="accumulate"``) or the stepwise interpolation (eq. 20,
``rho_mode="stepwise"``).

At B = L with ``sweep_impl="fused"`` (the default) every sweep goes
through ``kernels.ops.sweep``: the dense and scheduled Hopper sweep kernels
on the card, their plain versions on the CPU.  A coarse block count
(``cfg.iem_blocks``) or ``sweep_impl="scan"`` runs the blocked scans: the
dense one over ``em.estep`` (the fused E-step kernel), the scheduled one
through ``kernels.topk_estep.blocked_sweep`` (one persistent block-loop
launch a sweep on the card), and a standalone ``em.training_perplexity``
on check sweeps.
A topic-sharded plan always takes the dispatch
(``core/foem_sharded.py``).  The inner loop is a Python loop that
synchronises with the device once per check sweep (one scalar) and nowhere
else.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import em
from repro_torch.core import scheduling as sched_lib
from repro_torch.core.types import (
    GlobalStats,
    LDAConfig,
    LocalState,
    MinibatchData,
    SchedulerState,
    SweepPlan,
    uniform_responsibilities,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.topk_estep import blocked_sweep
from repro_torch.runtime.device import Device, resolve_device


class FOEMDiagnostics(NamedTuple):
    sweeps_run: int                 # inner sweeps actually executed
    final_train_ppl: torch.Tensor   # () float32
    residual_mass: torch.Tensor     # () float32 — Σ r_w at exit


class FOEMMinibatchResult(NamedTuple):
    local: LocalState
    phi_wk: torch.Tensor            # working copy WITH this minibatch folded in
    phi_k: torch.Tensor
    scheduler: SchedulerState
    diag: FOEMDiagnostics


# ---------------------------------------------------------------------------
# Scheduled (sparse) IEM sweep
# ---------------------------------------------------------------------------

def scheduled_iem_sweep(
    batch: MinibatchData,
    local: LocalState,
    phi_wk: torch.Tensor,           # (Wv, K) working stats (minibatch folded in)
    phi_k: torch.Tensor,            # (K,)
    scheduler: SchedulerState,
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
    compute_loglik: bool = False,
    plan: Optional[SweepPlan] = None,
    check_indices: bool = True,
) -> Tuple[LocalState, torch.Tensor, torch.Tensor, SchedulerState,
           Optional[torch.Tensor]]:
    """One dynamic-scheduling sweep: update only active (word, topic) entries.

    Selects each word's top-A topics by residual and the λ_w active words,
    then, on the device the tensors lie on:

    * B = L with ``sweep_impl="fused"``: one ``kernels.ops.sweep`` call,
      and the scheduler refresh from its eq. 36 replacement residuals.
      ``check_indices`` is passed to ``ops.sweep``; the active sets come
      from a sort and are in range by construction.
    * a coarse block count or ``sweep_impl="scan"``: the blocked scan,
      ``kernels.topk_estep.blocked_sweep`` (the block loop on the card, its
      plain version on the CPU), then ``scatter_residuals``/
      ``update_residuals`` and, with ``compute_loglik``,
      ``em.map_log_likelihood``.

    Under a topic-sharded ``plan`` (``foem_sharded``: the rank's K/mp
    lanes, ``cfg.topk_shards == mp``) the selection runs on the rank's
    *local* residual slice — top-(A/mp) local ids, whose union over the
    ranks is the balanced size-A active set — with λ_w < 1 ranking words by
    the eq. 37 residual summed over the model axis (one ``all_reduce``), so
    that every rank derives the same word mask; the sweep then always takes
    the dispatch, whatever the block count.

    Returns ``(local, phi, ptot, scheduler, loglik-or-None)``.
    """
    A = cfg.active_topics
    if A <= 0:
        raise ValueError("scheduled_iem_sweep requires cfg.active_topics > 0")
    sharded = plan is not None and plan.axis_name is not None
    W = vocab_size if vocab_size is not None else cfg.W
    if sharded:
        # scheduler.r_wk is the (W, K/mp) local slice: a plain local
        # top-(A/mp) IS the rank's group of the grouped selection
        word_topics = sched_lib.select_active_topics(
            scheduler.r_wk, max(1, A // max(1, cfg.topk_shards)))  # (Wv, A/mp)
    else:
        word_topics = sched_lib.select_active_topics(
            scheduler.r_wk, A, cfg.topk_shards)                    # (Wv, A)
    r_w = scheduler.r_w
    if sharded and cfg.active_words_frac < 1.0:
        # the λ_w ranking needs the GLOBAL eq. 37 residual: a rank-local
        # threshold would freeze a word on one rank and not another
        (r_w,) = plan.axis_name.all_reduce(r_w)
    word_thresh = sched_lib.select_active_words_threshold(
        SchedulerState(r_wk=scheduler.r_wk, r_w=r_w), cfg.active_words_frac)
    token_active = (
        r_w[batch.word_ids.long()] >= word_thresh
    ) & (batch.counts > 0)                                         # (D, L)
    L = batch.word_ids.shape[1]
    B = cfg.resolve_blocks(L)
    if not sharded and (B < L or cfg.sweep_impl != "fused"):
        theta, phi, ptot, mu, abs_delta, token_topics = blocked_sweep(
            *(x.contiguous() for x in (
                batch.word_ids, batch.counts, word_topics, token_active,
                local.mu, local.theta_dk, phi_wk, phi_k)),
            num_blocks=B, alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1,
            wb=W * cfg.beta_m1)
        # residual refresh (replace touched, keep the rest) — §3.1
        r_new, touched = sched_lib.scatter_residuals(
            abs_delta, batch.word_ids, token_topics, phi_wk.shape[0], cfg.K)
        scheduler = sched_lib.update_residuals(scheduler, r_new, touched)
        del r_new, touched
        loglik = None
        if compute_loglik:
            loglik = em.map_log_likelihood(batch, theta, phi, ptot, cfg,
                                           vocab_size=W)
        return LocalState(mu=mu, theta_dk=theta), phi, ptot, scheduler, loglik
    r = kops.sweep(
        batch.word_ids, batch.counts, local.mu, local.theta_dk,
        phi_wk, phi_k,
        alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1, wb=W * cfg.beta_m1,
        word_topics=word_topics, token_active=token_active,
        compute_loglik=compute_loglik, plan=plan,
        check_indices=check_indices, debug_checks=cfg.debug_checks,
        device=local.mu.device,
    )
    scheduler = sched_lib.scheduler_update_from_sweep(
        scheduler, r.residual, batch.word_ids, word_topics
    )
    return (LocalState(mu=r.mu, theta_dk=r.theta), r.phi_wk, r.phi_k,
            scheduler, r.loglik)


# ---------------------------------------------------------------------------
# Per-minibatch FOEM inner loop
# ---------------------------------------------------------------------------

def foem_minibatch(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    phi_wk_in,                      # (Wv, K) global stats view (minibatch NOT folded)
    phi_k_in,                       # (K,)    global topic totals
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
    mu0=None,                       # (D, L, K) initial μ; drawn when None
    device: Device = "cuda",
) -> FOEMMinibatchResult:
    """Run FOEM's inner loop on one minibatch (paper Fig. 4 lines 2-18).

    1. init μ (``mu0``, else drawn from ``generator``), θ̂; fold the
       minibatch's initial contribution into the working φ̂;
    2. ``max(1, warmup_sweeps)`` dense sweeps; the last initialises the
       residual matrices and gives the baseline perplexity;
    3. scheduled sweeps (dense ones when ``active_topics == 0``) until the
       training perplexity, checked on every ``ppl_check_every``-th sweep,
       moves by less than ``ppl_rel_tol`` relative, or ``max_sweeps``.

    At B = L with ``sweep_impl="fused"`` the sweeps are ``ops.sweep`` calls
    whose residuals and stop-rule loglik come out of the sweep itself.  A
    coarse block count or ``sweep_impl="scan"`` runs the blocked scans
    (``em.iem_sweep``, the blocked ``scheduled_iem_sweep``), initialises the
    residuals post hoc (``full_sweep_residuals``) and measures the
    perplexity with a standalone ``em.training_perplexity`` — as the JAX
    package does.

    Inputs may be numpy arrays or tensors; they move to ``device`` (default
    ``"cuda"``, which raises without a GPU).  ``vocab_size`` is the global
    W of the smoothing mass.  The word ids are range-checked once, here;
    the loop then synchronises with the device only for the stop rule's
    scalar on check sweeps.
    """
    dev = resolve_device(device)
    batch = MinibatchData(
        torch.as_tensor(batch.word_ids).to(device=dev, dtype=torch.int32),
        torch.as_tensor(batch.counts).to(device=dev, dtype=cfg.dtype),
    )
    phi_wk_in = torch.as_tensor(phi_wk_in).to(device=dev, dtype=cfg.dtype)
    phi_k_in = torch.as_tensor(phi_k_in).to(device=dev, dtype=cfg.dtype)
    D, L = batch.word_ids.shape
    K = cfg.K
    W = vocab_size if vocab_size is not None else cfg.W
    Wv = phi_wk_in.shape[0]
    kops.check_index_ranges(batch.word_ids, None, Wv, K)

    if mu0 is None:
        if generator is None:
            raise ValueError("foem_minibatch needs a generator or mu0")
        mu0 = uniform_responsibilities(generator, (D, L, K), cfg.dtype)
    mu0 = torch.as_tensor(mu0).to(device=dev, dtype=cfg.dtype).contiguous()
    theta0 = em.fold_theta(mu0, batch.counts)
    d_wk, d_k = em.fold_phi(mu0, batch.counts, batch.word_ids, Wv)
    phi = phi_wk_in + d_wk      # working copy: global + this minibatch
    ptot = phi_k_in + d_k
    local = LocalState(mu=mu0, theta_dk=theta0)
    ntok = batch.counts.sum().clamp_min(1.0)
    use_sched = cfg.active_topics > 0
    use_fused = cfg.sweep_impl == "fused" and cfg.resolve_blocks(L) == L
    kw = dict(vocab_size=W, check_indices=False)

    def train_ppl(local, phi, ptot):
        return em.training_perplexity(batch, local.theta_dk, phi, ptot, cfg,
                                      vocab_size=W)

    # ---- warm-up full sweeps (Fig. 4's unscheduled first iteration); the
    # last initialises the residual matrices and the stop rule's baseline
    warm = max(1, cfg.warmup_sweeps)
    if use_fused:
        r = None
        for i in range(warm):
            r = em.gs_sweep_with_residuals(
                batch, local, phi, ptot, cfg,
                compute_loglik=(i == warm - 1), **kw)
            local = LocalState(mu=r.mu, theta_dk=r.theta)
            phi, ptot = r.phi_wk, r.phi_k
        scheduler = sched_lib.residuals_from_sweep(r.residual,
                                                   batch.word_ids, Wv)
        last_ppl = torch.exp(-r.loglik / ntok)
        del r
    else:
        for _ in range(warm):
            prev_mu = local.mu
            local, phi, ptot = em.iem_sweep(batch, local, phi, ptot, cfg,
                                            vocab_size=W)
        scheduler = sched_lib.full_sweep_residuals(
            local.mu, prev_mu, batch.counts, batch.word_ids, Wv)
        del prev_mu
        last_ppl = train_ppl(local, phi, ptot)

    t = warm
    while t < cfg.max_sweeps:
        check = (t + 1) % cfg.ppl_check_every == 0
        ll = None
        if use_sched:
            local, phi, ptot, scheduler, ll = scheduled_iem_sweep(
                batch, local, phi, ptot, scheduler, cfg,
                compute_loglik=check and use_fused, **kw)
        elif use_fused:
            r = em.gs_sweep_with_residuals(
                batch, local, phi, ptot, cfg, compute_loglik=check, **kw)
            local = LocalState(mu=r.mu, theta_dk=r.theta)
            phi, ptot, ll = r.phi_wk, r.phi_k, r.loglik
            del r
        else:
            local, phi, ptot = em.iem_sweep(batch, local, phi, ptot, cfg,
                                            vocab_size=W)
        t += 1
        if check:
            ppl = (torch.exp(-ll / ntok) if use_fused
                   else train_ppl(local, phi, ptot))
            done = bool(torch.abs(last_ppl - ppl)
                        < cfg.ppl_rel_tol * torch.abs(ppl))
            last_ppl = ppl
            if done:
                break
    diag = FOEMDiagnostics(sweeps_run=t, final_train_ppl=last_ppl,
                           residual_mass=scheduler.r_w.sum())
    return FOEMMinibatchResult(local, phi, ptot, scheduler, diag)


# ---------------------------------------------------------------------------
# Stream-level merge (eq. 33 accumulate / eq. 20 stepwise)
# ---------------------------------------------------------------------------

def merge_minibatch(
    stats: GlobalStats,
    result_phi_wk: torch.Tensor,
    result_phi_k: torch.Tensor,
    minibatch_phi_wk: torch.Tensor,   # Σ_d x μ of this minibatch alone
    minibatch_phi_k: torch.Tensor,
    cfg: LDAConfig,
    stream_scale: float = 1.0,        # S = D/D_s for stepwise mode
) -> GlobalStats:
    """Fold a finished minibatch into the stream-lifetime statistics."""
    s = stats.step + 1
    if cfg.rho_mode == "accumulate":
        # eq. 33 with ρ_s = 1/s: plain accumulation of sufficient statistics
        return GlobalStats(phi_wk=result_phi_wk, phi_k=result_phi_k, step=s)
    rho = (cfg.tau0 + s.to(torch.float32)) ** (-cfg.kappa)      # eq. 18
    phi_wk = (1.0 - rho) * stats.phi_wk + rho * stream_scale * minibatch_phi_wk
    phi_k = (1.0 - rho) * stats.phi_k + rho * stream_scale * minibatch_phi_k
    return GlobalStats(phi_wk=phi_wk, phi_k=phi_k, step=s)


def foem_step(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    stats: GlobalStats,
    cfg: LDAConfig,
    stream_scale: float = 1.0,
    *,
    mu0=None,
    device: Device = "cuda",
) -> Tuple[GlobalStats, LocalState, FOEMDiagnostics]:
    """Whole-vocabulary FOEM step (φ̂ device-resident): one minibatch, then
    the eq. 33 / eq. 20 merge."""
    dev = resolve_device(device)
    stats = GlobalStats(*(torch.as_tensor(x).to(dev) for x in stats))
    res = foem_minibatch(generator, batch, stats.phi_wk, stats.phi_k, cfg,
                         mu0=mu0, device=dev)
    mb_wk = res.phi_wk - stats.phi_wk
    mb_k = res.phi_k - stats.phi_k
    new_stats = merge_minibatch(
        stats, res.phi_wk, res.phi_k, mb_wk, mb_k, cfg, stream_scale
    )
    return new_stats, res.local, res.diag
