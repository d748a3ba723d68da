"""Topic-sharded FOEM — the port of ``repro.core.foem_sharded``.

The JAX package runs this step as one program over a ``(data, model)``
device mesh (``shard_map``); the port runs it SPMD over a
``launch.mesh.Mesh`` of ranks, one process each, and every function here is
called by every rank with its own pieces:

* topics are split over ``model``: a rank owns φ̂ (W, K/mp) and φ̂(k)
  (K/mp,) — its slice of the model — and μ (D/dp, L, K/mp), and runs the
  paper's algorithm on its lanes;
* documents are split over ``data``: a rank passes its own document rows;
* dynamic scheduling selects the top-(A/mp) topics per word within the
  rank's lanes (``foem.scheduled_iem_sweep``);
* what crosses ranks is ``all_reduce``s only: the (D, L) E-step normalisers
  and eq. 38 masses (two per sweep, inside ``ops.sweep``'s two-phase
  engine; one (D, 1) reduction a column in the hooks mode), the pre-log
  stop-rule partials on check sweeps, and the φ̂ delta over ``data`` at
  ``cfg.dp_fold`` cadence (skipped when the data axis has one rank).

Every sweep goes through ``kernels.ops.sweep`` under a ``SweepPlan`` naming
the model axis, and ``cfg.sharded_impl`` picks the engine:

* ``"two_phase"`` (default): the probe and fold Hopper kernels on the card,
  their plain versions on the CPU;
* ``"hooks"``: the per-column hooks mode, kept as the reference semantics
  (as in the JAX package): the plain column loops, on every device, with
  L small reductions a sweep.

The random initial state of a rank is drawn from a generator derived from
the caller's and the rank's model index, so ranks that share a model index
draw the same values (``jax.random.fold_in(key, axis_index)``); the tests
inject the JAX package's μ₀ instead.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import em, foem
from repro_torch.core import scheduling as sched_lib
from repro_torch.core.types import (
    GlobalStats,
    InferPlan,
    LDAConfig,
    LocalState,
    MinibatchData,
    SweepPlan,
)
from repro_torch.kernels import ops as kops
from repro_torch.runtime import faults as fault_lib


def shard_stats(stats: GlobalStats, model: int, index: int) -> GlobalStats:
    """Rank ``index``'s slice of ``stats`` along a model axis of ``model``
    ranks: the contiguous topic lanes [index·K/mp, (index+1)·K/mp)."""
    K = stats.phi_k.shape[0]
    if K % model:
        raise ValueError(f"K = {K} does not split over {model} ranks")
    lo, hi = index * K // model, (index + 1) * K // model
    return GlobalStats(phi_wk=stats.phi_wk[:, lo:hi].contiguous(),
                       phi_k=stats.phi_k[lo:hi].contiguous(),
                       step=stats.step)


def unshard_stats(slices: Sequence[GlobalStats]) -> GlobalStats:
    """The whole ``GlobalStats`` from its model-axis slices, in index
    order (the inverse of :func:`shard_stats`)."""
    return GlobalStats(phi_wk=torch.cat([s.phi_wk for s in slices], 1),
                       phi_k=torch.cat([s.phi_k for s in slices]),
                       step=slices[0].step)


def _fold_in(generator: torch.Generator, index: int,
             device: torch.device) -> torch.Generator:
    """A generator on ``device`` for mesh index ``index``: one draw from
    ``generator`` (advancing it) combined with ``index`` — the counterpart
    of ``jax.random.fold_in``.  Equal generators and indices give equal
    streams."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    mixed = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0] >> 1))


def _draw_slice(generator, shape, mesh) -> torch.Tensor:
    """The rank's (D, L, K/mp) slice of U(0.5, 1.5) draws normalised over
    all K lanes (one ``all_reduce`` over the model axis)."""
    if generator is None:
        raise ValueError("the sharded step needs a generator or an injected "
                         "initial state (mu0 / theta0)")
    g = torch.empty(shape, dtype=torch.float32, device=mesh.device)
    g.uniform_(0.5, 1.5,
               generator=_fold_in(generator, mesh.model.index, mesh.device))
    (gs,) = mesh.model.all_reduce(g.sum(-1, keepdim=True))
    return g / gs


def _local_training_ppl(batch: MinibatchData, theta, phi, ptot,
                        cfg: LDAConfig, mesh) -> torch.Tensor:
    """Global training perplexity from the ranks' pieces: the standalone
    (D, L, K/mp) pass (the stop rule does not use it; check sweeps emit
    their loglik from inside the sweep), kept as the reference value for
    tests and diagnostics."""
    (th_den,) = mesh.model.all_reduce(theta.sum(-1, keepdim=True))
    theta_n = (theta + cfg.alpha_m1) / (th_den + cfg.K * cfg.alpha_m1
                                        ).clamp_min(1e-30)
    phi_n = (phi + cfg.beta_m1) / (ptot + cfg.W * cfg.beta_m1
                                   ).clamp_min(1e-30)[None, :]
    rows = phi_n[batch.word_ids.long()]
    (lik,) = mesh.model.all_reduce(torch.einsum("dlk,dk->dl", rows, theta_n))
    ll = (batch.counts * torch.log(lik.clamp_min(1e-30))).sum()
    ll, ntok = mesh.data.all_reduce(ll.reshape(1), batch.counts.sum().reshape(1))
    return torch.exp(-ll / ntok.clamp_min(1.0))[0]


def _foem_local(generator, batch: MinibatchData, phi_in, ptot_in,
                cfg: LDAConfig, mesh, mu0) -> Tuple[torch.Tensor,
                                                     torch.Tensor, float,
                                                     int]:
    """The rank's FOEM inner loop; returns its updated φ̂ slice, the global
    training perplexity and the sweeps run."""
    D, L = batch.word_ids.shape
    W_rows = phi_in.shape[0]
    data = mesh.data
    plan = SweepPlan(axis_name=mesh.model,
                     two_phase=cfg.sharded_impl == "two_phase")
    if mu0 is None:
        mu0 = _draw_slice(generator, (D, L, phi_in.shape[1]), mesh)
    mu0 = torch.as_tensor(mu0).to(device=mesh.device,
                                  dtype=torch.float32).contiguous()
    theta0 = em.fold_theta(mu0, batch.counts)
    d_wk, d_k = em.fold_phi(mu0, batch.counts, batch.word_ids, W_rows)
    # documents are split over data: the φ̂ fold needs every rank's part
    d_wk, d_k = data.all_reduce(d_wk, d_k)
    phi = phi_in + d_wk
    ptot = ptot_in + d_k
    del d_wk
    local = LocalState(mu=mu0, theta_dk=theta0)
    (ntok,) = data.all_reduce(batch.counts.sum().reshape(1))
    ntok = ntok.clamp_min(1.0)[0]
    kw = dict(plan=plan, check_indices=False)

    def dp_fold(phi, ptot, phi_before):
        """Apply every data rank's Δφ̂ (own included) with one all_reduce —
        keep the locally folded φ̂ and add the peers' deltas."""
        if data.size == 1:
            return phi, ptot
        own = phi - phi_before
        (tot,) = data.all_reduce(own)
        d = tot - own
        return phi + d, ptot + d.sum(0)

    def global_ppl(ll) -> torch.Tensor:
        (ll,) = data.all_reduce(ll.reshape(1))
        return torch.exp(-ll / ntok)[0]

    # ---- warm-up full sweeps: the last one's residuals seed the scheduler
    # and its in-sweep loglik the stop rule's baseline
    warm = max(1, cfg.warmup_sweeps)
    for i in range(warm):
        phi_before = phi if data.size > 1 else None
        r = em.gs_sweep_with_residuals(batch, local, phi, ptot, cfg,
                                       compute_loglik=(i == warm - 1), **kw)
        local = LocalState(mu=r.mu, theta_dk=r.theta)
        phi, ptot = dp_fold(r.phi_wk, r.phi_k, phi_before)
        residual, ll = r.residual, r.loglik
        del r
    scheduler = sched_lib.residuals_from_sweep(residual, batch.word_ids,
                                               W_rows)
    del residual
    last_ppl = global_ppl(ll)

    phi_warm = phi if cfg.dp_fold == "minibatch" else None
    t = warm
    while t < cfg.max_sweeps:
        phi_before = phi if (data.size > 1 and cfg.dp_fold == "sweep") \
            else None
        check = (t + 1) % cfg.ppl_check_every == 0
        local, phi, ptot, scheduler, ll = foem.scheduled_iem_sweep(
            batch, local, phi, ptot, scheduler, cfg, compute_loglik=check,
            **kw)
        if phi_before is not None:
            # per-sweep data-axis fold (bounded staleness across data ranks)
            phi, ptot = dp_fold(phi, ptot, phi_before)
        t += 1
        if check:
            ppl = global_ppl(ll)
            # the same bits on every rank, so every rank stops together
            done = bool(torch.abs(last_ppl - ppl)
                        < cfg.ppl_rel_tol * torch.abs(ppl))
            last_ppl = ppl
            if done:
                break
    if phi_warm is not None:
        # one end-of-minibatch fold of every data rank's Δφ̂
        phi, ptot = dp_fold(phi, ptot, phi_warm)
    return phi, ptot, float(last_ppl), t


def foem_step_sharded(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    stats: GlobalStats,
    cfg: LDAConfig,
    mesh,
    *,
    mu0=None,
    faults: Optional[fault_lib.FaultPlan] = None,
) -> Tuple[GlobalStats, float, int]:
    """One topic-sharded FOEM step on this rank (SPMD: every rank of
    ``mesh`` calls it).

    ``batch`` is this rank's document rows; ``stats`` its model-axis slice
    (``shard_stats``): φ̂ (W, K/mp), φ̂(k) (K/mp,) and the step counter.
    Returns ``(new_stats, train_ppl, sweeps)``: the updated slice, the
    global training perplexity of the minibatch (the same on every rank)
    and the inner sweeps run.  ``mu0`` injects the rank's (D, L, K/mp)
    initial responsibilities (normalised over all K lanes); without it they
    are drawn from ``generator`` folded with the model index.
    ``cfg.topk_shards`` must equal the model axis size, which must divide K
    and ``cfg.active_topics`` (else ``ValueError``).  ``cfg.sharded_impl``
    picks the sweep: ``"two_phase"`` (default) the two-phase engine,
    ``"hooks"`` the per-column hooks mode — the JAX package's reference
    semantics, the plain column loops with one ``all_reduce`` a column, on
    the card too (no sweep kernel: a collective cannot cross a kernel
    boundary).  ``cfg.debug_checks`` runs the sanitizer on every
    sweep and on the held-out fit, its masses summed over the model axis.

    ``faults`` (or the process-wide active plan) fires ``PRE_PROBE`` once
    per model shard, on every rank, before the step: a ``kill`` raises
    ``InjectedFault`` carrying the shard, a ``delay`` sleeps, a ``drop``
    discards the step (stats come back unchanged with ``nan`` and 0
    sweeps).  The inner sweeps then run with no active plan, as the JAX
    package's traced sweeps see none.
    """
    mp = mesh.model.size
    if cfg.topk_shards != mp or cfg.K % mp or cfg.active_topics % mp:
        raise ValueError(
            f"a topic-sharded step over {mp} model ranks needs "
            f"cfg.topk_shards == {mp} (got {cfg.topk_shards}) and K "
            f"({cfg.K}) and active_topics ({cfg.active_topics}) divisible "
            f"by {mp}")
    plan_ = faults if faults is not None else fault_lib.get_active()
    if plan_ is not None:
        step_now = int(stats.step)
        dropped = False
        for s in range(mp):
            dropped |= plan_.fire(fault_lib.PRE_PROBE, shard=s,
                                  step=step_now)
        if dropped:
            return stats, float("nan"), 0

    dev = mesh.device
    batch = MinibatchData(
        torch.as_tensor(batch.word_ids).to(device=dev, dtype=torch.int32),
        torch.as_tensor(batch.counts).to(device=dev, dtype=cfg.dtype))
    phi_in = torch.as_tensor(stats.phi_wk).to(device=dev, dtype=cfg.dtype)
    ptot_in = torch.as_tensor(stats.phi_k).to(device=dev, dtype=cfg.dtype)
    kops.check_index_ranges(batch.word_ids, None, phi_in.shape[0],
                            phi_in.shape[1])
    with fault_lib.active_plan(None):
        phi, ptot, ppl, sweeps = _foem_local(generator, batch, phi_in,
                                             ptot_in, cfg, mesh, mu0)
    step = torch.as_tensor(stats.step) + 1
    return GlobalStats(phi_wk=phi, phi_k=ptot, step=step), ppl, sweeps


def heldout_perplexity_sharded(
    generator: Optional[torch.Generator],
    est: MinibatchData,        # this rank's documents, 80% split
    ev: MinibatchData,         # the same documents, 20% split
    stats: GlobalStats,
    cfg: LDAConfig,
    mesh,
    *,
    fit_sweeps: int = 50,
    rel_tol: Optional[float] = None,
    check_every: Optional[int] = None,
    theta0=None,
) -> float:
    """Held-out predictive perplexity (§2.4 / eq. 21) over a topic-sharded
    model: the evaluation companion of :func:`foem_step_sharded`, on every
    rank of ``mesh`` with its document rows and its φ̂ slice.

    The rank normalises its slice locally (eq. 10's denominator is per
    lane), restricts the fit to its top-(A/mp) lanes by φ mass when
    ``cfg.active_topics`` is set (the union is a size-A serving active
    set), and fits through ``ops.infer`` under an ``InferPlan`` naming the
    model axis.  ``theta0`` injects the rank's (D, K/mp) initial θ̂; without
    it the rank draws normalised μ from ``generator`` folded with its model
    index.  ``rel_tol``/``check_every`` default to the config's stop rule.
    Returns the eq. 21 perplexity of all ranks' documents (the same float on
    every rank).
    """
    mp = mesh.model.size
    if cfg.K % mp:
        raise ValueError(f"K ({cfg.K}) does not split over {mp} model ranks")
    dev = mesh.device
    tol = cfg.ppl_rel_tol if rel_tol is None else rel_tol
    check = cfg.ppl_check_every if check_every is None else check_every
    wid = torch.as_tensor(est.word_ids).to(device=dev, dtype=torch.int32)
    est_c = torch.as_tensor(est.counts).to(device=dev, dtype=torch.float32)
    ev_c = torch.as_tensor(ev.counts).to(device=dev, dtype=torch.float32)
    phi_wk = torch.as_tensor(stats.phi_wk).to(device=dev, dtype=torch.float32)
    phi_k = torch.as_tensor(stats.phi_k).to(device=dev, dtype=torch.float32)
    phi_norm = em.normalize_phi(phi_wk, phi_k, cfg)
    if theta0 is None:
        mu = _draw_slice(generator, tuple(wid.shape) + (phi_wk.shape[1],),
                         mesh)
        theta0 = em.fold_theta(mu, est_c)
        del mu
    wt = None
    if cfg.active_topics:
        wt = sched_lib.select_active_topics(
            phi_norm, max(1, cfg.active_topics // mp))
    res = kops.infer(
        wid, est_c, theta0, phi_norm, alpha_m1=cfg.alpha_m1, ev_counts=ev_c,
        word_topics=wt, max_sweeps=fit_sweeps, check_every=check,
        rel_tol=tol, plan=InferPlan(axis_name=mesh.model),
        debug_checks=cfg.debug_checks, device=dev)
    # ev_loglik is reduced over the model axis already: only data remains
    ll, ntok = mesh.data.all_reduce(res.ev_loglik.reshape(1),
                                    ev_c.sum().reshape(1))
    return float(torch.exp(-ll / ntok.clamp_min(1.0))[0])
