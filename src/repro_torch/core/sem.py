"""SEM — stepwise online EM for LDA (paper Fig. 3), PyTorch port of
``repro.core.sem``.

SEM is FOEM *without* the two speedup techniques: the inner loop is plain BEM
on the minibatch, and the global topic-word statistics are merged with the
explicit Robbins–Monro interpolation (eq. 20).  It is the paper's strongest
prior-art online algorithm (≡ SCVB up to the E-step constants) and the
baseline FOEM is measured against in Figs. 8-12.

The inner E-step reads the minibatch's φ̂ rows, gathered once and frozen,
through ``em.estep`` — the fused E-step kernel on the card (θ̂ one row per
document, L tokens a row), its plain version on the CPU.  The loop
synchronises with the device once per check sweep.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import em
from repro_torch.core.types import (
    GlobalStats,
    LDAConfig,
    LocalState,
    MinibatchData,
    uniform_responsibilities,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gs_sweep import sweep_loglik
from repro_torch.runtime.device import Device, resolve_device


class SEMDiagnostics(NamedTuple):
    sweeps_run: int                 # inner BEM sweeps actually executed
    final_train_ppl: torch.Tensor   # () float32


def sem_step(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    stats: GlobalStats,
    cfg: LDAConfig,
    stream_scale: float = 1.0,
    vocab_size: Optional[int] = None,
    *,
    mu0=None,                       # (D, L, K) initial μ; drawn when None
    device: Device = "cuda",
) -> Tuple[GlobalStats, LocalState, SEMDiagnostics]:
    """One SEM minibatch step: inner BEM to convergence + the merge.

    The inner E-step reads the *frozen* φ̂^{s−1} (paper Fig. 3 line 5) while
    θ̂ iterates: after the first sweep, and then on every
    ``ppl_check_every``-th, the training perplexity under the frozen φ̂ is
    compared with the last one and the loop stops when it moves by less
    than ``ppl_rel_tol`` relative, or after ``max_sweeps``.  Then φ̂ merges:
    ``rho_mode="accumulate"`` adds the minibatch's Σ_d x μ (eq. 33 with
    ρ = 1/s), ``"stepwise"`` interpolates with ρ_s = (τ0 + s)^(−κ) (eq. 18,
    20), ``stream_scale`` = D/D_s.

    ``mu0`` supplies the initial μ (the cross-package tests pass the JAX
    package's), else it is drawn from ``generator``.  Inputs may be numpy
    arrays or tensors; they move to ``device`` (default ``"cuda"``, which
    raises without a GPU).  On a local (W_s, K) view ``vocab_size`` carries
    the global W of the smoothing mass.  ``cfg.debug_checks`` raises
    ``ContractError``: SEM's sweeps never reach ``ops.sweep``, where the
    sanitizer runs, and the JAX package's flag has no effect here.
    """
    kops.refuse_debug_checks(cfg.debug_checks, "sem_step")
    dev = resolve_device(device)
    wid = torch.as_tensor(batch.word_ids).to(device=dev, dtype=torch.int32)
    counts = torch.as_tensor(batch.counts).to(device=dev, dtype=cfg.dtype)
    stats = GlobalStats(
        torch.as_tensor(stats.phi_wk).to(device=dev, dtype=cfg.dtype),
        torch.as_tensor(stats.phi_k).to(device=dev, dtype=cfg.dtype),
        torch.as_tensor(stats.step).to(device=dev, dtype=torch.int32),
    )
    D, L = wid.shape
    W = cfg.W if vocab_size is None else vocab_size
    kops.check_index_ranges(wid, None, stats.phi_wk.shape[0], cfg.K)
    if mu0 is None:
        if generator is None:
            raise ValueError("sem_step needs a generator or mu0")
        mu0 = uniform_responsibilities(generator, (D, L, cfg.K), cfg.dtype)
    mu0 = torch.as_tensor(mu0).to(device=dev, dtype=cfg.dtype).contiguous()
    local = LocalState(mu=mu0, theta_dk=em.fold_theta(mu0, counts))

    phi_rows = em.gather_phi_rows(stats.phi_wk, wid)        # frozen φ̂^{s−1}
    ntok = counts.sum().clamp_min(1.0)

    def inner_ppl(local):
        # the eq. 3 data term with frozen φ̂ (θ̂ alone refreshes), column by
        # column: no second (D, L, K) gather of normalised rows
        ll = sweep_loglik(wid, counts, local.theta_dk, stats.phi_wk,
                          stats.phi_k, W * cfg.beta_m1,
                          alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1)
        return torch.exp(-ll / ntok)

    def sweep(local):
        mu = em.estep(local.theta_dk[:, None, :], phi_rows, stats.phi_k,
                      cfg, vocab_size=W)
        return LocalState(mu=mu, theta_dk=em.fold_theta(mu, counts))

    local = sweep(local)
    t = 1
    last_ppl = inner_ppl(local)
    while t < cfg.max_sweeps:
        local = sweep(local)
        check = (t + 1) % cfg.ppl_check_every == 0
        t += 1
        if check:
            ppl = inner_ppl(local)
            done = bool(torch.abs(last_ppl - ppl)
                        < cfg.ppl_rel_tol * torch.abs(ppl))
            last_ppl = ppl
            if done:
                break
    del phi_rows

    mb_wk, mb_k = em.fold_phi(local.mu, counts, wid, stats.phi_wk.shape[0])
    s = stats.step + 1
    if cfg.rho_mode == "accumulate":
        phi_wk = stats.phi_wk + mb_wk                         # eq. 33 (1/s)
        phi_k = stats.phi_k + mb_k
    else:
        rho = (cfg.tau0 + s.to(torch.float32)) ** (-cfg.kappa)  # eq. 18
        phi_wk = (1.0 - rho) * stats.phi_wk + rho * stream_scale * mb_wk
        phi_k = (1.0 - rho) * stats.phi_k + rho * stream_scale * mb_k
    new_stats = GlobalStats(phi_wk=phi_wk, phi_k=phi_k, step=s)
    return new_stats, local, SEMDiagnostics(sweeps_run=t,
                                            final_train_ppl=last_ppl)
