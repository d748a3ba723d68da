"""Online LDA baselines the paper compares against (§2.5, §4), PyTorch port
of ``repro.core.baselines``.

* **OVB**  — online variational Bayes (Hoffman et al., NIPS'10): digamma
  E-step (eq. 23), Robbins–Monro update of the variational λ ≡ φ̂ statistics.
* **SCVB** — stochastic collapsed VB0 (Foulds et al., KDD'13).  The paper
  (Table 3, §2.5) shows SCVB ≡ SEM with GS-style pseudo-counts (α, β instead
  of α−1, β−1); implemented that way.
* **OGS**  — online collapsed Gibbs (Yao et al., KDD'09 flavour): MCMC E-step
  samples hard topic assignments per token, stepwise merge of the sampled
  counts.

All three share ``sem_step``'s streaming interface: a fixed number of
sweeps over the minibatch against its frozen φ̂ rows, then the eq. 18
stepwise merge ρ_s = (τ0 + s)^(−κ) of the minibatch's statistics (whatever
``cfg.rho_mode`` says, as in the JAX package).

Both E-steps of OVB and SCVB have the form the fused E-step computes —
normalise over K of (θ+a)(φ+b)/(φ(k)+c) — so each sweep is one
``ops.fused_estep`` call over the D·L token rows with θ̂ one row per
document (G = L): the ``fused_estep`` kernel on the card, its plain version
on the CPU.  SCVB passes a = α, b = β, c = Wβ.  OVB passes
exp Ψ(θ̂+α) (D, K), exp Ψ(φ̂_w+β) (D, L, K) and exp Ψ(φ̂(k)+Wβ) (K,) with
a = b = c = 0; the last two are fixed within a step and computed once (the
JAX package recomputes them every sweep).  The rest — the sweep loop, the
folds, the merge and the training perplexity — is plain PyTorch on the
device, with no host synchronisation inside the loop.

OGS runs in plain PyTorch, as the JAX package computes it outside any
Pallas kernel.  ``jax.random.categorical`` is Gumbel-max, so a sweep is
``argmax(logits + g)`` over K with g a (D, L, K) standard Gumbel draw; the
draws come from ``generator`` on the device, one sweep at a time, unless
the caller injects them (``z0=``, ``gumbel=``: the cross-package tests pass
the JAX package's).  No (D, L, K) one-hot is built inside the sweep: θ̂
and the closing counts are scatter-adds of integer-valued counts, exact in
any order below 2²⁴, so they are the JAX package's sums bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

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
from repro_torch.kernels.gs_sweep import scatter_add_pairs, scatter_add_rows
from repro_torch.runtime.device import Device, resolve_device


class BaselineDiagnostics(NamedTuple):
    sweeps_run: int                 # E-step (or Gibbs) sweeps executed
    final_train_ppl: torch.Tensor   # () float32


def _inputs(where: str, batch: MinibatchData, stats: GlobalStats,
            cfg: LDAConfig, device: Device):
    """The step's operands on ``device``: (device, word ids int32, counts,
    stats); word ids outside φ̂'s rows raise ``ContractError``."""
    kops.refuse_debug_checks(cfg.debug_checks, where)
    dev = resolve_device(device)
    wid = torch.as_tensor(batch.word_ids).to(device=dev, dtype=torch.int32)
    counts = torch.as_tensor(batch.counts).to(device=dev, dtype=cfg.dtype)
    stats = GlobalStats(
        torch.as_tensor(stats.phi_wk).to(device=dev, dtype=cfg.dtype),
        torch.as_tensor(stats.phi_k).to(device=dev, dtype=cfg.dtype),
        torch.as_tensor(stats.step).to(device=dev, dtype=torch.int32),
    )
    kops.check_index_ranges(wid, None, stats.phi_wk.shape[0], cfg.K)
    return dev, wid, counts, stats


def _merge(stats: GlobalStats, mb_wk: torch.Tensor, mb_k: torch.Tensor,
           cfg: LDAConfig, stream_scale: float) -> GlobalStats:
    """eq. 18: φ̂ ← (1−ρ)·φ̂ + ρ·stream_scale·Δφ̂ with ρ = (τ0 + s)^(−κ), the
    JAX package's operations in its order (``mb_wk`` is scaled in place:
    one (W, K) temporary fewer)."""
    s = stats.step + 1
    rho = (cfg.tau0 + s.to(torch.float32)) ** (-cfg.kappa)
    phi_wk = (1.0 - rho) * stats.phi_wk
    phi_wk += mb_wk.mul_(rho * stream_scale)
    phi_k = (1.0 - rho) * stats.phi_k + rho * stream_scale * mb_k
    return GlobalStats(phi_wk, phi_k, s)


def _fixed_point(where, generator, batch, stats, cfg, stream_scale, mu0,
                 device, estep_inputs):
    """The OVB/SCVB step: ``cfg.max_sweeps`` fused E-steps against the
    frozen φ̂ rows (θ̂ folded after each), the minibatch's fold, the merge
    and the training perplexity.  ``estep_inputs(phi_rows, phi_k)`` maps
    the gathered (D, L, K) rows (its own copy) and φ̂(k) to
    ``(theta_term, rows, tot, a, b, c)``: ``ops.fused_estep``'s θ̂ rows
    ``theta_term(θ̂)`` (D, K), φ̂ rows (D, L, K), totals (K,) and
    ``alpha_m1``, ``beta_m1``, ``wb``."""
    dev, wid, counts, stats = _inputs(where, batch, stats, cfg, device)
    D, L = wid.shape
    K = cfg.K
    if mu0 is None:
        if generator is None:
            raise ValueError(f"{where} needs a generator or mu0")
        mu0 = uniform_responsibilities(generator, (D, L, K), cfg.dtype)
    mu = torch.as_tensor(mu0).to(device=dev, dtype=cfg.dtype).contiguous()
    theta = em.fold_theta(mu, counts)
    theta_term, rows, tot, a, b, c = estep_inputs(
        em.gather_phi_rows(stats.phi_wk, wid), stats.phi_k)
    rows = rows.reshape(D * L, K)
    for _ in range(cfg.max_sweeps):
        mu, _ = kops.fused_estep(theta_term(theta), rows, tot, None, None,
                                 None, alpha_m1=a, beta_m1=b, wb=c)
        mu = mu.reshape(D, L, K)
        theta = em.fold_theta(mu, counts)
    del rows
    mb_wk, mb_k = em.fold_phi(mu, counts, wid, stats.phi_wk.shape[0])
    new = _merge(stats, mb_wk, mb_k, cfg, stream_scale)
    del mb_wk
    ppl = em.training_perplexity(MinibatchData(wid, counts), theta,
                                 new.phi_wk, new.phi_k, cfg)
    return (new, LocalState(mu=mu, theta_dk=theta),
            BaselineDiagnostics(cfg.max_sweeps, ppl))


# ---------------------------------------------------------------------------
# OVB — online variational Bayes
# ---------------------------------------------------------------------------

def ovb_step(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    stats: GlobalStats,
    cfg: LDAConfig,
    stream_scale: float = 1.0,
    *,
    mu0=None,                       # (D, L, K) initial μ; drawn when None
    device: Device = "cuda",
) -> Tuple[GlobalStats, LocalState, BaselineDiagnostics]:
    """One OVB minibatch step: ``cfg.max_sweeps`` eq. 23 E-steps,
    μ ∝ exp Ψ(θ̂+α)·exp Ψ(φ̂_w+β) / exp Ψ(φ̂(k)+Wβ) with the *full*
    Dirichlet parameters α = α−1 + 1, β = β−1 + 1 (the VB prior is the
    caller's choice via cfg), then the stepwise merge.

    ``mu0`` supplies the initial μ (the cross-package tests pass the JAX
    package's), else it is drawn from ``generator``.  Inputs may be numpy
    arrays or tensors; they move to ``device`` (default ``"cuda"``, which
    raises without a GPU).  ``cfg.debug_checks`` raises ``ContractError``.
    """
    alpha = cfg.alpha_m1 + 1.0
    beta = cfg.beta_m1 + 1.0

    def estep_inputs(phi_rows, phi_k):
        e_ph = phi_rows.add_(beta).digamma_().exp_()       # in place
        e_pt = torch.special.digamma(phi_k + cfg.W * beta).exp_()
        return (lambda th: torch.special.digamma(th + alpha).exp_(),
                e_ph, e_pt, 0.0, 0.0, 0.0)

    return _fixed_point("ovb_step", generator, batch, stats, cfg,
                        stream_scale, mu0, device, estep_inputs)


# ---------------------------------------------------------------------------
# SCVB — stochastic collapsed VB0 (≡ SEM with α, β pseudo-counts)
# ---------------------------------------------------------------------------

def scvb_step(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    stats: GlobalStats,
    cfg: LDAConfig,
    stream_scale: float = 1.0,
    *,
    mu0=None,                       # (D, L, K) initial μ; drawn when None
    device: Device = "cuda",
) -> Tuple[GlobalStats, LocalState, BaselineDiagnostics]:
    """One SCVB minibatch step: ``cfg.max_sweeps`` E-steps
    μ ∝ (θ̂+α)(φ̂_w+β)/(φ̂(k)+Wβ) — SEM's with α, β in place of α−1, β−1 —
    then the stepwise merge.  Arguments as :func:`ovb_step`."""
    alpha = cfg.alpha_m1 + 1.0
    beta = cfg.beta_m1 + 1.0

    def estep_inputs(phi_rows, phi_k):
        return (lambda th: th, phi_rows, phi_k, alpha, beta, cfg.W * beta)

    return _fixed_point("scvb_step", generator, batch, stats, cfg,
                        stream_scale, mu0, device, estep_inputs)


# ---------------------------------------------------------------------------
# OGS — online collapsed Gibbs sampling
# ---------------------------------------------------------------------------

def _standard_gumbel(generator: torch.Generator, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard Gumbel draws −log(−log u), u ~ U(tiny, 1), on the
    generator's device (the JAX package's ``gumbel`` in its default mode)."""
    u = torch.empty(shape, dtype=dtype, device=generator.device)
    u.uniform_(torch.finfo(dtype).tiny, 1.0, generator=generator)
    return u.log_().neg_().log_().neg_()


def ogs_step(
    generator: Optional[torch.Generator],
    batch: MinibatchData,
    stats: GlobalStats,
    cfg: LDAConfig,
    stream_scale: float = 1.0,
    gibbs_sweeps: int = 8,
    *,
    z0=None,                        # (D, L) int initial topics
    gumbel: Optional[Sequence] = None,  # gibbs_sweeps × (D, L, K) float32
    device: Device = "cuda",
) -> Tuple[GlobalStats, LocalState, BaselineDiagnostics]:
    """MCMC-EM per minibatch: sample hard z per token slot, count, merge.

    Each of ``gibbs_sweeps`` sweeps samples every slot's z from
    logits = (log max(θ̂_excl+α, 1e-30) + log max(φ̂_w+β, 1e-30))
    − log(φ̂(k)+Wβ), θ̂_excl being θ̂ without the slot's own count at its
    current topic (the JAX package's terms in its order); θ̂ then moves by
    the slots' count changes.  One topic per non-zero slot, weighted by its
    count (the JAX package's adaptation of per-token sampling).

    ``z0`` and ``gumbel`` inject the initial topics and each sweep's
    Gumbel noise; absent, they are drawn from ``generator`` on the device,
    the noise one sweep at a time.  The returned ``LocalState`` holds
    μ = one-hot(z)·counts and θ̂, as in the JAX package.  Other arguments
    as :func:`ovb_step`.
    """
    dev, wid, counts, stats = _inputs("ogs_step", batch, stats, cfg, device)
    alpha = cfg.alpha_m1 + 1.0
    beta = cfg.beta_m1 + 1.0
    D, L = wid.shape
    K = cfg.K
    if gumbel is not None and len(gumbel) != gibbs_sweeps:
        raise ValueError(f"gumbel holds {len(gumbel)} sweeps' draws, not "
                         f"gibbs_sweeps = {gibbs_sweeps}")
    if (z0 is None or gumbel is None) and generator is None:
        raise ValueError("ogs_step needs a generator or both z0 and gumbel")
    if z0 is None:
        z = torch.randint(0, K, (D, L), generator=generator,
                          device=generator.device).to(dev)
    else:
        z = torch.as_tensor(z0).to(device=dev, dtype=torch.int64)
        if tuple(z.shape) != (D, L) or bool(((z < 0) | (z >= K)).any()):
            raise ValueError(f"z0 must be (D, L) = ({D}, {L}) topics in "
                             f"[0, {K}), got shape {tuple(z.shape)}")
    doc = torch.arange(D, device=dev)[:, None].expand(D, L)
    theta = scatter_add_pairs(
        torch.zeros((D, K), dtype=cfg.dtype, device=dev), doc, z, counts)
    # the φ terms are fixed within the step: (log φ̂_w) and (log φ̂(k))
    log_phi = em.gather_phi_rows(stats.phi_wk, wid).add_(beta) \
        .clamp_min_(1e-30).log_()
    log_tot = torch.log(stats.phi_k + cfg.W * beta)
    for i in range(gibbs_sweeps):
        logits = torch.log((theta + alpha).clamp_min_(1e-30))[:, None, :] \
            + log_phi
        logits -= log_tot
        # the slot's own topic: θ̂ without its count there
        zi = z[..., None]
        own = torch.log(((theta[doc, z] - counts) + alpha).clamp_min_(1e-30))
        own = (own[..., None] + log_phi.gather(2, zi)) - log_tot[zi]
        logits.scatter_(2, zi, own)
        if gumbel is None:
            g = _standard_gumbel(generator, (D, L, K), cfg.dtype).to(dev)
        else:
            g = torch.as_tensor(gumbel[i]).to(device=dev, dtype=cfg.dtype)
        z_new = logits.add_(g).argmax(-1)
        del logits, g
        scatter_add_pairs(theta, doc, z, -counts)
        scatter_add_pairs(theta, doc, z_new, counts)
        z = z_new
    del log_phi
    mb_wk = scatter_add_pairs(
        torch.zeros_like(stats.phi_wk), wid, z, counts)
    mb_k = scatter_add_rows(torch.zeros(K, dtype=cfg.dtype, device=dev),
                            z, counts.reshape(-1))
    new = _merge(stats, mb_wk, mb_k, cfg, stream_scale)
    del mb_wk
    ppl = em.training_perplexity(MinibatchData(wid, counts), theta,
                                 new.phi_wk, new.phi_k, cfg)
    mu = torch.zeros((D, L, K), dtype=cfg.dtype, device=dev)
    mu.scatter_(2, z[..., None], counts[..., None])
    return (new, LocalState(mu=mu, theta_dk=theta),
            BaselineDiagnostics(gibbs_sweeps, ppl))


ALGORITHMS = {
    "ovb": ovb_step,
    "scvb": scvb_step,
    "ogs": ogs_step,
}
