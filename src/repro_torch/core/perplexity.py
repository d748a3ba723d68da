"""Held-out inference & predictive perplexity — paper §2.4, eq. (21)
(PyTorch port of ``repro.core.perplexity``).

Protocol (faithful to the paper):
  1. estimate φ̂ on the training stream;
  2. per held-out document, split word *tokens* 80/20 by binomial thinning
     (``split_heldout_counts``);
  3. fixing φ̂, fit θ̂ on the 80% part by the frozen-φ fixed-point E-step
     (eq. 11 with the φ M-step switched off — ``kernels.ops.infer``);
  4. P = exp(− Σ x^{20%} log Σ_k θ_d(k) φ_w(k) / Σ x^{20%})   (eq. 21).

Steps 3–4 run fused in ``ops.infer``.  Every function takes the θ̂ init
explicitly: ``seed`` seeds a ``torch.Generator`` on the device, or
``theta0`` replaces the random init altogether (the parity tests pass the
JAX package's own θ̂₀ there).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import em
from repro_torch.core import scheduling as sched_lib
from repro_torch.core.types import (
    InferPlan, InferResult, LDAConfig, MinibatchData,
    uniform_responsibilities,
)
from repro_torch.kernels import ops as kops
from repro_torch.runtime.device import Device, resolve_device

#: Elements of μ₀ drawn at once by ``init_theta`` (512 MB of float32).
_INIT_BLOCK = 1 << 27


def split_heldout_counts(
    counts: np.ndarray, rng: np.random.Generator, frac: float = 0.8
) -> Tuple[np.ndarray, np.ndarray]:
    """Split integer token counts (D, L) into (estimate, evaluate) parts.

    Each of the x_{w,d} tokens lands in the 80% part with prob ``frac``
    (binomial thinning) — the paper's random token partition (§2.4).  Both
    parts keep the full (D, L) ``word_ids`` layout.
    """
    est = rng.binomial(counts.astype(np.int64), frac).astype(counts.dtype)
    return est, counts - est


def serving_active_topics(
    phi_norm: torch.Tensor, active_topics: int, topk_shards: int = 0
) -> torch.Tensor:
    """Serving-time (W_s, A) active-topic sets, ranked by φ mass: per word,
    the ``active_topics`` largest φ_w(k) (lower topic id first on ties).
    ``ops.infer`` restricts the θ̂ *fit* to these lanes."""
    return sched_lib.select_active_topics(phi_norm, active_topics,
                                          topk_shards)


def init_theta(
    generator: torch.Generator, batch: MinibatchData, cfg: LDAConfig
) -> torch.Tensor:
    """Random θ̂ init for the frozen-φ fixed point: fold the estimation
    counts through random-normalised responsibilities (the paper's 'start
    from random initializations').  μ₀ is drawn in column blocks of at
    most ``_INIT_BLOCK`` elements, so the (D, L, K) tensor never exists
    whole; the draws come from ``generator`` and land on its device."""
    D, L = batch.word_ids.shape
    counts = torch.as_tensor(batch.counts).to(device=generator.device,
                                              dtype=cfg.dtype)
    theta = torch.zeros((D, cfg.K), dtype=cfg.dtype, device=generator.device)
    step = max(1, _INIT_BLOCK // max(1, D * cfg.K))
    for lo in range(0, L, step):
        hi = min(lo + step, L)
        mu0 = uniform_responsibilities(generator, (D, hi - lo, cfg.K),
                                       cfg.dtype)
        theta += em.fold_theta(mu0, counts[:, lo:hi])
    return theta


def _theta0(seed: int, theta0, batch: MinibatchData, cfg: LDAConfig,
            dev: torch.device) -> torch.Tensor:
    if theta0 is not None:
        return torch.as_tensor(theta0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_theta(gen, batch, cfg)


def infer_heldout(
    seed: int,
    est: MinibatchData,             # 80% split
    ev: Optional[MinibatchData],    # 20% split (same docs / word layout)
    phi_norm: torch.Tensor,         # (W_s, K) normalised φ (eq. 10)
    cfg: LDAConfig,
    *,
    fit_sweeps: int = 50,
    rel_tol: Optional[float] = None,
    check_every: Optional[int] = None,
    active_topics: int = 0,
    phi_dtype: str = "float32",
    theta0: Optional[torch.Tensor] = None,
    device: Device = "cuda",
) -> InferResult:
    """Full §2.4 inference on a held-out minibatch — the config adapter
    over ``kernels.ops.infer``.

    ``est``/``ev`` must share ``word_ids``; ``ev=None`` fits only.  The
    stop rule defaults to the config's (``ppl_rel_tol``,
    ``ppl_check_every``).
    """
    dev = resolve_device(device)
    phi_norm = torch.as_tensor(phi_norm).to(dev)
    res = kops.infer(
        est.word_ids, est.counts, _theta0(seed, theta0, est, cfg, dev),
        phi_norm,
        alpha_m1=cfg.alpha_m1,
        ev_counts=None if ev is None else ev.counts,
        word_topics=(
            serving_active_topics(phi_norm, active_topics)
            if active_topics else None
        ),
        max_sweeps=fit_sweeps,
        check_every=cfg.ppl_check_every if check_every is None else check_every,
        rel_tol=cfg.ppl_rel_tol if rel_tol is None else rel_tol,
        plan=InferPlan(phi_dtype=phi_dtype),
        debug_checks=cfg.debug_checks,
        device=dev,
    )
    return res


def fit_theta_fixed_phi(
    seed: int,
    batch: MinibatchData,       # estimation split (word_ids + 80% counts)
    phi_norm: torch.Tensor,     # (W_s, K) NORMALISED φ (eq. 10), frozen
    cfg: LDAConfig,
    fit_sweeps: int = 50,
    *,
    rel_tol: Optional[float] = None,
    check_every: Optional[int] = None,
    active_topics: int = 0,
    theta0: Optional[torch.Tensor] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Fixed-φ EM for θ̂ on the estimation split — §2.4 step 3.  Returns
    θ̂ (D, K) sufficient statistics (eq. 9 normalisation is the caller's)."""
    return infer_heldout(
        seed, batch, None, phi_norm, cfg, fit_sweeps=fit_sweeps,
        rel_tol=rel_tol, check_every=check_every,
        active_topics=active_topics, theta0=theta0, device=device,
    ).theta


def predictive_perplexity(
    seed: int,
    est: MinibatchData,        # 80% split
    ev: MinibatchData,         # 20% split (same docs / word layout)
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    fit_sweeps: int = 50,
    *,
    rel_tol: Optional[float] = None,
    check_every: Optional[int] = None,
    active_topics: int = 0,
    theta0: Optional[torch.Tensor] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """eq. (21) on the evaluation split — the paper's headline metric.

    Normalises the sufficient statistics to φ (eq. 10), fits θ̂ on the 80%
    split and returns exp(−ev_loglik/ntokens), the numerator taken from the
    in-launch per-token partials.
    """
    dev = resolve_device(device)
    phi_norm = em.normalize_phi(torch.as_tensor(phi_wk).to(dev),
                                torch.as_tensor(phi_k).to(dev), cfg)
    res = infer_heldout(
        seed, est, ev, phi_norm, cfg, fit_sweeps=fit_sweeps,
        rel_tol=rel_tol, check_every=check_every,
        active_topics=active_topics, theta0=theta0, device=dev,
    )
    return res.perplexity(torch.as_tensor(ev.counts).sum())
