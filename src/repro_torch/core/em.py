"""EM building blocks for LDA (PyTorch port of ``repro.core.em``).

* ``estep``             — eq. (11)/(13): responsibilities from sufficient
                          stats, with optional IEM self-exclusion, through
                          the fused E-step kernel (``ops.fused_estep``).
* ``fold_theta`` / ``fold_phi`` / ``fold_phi_delta`` — M-step folds.
* ``bem_sweep``         — one synchronous Jacobi sweep (paper Fig. 1).
* ``blocked_iem_sweep`` / ``iem_sweep`` — paper Fig. 2: the token columns in
                          B sequential blocks, each block's E-step vectorized
                          (Jacobi) and its statistics folded before the next
                          block reads them (Gauss-Seidel across blocks).  At
                          B = L with ``sweep_impl="fused"`` one
                          ``ops.sweep`` call (``gs_sweep_with_residuals``);
                          coarse blocks and ``sweep_impl="scan"`` run the
                          blocked scan over ``estep``.
* ``bem_fit`` / ``iem_fit`` — whole-corpus drivers (tests, benchmarks).
* ``normalize_theta`` / ``normalize_phi`` — eq. (9) / eq. (10).
* ``map_log_likelihood`` / ``training_perplexity`` — eq. (3)'s data term.
* ``iem_exact_numpy``   — the paper's serial per-non-zero IEM in NumPy; the
                          oracle for tests.

The segment sums and the blocked scan's φ̂ fold go through
``gs_sweep.segment_sum`` / ``gs_sweep.scatter_add_rows``, which add
duplicates in a fixed order on every device (never with atomics): the same
inputs give the same bits on every run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import (
    LDAConfig, LocalState, MinibatchData, SweepPlan, SweepResult,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gs_sweep import scatter_add_rows, segment_sum


# ---------------------------------------------------------------------------
# E-step
# ---------------------------------------------------------------------------

def estep(
    theta_rows: torch.Tensor,    # (D, 1|L, K) θ̂ broadcast over token slots
    phi_rows: torch.Tensor,      # (D, L, K)   φ̂ gathered at each token's word
    phi_tot: torch.Tensor,       # (K,) — φ̂(k)
    cfg: LDAConfig,
    *,
    exclude: Optional[torch.Tensor] = None,  # (D, L, K) counts·μ_old (eq. 13)
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Responsibility update μ_{w,d}(k) — paper eq. (11) (BEM) / eq. (13)
    (IEM).  Returns the *normalized* responsibilities, shape (D, L, K).

    One ``ops.fused_estep`` call over the D·L token rows on the tensors'
    device: the fused E-step kernel on the card, its plain version on the
    CPU.  A (D, 1, K) θ̂ goes in as one row per document (G = L tokens a
    row), never broadcast to (D, L, K).
    """
    W = cfg.W if vocab_size is None else vocab_size
    D, L, K = phi_rows.shape
    if theta_rows.shape[1] not in (1, L):
        raise ValueError(f"theta_rows must be (D, 1|L, K), got "
                         f"{tuple(theta_rows.shape)}")
    mu, _ = kops.fused_estep(
        theta_rows.reshape(-1, K), phi_rows.reshape(D * L, K),
        phi_tot.reshape(K),
        None if exclude is None else exclude.reshape(D * L, K), None, None,
        alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1, wb=W * cfg.beta_m1,
    )
    return mu.reshape(D, L, K)


def gather_phi_rows(phi_wk: torch.Tensor,
                    word_ids: torch.Tensor) -> torch.Tensor:
    """Gather φ̂ rows for every token slot: (W,K)[(D,L)] -> (D,L,K)."""
    return phi_wk[word_ids.long()]


# ---------------------------------------------------------------------------
# M-step folds
# ---------------------------------------------------------------------------

def fold_theta(mu: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """θ̂_d(k) = Σ_w x_{w,d} μ_{w,d}(k)   — (D, L, K) x (D, L) -> (D, K)."""
    return torch.einsum("dlk,dl->dk", mu, counts)


def fold_phi(
    mu: torch.Tensor, counts: torch.Tensor, word_ids: torch.Tensor,
    vocab_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Δφ̂_w(k) = Σ_d x_{w,d} μ_{w,d}(k) and Δφ̂(k), via a segment sum over
    the token slots.  Returns ``(delta_phi_wk (W,K), delta_phi_k (K,))``."""
    D, L, K = mu.shape
    weighted = mu * counts[..., None]                  # (D, L, K)
    flat = weighted.reshape(D * L, K)
    return segment_sum(flat, word_ids, vocab_size), flat.sum(0)


def fold_phi_delta(
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    word_ids: torch.Tensor,
    delta_rows: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a *compacted* Δφ̂ contribution into the stats (eq. 33,
    accumulate mode): ``φ̂_wk[word_ids] += Δrows``, ``φ̂_k += ΣΔrows``, on
    new tensors.  ``word_ids`` is the (R,) row index of the contribution
    and ``delta_rows`` its (R, K) dense delta."""
    phi_wk = phi_wk.clone().index_put_((word_ids.long(),), delta_rows,
                                       accumulate=True)
    return phi_wk, phi_k + delta_rows.sum(0)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def bem_sweep(
    batch: MinibatchData,
    local: LocalState,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
) -> Tuple[LocalState, torch.Tensor, torch.Tensor]:
    """One synchronous BEM sweep over a minibatch (paper Fig. 1 lines 4-7),
    on the tensors' device.  ``phi_wk`` is the matrix the E-step reads; the
    caller decides how Δφ̂ merges.  Returns ``(new_local, Δφ̂_wk, Δφ̂_k)``:
    the *minibatch totals* Σ_d x μ (not increments)."""
    W = vocab_size if vocab_size is not None else cfg.W
    phi_rows = gather_phi_rows(phi_wk, batch.word_ids)
    mu = estep(local.theta_dk[:, None, :], phi_rows, phi_k, cfg,
               vocab_size=W)
    del phi_rows
    theta = fold_theta(mu, batch.counts)
    d_wk, d_k = fold_phi(mu, batch.counts, batch.word_ids, phi_wk.shape[0])
    return LocalState(mu=mu, theta_dk=theta), d_wk, d_k


def _blocked_scan(
    batch: MinibatchData,
    local: LocalState,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    num_blocks: int,
    W: int,
) -> Tuple[LocalState, torch.Tensor, torch.Tensor]:
    """The blocked scan of ``repro.core.em.blocked_iem_sweep``, returning
    working copies ``(local, φ̂, φ̂(k))``.

    The L columns split into ``num_blocks`` blocks of ⌈L/B⌉ columns (the
    JAX package pads L to a multiple of B with zero-count slots, which
    fold nothing; here the last block is simply narrower).  Per block: the
    eq. 13 E-step against the current statistics (``estep``, θ̂ one row per
    document), then Δ = x·μ_new − x·μ_old folds into θ̂, into the φ̂ rows
    the block touches (``scatter_add_rows``: deterministic, no (W_s, K)
    temporary — the JAX scan adds a dense ``segment_sum`` per block) and
    into φ̂(k).
    """
    D, L = batch.word_ids.shape
    K = phi_wk.shape[1]
    blk = -(-L // num_blocks)
    theta, ptot = local.theta_dk, phi_k
    phi = phi_wk.clone()
    mu_out = torch.empty_like(local.mu)
    for c0 in range(0, L, blk):
        c1 = min(c0 + blk, L)
        wid = batch.word_ids[:, c0:c1]
        cnt = batch.counts[:, c0:c1, None]
        ex = cnt * local.mu[:, c0:c1]                       # (D, nb, K)
        rows = gather_phi_rows(phi, wid)
        mu_new = estep(theta[:, None, :], rows, ptot, cfg, exclude=ex,
                       vocab_size=W)
        del rows
        d = (cnt * mu_new).sub_(ex)                         # x·μ_new − x·μ_old
        del ex
        theta = theta + d.sum(1)
        scatter_add_rows(phi, wid, d.reshape(-1, K))
        ptot = ptot + d.sum((0, 1))
        mu_out[:, c0:c1] = mu_new
        del d, mu_new
    if not L:
        theta, ptot = theta.clone(), ptot.clone()
    return LocalState(mu=mu_out, theta_dk=theta), phi, ptot


def iem_sweep(
    batch: MinibatchData,
    local: LocalState,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    num_blocks: Optional[int] = None,
    vocab_size: Optional[int] = None,
) -> Tuple[LocalState, torch.Tensor, torch.Tensor]:
    """One incremental-EM sweep in working-copy form: ``(local, φ̂', φ̂(k)')``.

    B = L with ``sweep_impl="fused"`` is one column-serial ``ops.sweep``
    call; a coarse B (``num_blocks`` or ``cfg.iem_blocks``) or
    ``sweep_impl="scan"`` runs the blocked scan (:func:`_blocked_scan`).
    """
    L = batch.word_ids.shape[1]
    W = vocab_size if vocab_size is not None else cfg.W
    B = cfg.resolve_blocks(L, num_blocks)
    if B == L and cfg.sweep_impl == "fused":
        r = gs_sweep_with_residuals(batch, local, phi_wk, phi_k, cfg,
                                    vocab_size=W)
        return LocalState(mu=r.mu, theta_dk=r.theta), r.phi_wk, r.phi_k
    return _blocked_scan(batch, local, phi_wk, phi_k, cfg, B, W)


def blocked_iem_sweep(
    batch: MinibatchData,
    local: LocalState,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    num_blocks: Optional[int] = None,
    vocab_size: Optional[int] = None,
) -> Tuple[LocalState, torch.Tensor, torch.Tensor]:
    """Blocked incremental-EM sweep — paper Fig. 2 in B sequential column
    blocks (``num_blocks`` or ``cfg.iem_blocks``; 0 means B = L).  Returns
    the updated LocalState and the φ̂ *deltas* of this sweep,
    ``(local, Δφ̂_wk, Δφ̂_k)`` — the JAX package's contract;
    :func:`iem_sweep` is the same sweep returning working copies."""
    loc, phi, ptot = iem_sweep(batch, local, phi_wk, phi_k, cfg,
                               num_blocks=num_blocks, vocab_size=vocab_size)
    return loc, phi - phi_wk, ptot - phi_k


def gs_sweep_with_residuals(
    batch: MinibatchData,
    local: LocalState,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
    as_delta: bool = False,
    compute_loglik: bool = False,
    plan: Optional[SweepPlan] = None,
    check_indices: bool = True,
) -> SweepResult:
    """One fused column-serial Gauss-Seidel sweep, emitting eq. 36 residuals.

    Thin config adapter over ``kernels.ops.sweep``, on the device the
    tensors lie on.  With ``as_delta=True`` the φ̂ stats come back as the
    sweep's deltas instead of updated working copies; ``compute_loglik``
    fills ``SweepResult.loglik`` with the post-sweep eq. 3 data term.
    ``vocab_size`` is the global W of the smoothing mass W·(β−1).
    """
    W = vocab_size if vocab_size is not None else cfg.W
    r = kops.sweep(
        batch.word_ids, batch.counts, local.mu, local.theta_dk,
        phi_wk, phi_k,
        alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1, wb=W * cfg.beta_m1,
        compute_loglik=compute_loglik, plan=plan,
        check_indices=check_indices, debug_checks=cfg.debug_checks,
        device=local.mu.device,
    )
    if as_delta:
        r = r._replace(phi_wk=r.phi_wk - phi_wk, phi_k=r.phi_k - phi_k)
    return r


# ---------------------------------------------------------------------------
# Normalisations, likelihood, perplexity
# ---------------------------------------------------------------------------

def normalize_theta(theta_dk: torch.Tensor, cfg: LDAConfig) -> torch.Tensor:
    """eq. (9): θ_d(k) = (θ̂+α−1) / (Σ_k θ̂ + K(α−1))."""
    num = theta_dk + cfg.alpha_m1
    den = theta_dk.sum(-1, keepdim=True) + cfg.K * cfg.alpha_m1
    return num / den.clamp_min(1e-30)


def normalize_phi(
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """eq. (10): φ_w(k) = (φ̂+β−1) / (φ̂(k) + W(β−1)) — vocab-major (W, K).

    ``phi_wk`` may be a *local* (W_s, K) view of the global matrix (parameter
    streaming); the smoothing mass in the denominator must still use the
    *model's* vocabulary size, so callers operating on a view pass the global
    ``vocab_size`` explicitly.
    """
    W = cfg.W if vocab_size is None else vocab_size
    num = phi_wk + cfg.beta_m1
    den = phi_k + W * cfg.beta_m1
    return num / den.clamp_min(1e-30)[None, :]


def map_log_likelihood(
    batch: MinibatchData,
    theta_dk: torch.Tensor,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Word log-likelihood  Σ x log Σ_k θ_d(k) φ_w(k)  (eq. 3's data term).

    On a local (W_s, K) view, ``batch.word_ids`` index the view's rows and
    ``vocab_size`` carries the global W for the φ normaliser.
    """
    theta = normalize_theta(theta_dk, cfg)                     # (D, K)
    # gather, then eq. 10 in place on the gathered rows: normalize_phi's
    # elementwise operations on the same values, without a (W, K) temporary
    W = cfg.W if vocab_size is None else vocab_size
    den = (phi_k + W * cfg.beta_m1).clamp_min(1e-30)
    rows = gather_phi_rows(phi_wk, batch.word_ids)             # (D, L, K)
    rows.add_(cfg.beta_m1).div_(den)
    lik = torch.einsum("dlk,dk->dl", rows, theta).clamp_min(1e-30)
    return (batch.counts * torch.log(lik)).sum()


def training_perplexity(
    batch: MinibatchData,
    theta_dk: torch.Tensor,
    phi_wk: torch.Tensor,
    phi_k: torch.Tensor,
    cfg: LDAConfig,
    *,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """exp(−loglik / ntokens) on the training minibatch (inner-loop stop
    rule)."""
    ll = map_log_likelihood(
        batch, theta_dk, phi_wk, phi_k, cfg, vocab_size=vocab_size
    )
    return torch.exp(-ll / batch.counts.sum().clamp_min(1.0))


# ---------------------------------------------------------------------------
# Whole-corpus drivers (BEM, paper Fig. 1; IEM, Fig. 2) — tests, benchmarks
# ---------------------------------------------------------------------------

def _initial_stats(batch: MinibatchData, mu0: torch.Tensor, cfg: LDAConfig):
    theta0 = fold_theta(mu0, batch.counts)
    phi0, ptot0 = fold_phi(mu0, batch.counts, batch.word_ids, cfg.W)
    return LocalState(mu0, theta0), phi0, ptot0


def bem_fit(
    batch: MinibatchData, mu0: torch.Tensor, cfg: LDAConfig, sweeps: int
) -> Tuple[LocalState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``sweeps`` full BEM iterations on one (small) corpus, on the
    tensors' device.  Returns ``(local, phi_wk, phi_k, loglik_per_sweep)``.
    """
    local, phi, ptot = _initial_stats(batch, mu0, cfg)
    lls = []
    for _ in range(sweeps):
        local, phi, ptot = bem_sweep(batch, local, phi, ptot, cfg)
        lls.append(map_log_likelihood(batch, local.theta_dk, phi, ptot, cfg))
    return local, phi, ptot, torch.stack(lls) if lls else torch.zeros(0)


def iem_fit(
    batch: MinibatchData, mu0: torch.Tensor, cfg: LDAConfig, sweeps: int,
    num_blocks: int = 0,
) -> Tuple[LocalState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``sweeps`` incremental-EM iterations on one (small) corpus, on
    the tensors' device (:func:`iem_sweep`; ``num_blocks == 0`` defers to
    ``cfg.iem_blocks``, whose 0 means B = L).  Returns ``(local, phi_wk,
    phi_k, loglik_per_sweep)``."""
    local, phi, ptot = _initial_stats(batch, mu0, cfg)
    lls = []
    for _ in range(sweeps):
        local, phi, ptot = iem_sweep(batch, local, phi, ptot, cfg,
                                     num_blocks=num_blocks)
        lls.append(map_log_likelihood(batch, local.theta_dk, phi, ptot, cfg))
    return local, phi, ptot, torch.stack(lls) if lls else torch.zeros(0)


# ---------------------------------------------------------------------------
# Exact serial IEM oracle (paper Fig. 2) — NumPy, tests only
# ---------------------------------------------------------------------------

def iem_exact_numpy(
    word_ids: np.ndarray,   # (D, L) int
    counts: np.ndarray,     # (D, L) float
    mu0: np.ndarray,        # (D, L, K)
    cfg: LDAConfig,
    sweeps: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference serial IEM: per-non-zero E/M alternation with
    self-exclusion, in float64, visiting token columns left to right and
    the documents of a column in order (the JAX package's oracle).  Equal
    to the B = L sweep when each document's tokens touch disjoint words.
    Returns ``(mu, theta, phi)``."""
    D, L = word_ids.shape
    K = cfg.K
    mu = mu0.copy().astype(np.float64)
    theta = np.einsum("dlk,dl->dk", mu, counts)
    phi = np.zeros((cfg.W, K))
    for d in range(D):
        for l in range(L):
            phi[word_ids[d, l]] += counts[d, l] * mu[d, l]
    ptot = phi.sum(0)
    for _ in range(sweeps):
        for l in range(L):
            for d in range(D):
                c = counts[d, l]
                if c == 0.0:
                    continue
                w = word_ids[d, l]
                old = c * mu[d, l]
                th = np.maximum(theta[d] - old, 0.0)
                ph = np.maximum(phi[w] - old, 0.0)
                pt = ptot - old
                num = (th + cfg.alpha_m1) * (ph + cfg.beta_m1) / (
                    pt + cfg.W * cfg.beta_m1)
                mu_new = num / max(num.sum(), 1e-30)
                new = c * mu_new
                theta[d] += new - old
                phi[w] += new - old
                ptot += new - old
                mu[d, l] = mu_new
    return mu, theta, phi
