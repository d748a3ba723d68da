"""EM building blocks for LDA (PyTorch port of ``repro.core.em``).

* ``estep``             — eq. (11)/(13): responsibilities from sufficient
                          stats, with optional IEM self-exclusion.
* ``fold_theta`` / ``fold_phi`` / ``fold_phi_delta`` — M-step folds.
* ``blocked_iem_sweep`` / ``gs_sweep_with_residuals`` — the column-serial
                          Gauss-Seidel sweep (paper Fig. 2 at B = L) through
                          ``kernels.ops.sweep``.  Coarse blocks and the
                          ``"scan"`` sweep are not ported yet and raise.
* ``normalize_theta`` / ``normalize_phi`` — eq. (9) / eq. (10).
* ``map_log_likelihood`` / ``training_perplexity`` — eq. (3)'s data term.

The segment sums (``fold_phi``, ``fold_phi_delta``) accumulate with
``index_put_(accumulate=True)``, which adds duplicates in a fixed order on
the CPU and, through a sort, on CUDA (``index_add_`` uses atomics there):
the same inputs give the same bits on every run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import (
    LDAConfig, LocalState, MinibatchData, SweepPlan, SweepResult,
)
from repro_torch.kernels import ops as kops


def segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(N, K) rows summed into (num_segments, K) by the (N,) segment ids —
    ``jax.ops.segment_sum`` with a fixed accumulation order on every device
    (``index_put_`` with accumulation; no atomics)."""
    out = torch.zeros((num_segments,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return out.index_put_((seg.reshape(-1).long(),), rows, accumulate=True)


# ---------------------------------------------------------------------------
# E-step
# ---------------------------------------------------------------------------

def estep(
    theta_rows: torch.Tensor,    # (D, 1|L, K) θ̂ broadcast over token slots
    phi_rows: torch.Tensor,      # (D, L, K)   φ̂ gathered at each token's word
    phi_tot: torch.Tensor,       # (K,) or broadcastable — φ̂(k)
    cfg: LDAConfig,
    *,
    exclude: Optional[torch.Tensor] = None,  # (D, L, K) counts·μ_old (eq. 13)
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Responsibility update μ_{w,d}(k) — paper eq. (11) (BEM) / eq. (13)
    (IEM).  Returns the *normalized* responsibilities, shape (D, L, K)."""
    W = cfg.W if vocab_size is None else vocab_size
    th, ph, pt = theta_rows, phi_rows, phi_tot
    if exclude is not None:
        th = th - exclude
        ph = ph - exclude
        pt = pt - exclude
    # stats are sums of non-negative terms, but subtraction can leave
    # -1e-7s behind
    th = th.clamp_min(0.0)
    ph = ph.clamp_min(0.0)
    num = (th + cfg.alpha_m1) * (ph + cfg.beta_m1) / (pt + W * cfg.beta_m1)
    return num / num.sum(-1, keepdim=True).clamp_min(1e-30)


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

def _require_fused(cfg: LDAConfig, bucket_len: int,
                   num_blocks: Optional[int] = None) -> None:
    if cfg.resolve_blocks(bucket_len, num_blocks) != bucket_len \
            or cfg.sweep_impl != "fused":
        raise NotImplementedError(
            "the port runs the column-serial fused sweep only (B = L, "
            "sweep_impl='fused'); coarse blocks and the 'scan' sweep are "
            "not ported yet"
        )


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
    """Blocked incremental-EM sweep — paper Fig. 2 at B = L, the only block
    count the port runs: every token column is its own block
    (column-serial Gauss-Seidel, documents vectorized), through the fused
    sweep.  Returns the updated LocalState and the φ̂ *deltas* of this
    sweep, ``(local, Δφ̂_wk, Δφ̂_k)``."""
    _require_fused(cfg, batch.word_ids.shape[1], num_blocks)
    r = gs_sweep_with_residuals(batch, local, phi_wk, phi_k, cfg,
                                vocab_size=vocab_size, as_delta=True)
    return LocalState(mu=r.mu, theta_dk=r.theta), r.phi_wk, r.phi_k


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
        check_indices=check_indices, device=local.mu.device,
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
    phi = normalize_phi(phi_wk, phi_k, cfg, vocab_size=vocab_size)
    rows = gather_phi_rows(phi, batch.word_ids)                # (D, L, K)
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
