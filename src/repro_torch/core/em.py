"""EM building blocks for LDA (PyTorch port of ``repro.core.em``).

This slice carries what frozen-φ serving needs: the θ̂ fold and the
eq. 9 / eq. 10 normalisations.  The E-step, the φ folds and the sweeps come
with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import LDAConfig


def fold_theta(mu: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """θ̂_d(k) = Σ_w x_{w,d} μ_{w,d}(k)   — (D, L, K) x (D, L) -> (D, K)."""
    return torch.einsum("dlk,dl->dk", mu, counts)


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
