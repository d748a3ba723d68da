"""Residual-based dynamic scheduling — paper §3.1 (PyTorch port of
``repro.core.scheduling``).

This slice carries the active-set selection that serving reuses
(``perplexity.serving_active_topics``); the residual updates and the shift
detector come with the training and lifelong slices.
"""
from __future__ import annotations

import torch


def _top_ids(r: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the ``k`` largest entries along the last axis, the lower id
    first among equal values — ``jax.lax.top_k``'s order.  ``torch.topk``
    promises no order on ties, so this is a stable descending sort.  Ties
    are common: all-equal scheduler rows and all-zero residual rows."""
    return torch.sort(r, dim=-1, descending=True, stable=True).indices[..., :k]


def select_active_topics(
    r_wk: torch.Tensor, active_topics: int, topk_shards: int = 0
) -> torch.Tensor:
    """Top-λ_kK topic ids per vocabulary word: (W_s, K) -> (W_s, A) int32.

    ``r_wk`` is the per-(word, topic) priority — the eq. 36 residual in
    training, the φ mass at serving time.  ``topk_shards > 0`` selects
    A/topk_shards winners within each contiguous K/topk_shards topic group
    instead of a global top-A (shard-local selection for a topic-sharded
    step).
    """
    K = r_wk.shape[1]
    if topk_shards and topk_shards > 1:
        assert K % topk_shards == 0 and active_topics % topk_shards == 0, (
            K, active_topics, topk_shards,
        )
        g = K // topk_shards
        a = active_topics // topk_shards
        idx = _top_ids(r_wk.reshape(-1, topk_shards, g), a)
        offs = (torch.arange(topk_shards, device=r_wk.device) * g)[None, :, None]
        return (idx + offs).reshape(-1, active_topics).to(torch.int32)
    return _top_ids(r_wk, active_topics).to(torch.int32)
