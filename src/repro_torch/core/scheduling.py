"""Residual-based dynamic scheduling — paper §3.1 (PyTorch port of
``repro.core.scheduling``).

The paper keeps, per vocabulary word w, accumulated responsibility residuals
    r_w(k) = Σ_d x_{w,d} |μ^t_{w,d}(k) − μ^{t−1}_{w,d}(k)|      (eq. 36)
    r_w    = Σ_k r_w(k)                                          (eq. 37)
and each inner sweep updates only the λ_k·K topics with the largest r_w(k)
(per word) and the λ_w·W_s words with the largest r_w.  Inactive entries keep
their previous residual estimate (priority-queue semantics); active entries
are *replaced* with the freshly measured residual.  The partial
renormalisation (eq. 38) preserves the inactive topics' mass.

The residual segment sums go through ``gs_sweep.segment_sum``, whose order is
fixed on every device: a flipped last bit in r_w(k) could change an active
set, and with it the rest of the minibatch.  The topic-shift detector comes
with the lifelong slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import LDAConfig, SchedulerState
from repro_torch.kernels.gs_sweep import scatter_add_pairs, segment_sum


#: Entries per sort call in ``_top_ids``: a whole (W, K/mp) residual slice
#: at the stream_1k width (3.5·10⁸ entries) would take 4 GB of sort output.
SORT_BLOCK = 1 << 24


def _top_ids(r: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the ``k`` largest entries along the last axis, the lower id
    first among equal values — ``jax.lax.top_k``'s order.  ``torch.topk``
    promises no order on ties, so this is a stable descending sort.  Ties
    are common: all-equal scheduler rows and all-zero residual rows.  Rows
    are sorted ``SORT_BLOCK`` entries at a time."""
    if r.ndim > 1 and r.numel() > SORT_BLOCK:
        rows = max(1, SORT_BLOCK // (r.numel() // r.shape[0]))
        return torch.cat([_top_ids(r[i:i + rows], k)
                          for i in range(0, r.shape[0], rows)])
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


def init_scheduler(num_words: int, cfg: LDAConfig,
                   device="cpu") -> SchedulerState:
    """Fresh residual state; +inf-like init so every entry is visited once."""
    big = torch.full((num_words, cfg.K), torch.finfo(cfg.dtype).max / 4,
                     dtype=cfg.dtype, device=device)
    return SchedulerState(r_wk=big, r_w=big.sum(-1))


def select_active_words_threshold(sched: SchedulerState,
                                  frac: float) -> torch.Tensor:
    """Residual threshold t such that ~frac·W_s words satisfy r_w >= t.

    Returned as a scalar tensor; tokens are masked by ``r_w[word_id] >= t``.
    With frac == 1.0 the threshold is -inf (all words active).
    """
    if frac >= 1.0:
        return torch.tensor(float("-inf"), dtype=sched.r_w.dtype,
                            device=sched.r_w.device)
    n = sched.r_w.shape[0]
    k = max(1, int(round(frac * n)))
    return torch.topk(sched.r_w, k).values[-1]


def sparse_estep_renorm(
    mu_active_new: torch.Tensor,   # (D, L, A) unnormalised responsibilities
    mu_prev_active: torch.Tensor,  # (D, L, A) previous *normalised* μ on A
) -> torch.Tensor:
    """eq. (38): renormalise over the active set, preserving inactive mass."""
    prev_mass = mu_prev_active.sum(-1, keepdim=True)
    new_sum = mu_active_new.sum(-1, keepdim=True).clamp_min(1e-30)
    return mu_active_new / new_sum * prev_mass


def update_residuals(
    sched: SchedulerState,
    delta_r_wk: torch.Tensor,   # (W_s, K) freshly measured Σ_d x|Δμ|
    touched_wk: torch.Tensor,   # (W_s, K) bool — updated this sweep
) -> SchedulerState:
    """Replace residuals for touched entries, keep estimates elsewhere."""
    r_wk = torch.where(touched_wk, delta_r_wk, sched.r_wk)
    return SchedulerState(r_wk=r_wk, r_w=r_wk.sum(-1))


def scatter_residuals(
    abs_delta: torch.Tensor,   # (D, L, A) x|Δμ| per token over its active topics
    word_ids: torch.Tensor,    # (D, L)
    topic_ids: torch.Tensor,   # (D, L, A) the active topic ids per token
    num_words: int,
    num_topics: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate eq. (36) residuals into (W_s, K); also return the touched
    mask.  A 2-D (word, topic) scatter with a fixed accumulation order."""
    widx = word_ids[..., None].expand(topic_ids.shape).reshape(-1).long()
    tidx = topic_ids.reshape(-1).long()
    summed = torch.zeros((num_words, num_topics), dtype=abs_delta.dtype,
                         device=abs_delta.device)
    scatter_add_pairs(summed, widx, tidx, abs_delta)
    touched = torch.zeros((num_words, num_topics), dtype=torch.bool,
                          device=abs_delta.device)
    touched[widx, tidx] = True
    return summed, touched


def scheduler_update_from_sweep(
    sched: SchedulerState,
    residual: torch.Tensor,     # (D, L, K) counts·|Δμ| emitted by the sweep
    word_ids: torch.Tensor,     # (D, L)
    word_topics: torch.Tensor,  # (W_s, A) the active topic ids per word
) -> SchedulerState:
    """Replace-touched residual refresh from a scheduled sweep.

    The scheduled sweep emits the eq. 36 replacement values full-K (zeros
    off each token's active set), so the refresh is ONE segment sum over the
    vocab axis — equal to ``scatter_residuals`` + ``update_residuals`` on
    the compact (D, L, A) values.  The touched mask is per word: the batch's
    words, each with its active set.
    """
    D, L, K = residual.shape
    num_words = sched.r_wk.shape[0]
    r_meas = segment_sum(residual.reshape(D * L, K), word_ids, num_words)
    present = torch.zeros((num_words,), dtype=torch.bool,
                          device=residual.device)
    present[word_ids.reshape(-1).long()] = True
    active = torch.zeros((num_words, K), dtype=torch.bool,
                         device=residual.device)
    active.scatter_(1, word_topics.long(), True)
    return update_residuals(sched, r_meas, active & present[:, None])


def residuals_from_sweep(
    residual: torch.Tensor,    # (D, L, K) counts·|Δμ| emitted by the sweep
    word_ids: torch.Tensor,    # (D, L)
    num_words: int,
) -> SchedulerState:
    """Build the residual state from a sweep's emitted residuals (the
    post-warm-up init: one segment sum, no re-measurement pass)."""
    D, L, K = residual.shape
    r_wk = segment_sum(residual.reshape(D * L, K), word_ids, num_words)
    return SchedulerState(r_wk=r_wk, r_w=r_wk.sum(-1))


def full_sweep_residuals(
    mu_new: torch.Tensor,      # (D, L, K)
    mu_old: torch.Tensor,      # (D, L, K)
    counts: torch.Tensor,      # (D, L)
    word_ids: torch.Tensor,    # (D, L)
    num_words: int,
) -> SchedulerState:
    """Residual init after a full (unscheduled) sweep — paper Fig. 4 —
    measuring counts·|Δμ| post hoc (one (D, L, K) temporary)."""
    return residuals_from_sweep(
        (mu_new - mu_old).abs_().mul_(counts[..., None]), word_ids,
        num_words)
