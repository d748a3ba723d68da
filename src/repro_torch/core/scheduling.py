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
set, and with it the rest of the minibatch.

:class:`ShiftDetector` watches a lifelong stream's per-step signals (the
eq. 36 residual mass, the train perplexity, the φ(k) shares) on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Topic-shift detection — lifelong-stream drift over eq. 36 / eq. 21 signals
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShiftEvent:
    """One detected stream event, surfaced through ``StepMetrics``."""

    step: int
    kind: str        # "residual-shift" | "ppl-shift" | "topic-birth" | "topic-death"
    value: float     # signal magnitude (deviation, share, ...)
    topic: int = -1  # topic id for birth/death events


class ShiftDetector:
    """EWMA drift detector over the trainer's per-step stream signals.

    Lifelong streams are non-stationary: when the document distribution
    shifts, the eq. 36 replacement-residual mass (how much of μ the sweep
    rewrote) and the train perplexity both jump relative to their recent
    history.  This detector keeps an exponentially weighted mean and
    mean-absolute-deviation per signal; a point farther than
    ``threshold × dev`` from the mean (after ``warmup`` observations) fires
    a shift event and re-arms the estimator at the new level.  A fired
    shift latches ``consume_refresh()`` so the trainer can grant the next
    step extra warm-up (full, unscheduled) sweeps — the Fig. 4 residual
    re-initialisation applied mid-stream instead of only at t = 0.

    Topic birth/death tracks the normalized φ_k mass shares: a topic whose
    share crosses ``topic_floor_frac / K`` (a fraction of the uniform
    share) in either direction emits one event at the crossing.

    Host Python only, single writer: ``update`` is called from the trainer
    thread alone (there is no internal locking).
    """

    def __init__(self, *, alpha: float = 0.25, threshold: float = 6.0,
                 warmup: int = 8, topic_floor_frac: float = 0.05):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.topic_floor_frac = float(topic_floor_frac)
        self._sig: dict = {}          # name -> [ewma_mean, ewma_dev, n_obs]
        self._alive = None            # (K,) bool from the last update
        self._refresh = False
        self.events: list = []        # full event history, oldest first

    def _drift(self, name: str, x: float, step: int) -> Optional[ShiftEvent]:
        st = self._sig.setdefault(name, [0.0, 0.0, 0])
        mean, dev, n = st
        if n == 0:
            st[:] = [x, 0.0, 1]
            return None
        d = abs(x - mean)
        if n >= self.warmup and d > self.threshold * max(dev, 1e-12):
            # re-arm at the new level; keep dev so a noisy regime doesn't
            # look calm the moment after a shift
            st[:] = [x, dev, 1]
            return ShiftEvent(step=step, kind=f"{name}-shift", value=d)
        st[0] = mean + self.alpha * (x - mean)
        st[1] = dev + self.alpha * (d - dev)
        st[2] = n + 1
        return None

    def update(self, *, step: int, residual_mass: float = float("nan"),
               perplexity: float = float("nan"), phi_k=None) -> list:
        """Feed one trainer step's signals; returns the events it fired."""
        evs = []
        if residual_mass == residual_mass:        # not NaN
            ev = self._drift("residual", float(residual_mass), step)
            if ev is not None:
                evs.append(ev)
        if perplexity == perplexity:
            ev = self._drift("ppl", float(perplexity), step)
            if ev is not None:
                evs.append(ev)
        if phi_k is not None:
            pk = np.asarray(phi_k, np.float64)    # lint: host-f64
            tot = pk.sum()
            if tot > 0:
                shares = pk / tot
                floor = self.topic_floor_frac / len(pk)
                alive = shares >= floor
                if self._alive is not None:
                    for k in np.flatnonzero(alive & ~self._alive):
                        evs.append(ShiftEvent(step=step, kind="topic-birth",
                                              value=float(shares[k]),
                                              topic=int(k)))
                    for k in np.flatnonzero(self._alive & ~alive):
                        evs.append(ShiftEvent(step=step, kind="topic-death",
                                              value=float(shares[k]),
                                              topic=int(k)))
                self._alive = alive
        if any(ev.kind.endswith("-shift") for ev in evs):
            self._refresh = True
        self.events.extend(evs)
        return evs

    def consume_refresh(self) -> bool:
        """Latched 'grant extra warm-up sweeps' flag; cleared on read."""
        out = self._refresh
        self._refresh = False
        return out
