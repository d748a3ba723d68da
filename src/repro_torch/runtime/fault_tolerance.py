"""Fault tolerance & straggler mitigation for the streaming EM runtime
(PyTorch port of ``repro.runtime.fault_tolerance``; plain Python and numpy,
the same code as the JAX package's, kept here so that the port imports
nothing of that package).

Two mechanisms, both exploiting stochastic-approximation slack (paper
eq. 19: any valid sufficient-statistics fold improves the bound — *order*
across minibatches is free):

* ``StragglerMonitor`` — tracks per-shard step latencies (EWMA + deviation);
  shards slower than ``threshold × median`` (by at least the absolute
  ``floor_seconds`` margin, and only when ≥ 2 shards report — a lone shard
  or an all-equal fleet has no stragglers by definition) are flagged.  The
  runtime then either (a) re-issues the minibatch elsewhere (restartable
  because the global φ̂ is externalised — paper §3.2), or (b) accepts the
  late delta via the merger below.

* ``BoundedStalenessMerger`` — parks per-shard Δφ̂ contributions and
  releases them in *canonical order* (ascending round, then shard) once a
  round is complete or its age reaches ``max_staleness``.  In
  ``accumulate`` mode (FOEM eq. 33) the fold is commutative+associative
  up to ordering; because release order is canonical and independent of
  *arrival* order, folding the drained deltas is bitwise identical no
  matter how shards raced — staleness costs freshness of the E-step's φ̂
  view, not correctness.  Deltas that arrive after their round released
  are recorded in ``dropped`` and surfaced through ``reissue()`` so the
  runtime can re-run the lost minibatch (bounded retry).

Checkpoint/restart: the ParameterStore's WAL-committed flush
(``core/streaming.py``) and the atomic checkpoints (``checkpoint/ckpt.py``)
persist (stats, data cursor); a killed run resumes at the last cursor —
exercised in tests/test_torch_runtime.py and tests/test_torch_chaos.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ShardStats:
    ewma: float = 0.0
    n: int = 0

    def update(self, dt: float, alpha: float = 0.3) -> None:
        self.ewma = dt if self.n == 0 else (1 - alpha) * self.ewma + alpha * dt
        self.n += 1


class StragglerMonitor:
    """Flags shards whose step latency exceeds ``threshold × median`` EWMA.

    Degenerate-case clamps (they used to make *every* shard a potential
    straggler at thresholds close to 1):

    * fewer than two reporting shards → no stragglers (there is no fleet
      to fall behind);
    * a shard must exceed the median by the absolute ``floor_seconds``
      margin as well — with all-equal (or near-equal) latencies the
      relative test alone flags EWMA jitter at threshold ≈ 1.x.
    """

    def __init__(self, threshold: float = 2.0, warmup_steps: int = 3,
                 floor_seconds: float = 0.05):
        if threshold <= 1.0:
            raise ValueError("threshold must be > 1 (× median)")
        self.threshold = threshold
        self.warmup = warmup_steps
        self.floor_seconds = float(floor_seconds)
        self.stats: Dict[int, ShardStats] = {}

    def record(self, shard: int, seconds: float) -> None:
        self.stats.setdefault(int(shard), ShardStats()).update(float(seconds))

    def forget(self, shard: int) -> None:
        """Drop a shard's history (it died or was resharded away)."""
        self.stats.pop(int(shard), None)

    def median_latency(self) -> float:
        vals = [s.ewma for s in self.stats.values() if s.n >= 1]
        return float(np.median(vals)) if vals else 0.0

    def stragglers(self) -> List[int]:
        if len(self.stats) < 2:
            return []
        med = self.median_latency()
        if med <= 0:
            return []
        return [
            k for k, s in sorted(self.stats.items())
            if s.n >= self.warmup
            and s.ewma > self.threshold * med
            and s.ewma - med > self.floor_seconds
        ]

    def should_reissue(self, shard: int) -> bool:
        return shard in self.stragglers()


class BoundedStalenessMerger:
    """Parks per-shard Δ-statistics and releases them canonically ordered.

    ``submit(shard, round, delta)`` parks a contribution for the round it
    was *issued* for.  ``drain(current_round)`` releases rounds strictly
    in ascending order; round ``r`` releases when

      * every expected shard reported (``expected_shards`` given), or
      * its age ``current_round - r`` reached ``max_staleness`` (waiting
        any longer would exceed the staleness bound anyway).

    Within a round, deltas come out sorted by shard id.  Release order is
    therefore a pure function of *what* was submitted, never of arrival
    interleaving — so the eq. 33 accumulate fold of the drained sequence
    is bitwise identical across arrival orders (tested bitwise).

    A submit for an already-released round is too late: it is recorded in
    ``dropped`` and surfaced once through :meth:`reissue` so the runtime
    re-runs the lost minibatch.
    """

    def __init__(self, max_staleness: int = 1,
                 expected_shards: Optional[int] = None):
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        self.max_staleness = max_staleness
        self.expected_shards = expected_shards
        self.pending: Dict[int, Dict[int, object]] = {}
        self.dropped: List[Tuple[int, int]] = []
        self._reissue_cursor = 0
        self._released_through = -1

    # -------------------------------------------------------------- api

    def submit(self, shard: int, round_idx: int, delta) -> bool:
        """Park a Δ; returns False (and records the drop) when the round
        already released — the contribution exceeded the staleness bound."""
        if round_idx <= self._released_through:
            self.dropped.append((int(shard), int(round_idx)))
            return False
        self.pending.setdefault(int(round_idx), {})[int(shard)] = delta
        return True

    def drain(self, current_round: int) -> List[Tuple[int, int, object]]:
        """Release every round due by ``current_round`` in canonical order.

        Returns ``(shard, round, delta)`` tuples — ascending round, then
        ascending shard — preserving shard attribution for the ledger and
        the re-issue bookkeeping.
        """
        out: List[Tuple[int, int, object]] = []
        while True:
            r = self._released_through + 1
            if r > current_round:
                break
            ready = self.pending.get(r, {})
            complete = (
                self.expected_shards is not None
                and len(ready) >= self.expected_shards
            )
            if not complete and (current_round - r) < self.max_staleness:
                break                      # hold: still within the bound
            for shard in sorted(ready):
                out.append((shard, r, ready[shard]))
            self.pending.pop(r, None)
            self._released_through = r
        return out

    def flush(self) -> List[Tuple[int, int, object]]:
        """Release everything still parked (end-of-stream barrier)."""
        out: List[Tuple[int, int, object]] = []
        for r in sorted(self.pending):
            for shard in sorted(self.pending[r]):
                out.append((shard, r, self.pending[r][shard]))
            self._released_through = max(self._released_through, r)
        self.pending.clear()
        return out

    def reissue(self) -> Iterator[Tuple[int, int]]:
        """Yield each dropped ``(shard, round)`` exactly once — the hook
        the runtime re-enqueues lost minibatches from (bounded retry)."""
        while self._reissue_cursor < len(self.dropped):
            item = self.dropped[self._reissue_cursor]
            self._reissue_cursor += 1
            yield item

    @property
    def num_pending(self) -> int:
        return sum(len(v) for v in self.pending.values())
