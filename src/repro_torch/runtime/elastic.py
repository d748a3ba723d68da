"""Elastic FOEM runtime: straggler-aware, fault-tolerant data-parallel rounds
(PyTorch port of ``repro.runtime.elastic``).

It wires the :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor`
and :class:`~repro_torch.runtime.fault_tolerance.BoundedStalenessMerger` into
the FOEM step, with the seeded :class:`~repro_torch.runtime.faults.FaultPlan`
as the reproducible failure source.

Execution model (a round = one Jacobi super-step over ``num_shards``
logical data shards, run one after another on the runtime's device):

  1. each shard draws a minibatch (retry queue first, then the stream —
     the stream cursor counts every consumed minibatch, the crash-resume
     coordinate);
  2. each shard runs the paper's inner loop (``foem.foem_minibatch``: the
     ``gs_sweep`` and ``scheduled_sweep`` kernels on the card) on its
     minibatch against the *round-start* φ̂ — the bounded-staleness E-step
     view — and publishes a compacted ``(local_vocab, Δrows, Δφ̂(k))``
     delta; its wall-clock is recorded by the ``StragglerMonitor``
     (seeded ``delay`` faults stretch exactly this);
  3. deltas go to the ``BoundedStalenessMerger``; whatever it releases
     (canonical round/shard order) is folded into global φ̂ through
     ``em.fold_phi_delta`` — the eq. 33 accumulate fold, so the final φ̂
     is a pure function of *what* was folded, bitwise independent of
     arrival races;
  4. contributions lost to ``drop`` faults — and merger-dropped
     too-late arrivals surfaced via ``reissue()`` — go back on the retry
     queue with bounded attempts + linear backoff; exhausted minibatches
     land in ``lost`` (the paper's restart unit: lose at most those
     minibatches, never φ̂).

A ``kill`` fault raises :class:`~repro_torch.runtime.faults.InjectedFault`
out of :meth:`run` — state (φ̂, round, cursor) stays consistent and the
killed round's minibatches wait on the retry queue, so a caller
checkpoints, drops the dead shard (:meth:`remove_shard`) and calls
:meth:`run` again: elastic shrink without losing the stream position.

The checkpoint alone is a resume point.  Besides φ̂, φ̂(k), round and
cursor, :meth:`checkpoint_tree` holds the retry queue as ``retry`` rows of
(minibatch index, attempts) and the minibatches given up on as ``lost``.
A fresh process restores it (:meth:`load_checkpoint_tree`) and runs the
stream replayed from its start: the first ``cursor`` minibatches are
skipped, except those the retry queue owes, which go back on it.  The
JAX runtime's tree has neither leaf: the port restores it (as a checkpoint
that owes nothing) through a ``like`` of its four leaves, and the JAX
runtime restores the port's through a ``like`` of all six.

Dense φ̂ (W, K) lives on ``device`` (5.64 GB of float32 at the stream_1k
width).  The topic totals φ̂(k) are a float64 accumulator: a fold adds the
float64 column sum of its Δrows — the exact change of Σ_w φ̂_w, as the
port's trainer does — where the JAX package adds the inner loop's float32
running total, which drifts from its rows (+54 tokens in one dense sweep at
the stream_1k width on an H100).  μ₀ comes from the runtime's
``torch.Generator``, or from ``mu0_fn(minibatch)`` when given (the
cross-package tests inject the JAX runtime's draws).
"""
from __future__ import annotations

import dataclasses
import time
import itertools
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, Iterator, List,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch.core import em, foem
from repro_torch.core.types import GlobalStats, LDAConfig, MinibatchData
from repro_torch.runtime import faults as fault_lib
from repro_torch.runtime.device import Device, resolve_device
from repro_torch.runtime.fault_tolerance import (
    BoundedStalenessMerger,
    StragglerMonitor,
)
from repro_torch.sparse.minibatch import Minibatch


@dataclasses.dataclass
class RoundReport:
    """What one elastic round did — the chaos suite's assertion surface."""

    round_idx: int
    shards_run: List[int]
    folded: int                 # deltas folded into φ̂ this round
    requeued: int               # contributions lost → back on the retry queue
    lost: int                   # minibatches that exhausted their retries
    stragglers: List[int]
    train_ppl: float            # mean of the shard ppls that survived
    seconds: float


class ElasticFOEMRuntime:
    """Data-parallel FOEM over ``num_shards`` logical shards with fault
    tolerance wired end-to-end (see module docstring).

    ``phi_wk`` (W, K) float32 and ``phi_k`` (K,) float64 are the dense
    lifetime sufficient statistics on ``device`` (default ``"cuda"``, which
    raises without a GPU; ``device="cpu"`` runs the plain PyTorch path),
    with ``rho_mode == "accumulate"`` semantics — the merger's
    order-invariance guarantee is exactly the eq. 33 fold's commutativity.
    ``clock`` and ``sleep`` are injectable for deterministic tests;
    ``mu0_fn(minibatch)`` supplies each inner loop's (D, L, K) μ₀ instead of
    the generator seeded with ``seed``.
    """

    def __init__(
        self,
        cfg: LDAConfig,
        *,
        num_shards: int,
        seed: int = 0,
        max_staleness: int = 1,
        max_retries: int = 2,
        backoff_seconds: float = 0.0,
        monitor: Optional[StragglerMonitor] = None,
        merger: Optional[BoundedStalenessMerger] = None,
        faults: Optional[fault_lib.FaultPlan] = None,
        clock: Callable[[], float] = time.perf_counter,
        sleep: Callable[[float], None] = time.sleep,
        mu0_fn: Optional[Callable[[Minibatch], np.ndarray]] = None,
        device: Device = "cuda",
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_shards = int(num_shards)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.mu0_fn = mu0_fn
        self.max_retries = int(max_retries)
        self.backoff_seconds = float(backoff_seconds)
        self.monitor = monitor or StragglerMonitor()
        self.merger = merger or BoundedStalenessMerger(
            max_staleness=max_staleness, expected_shards=num_shards
        )
        self.faults = faults
        self._clock = clock
        self._sleep = sleep

        zeros = GlobalStats.zeros(cfg, device=self.device)
        self.phi_wk = zeros.phi_wk
        self.phi_k = zeros.phi_k.to(torch.float64)  # lint: host-f64
        self.round = 0
        self.cursor = 0                      # minibatches consumed (resume)
        self.lost: List[int] = []            # minibatch indices given up on
        self.reports: List[RoundReport] = []
        # retry queue: (minibatch, attempts-so-far)
        self._retry: Deque[Tuple[Minibatch, int]] = deque()
        # a restored checkpoint's retry queue, (index, attempts), taken back
        # from the replayed stream by the next run (None: no replay due)
        self._owed: Optional[List[Tuple[int, int]]] = None
        # recent round → shard → minibatch, for merger re-issue attribution
        self._issued: Dict[int, Dict[int, Minibatch]] = {}

    # ------------------------------------------------------------- state

    def stats(self) -> GlobalStats:
        return GlobalStats(
            phi_wk=self.phi_wk, phi_k=self.phi_k.to(self.cfg.dtype),
            step=torch.tensor(self.round, dtype=torch.int32,
                              device=self.device),
        )

    def checkpoint_tree(self) -> dict:
        """The crash-resume coordinate: lifetime stats, stream position,
        the retry queue as (minibatch index, attempts) rows in re-issue
        order, and the minibatch indices given up on."""
        retry = [[mb.index, attempts] for mb, attempts in self._retry]
        return {
            "phi_wk": self.phi_wk,
            "phi_k": self.phi_k,
            "round": torch.tensor(self.round, dtype=torch.int32),
            "cursor": torch.tensor(self.cursor, dtype=torch.int32),
            "retry": torch.tensor(retry, dtype=torch.int32).reshape(-1, 2),
            "lost": torch.tensor(self.lost, dtype=torch.int32),
        }

    def load_checkpoint_tree(self, tree: dict) -> None:
        """Adopt a checkpoint tree (numpy arrays or tensors, from either
        package).  The next :meth:`run` takes the stream replayed from its
        start and skips its first ``cursor`` minibatches, taking the ones
        the tree's ``retry`` rows owe back onto the retry queue."""
        def tensor(x) -> torch.Tensor:
            return (x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.asarray(x)))

        self.phi_wk = tensor(tree["phi_wk"]).to(device=self.device,
                                                dtype=torch.float32)
        self.phi_k = tensor(tree["phi_k"]).to(device=self.device,
                                              dtype=torch.float64)  # lint: host-f64
        self.round = int(tree["round"])
        self.cursor = int(tree["cursor"])
        retry = tensor(tree.get("retry", np.zeros((0, 2), np.int32)))
        self._owed = [(int(i), int(a)) for i, a in retry.reshape(-1, 2)]
        self.lost = [int(i) for i in tensor(tree.get(
            "lost", np.zeros(0, np.int32))).reshape(-1)]
        self._retry.clear()

    def _replay(self, it: Iterator[Minibatch]) -> Iterator[Minibatch]:
        """Skip the replayed stream's first ``cursor`` minibatches, putting
        those a restored checkpoint owes back on the retry queue in their
        saved order and attempts; returns the stream from ``cursor`` on."""
        owed = dict(self._owed)
        found: Dict[int, Minibatch] = {}
        for mb in itertools.islice(it, self.cursor):
            if mb.index in owed:
                found[mb.index] = mb
        missing = [i for i, _ in self._owed if i not in found]
        if missing:
            raise ValueError(
                f"the checkpoint owes minibatches {missing}, which the "
                f"stream's first {self.cursor} did not replay: resume with "
                "the stream from its start")
        self._retry.extend((found[i], a) for i, a in self._owed)
        self._owed = None
        return it

    def remove_shard(self, shard: int) -> None:
        """Elastic shrink after a shard death: forget its latency history
        and expect one fewer contribution per round from now on."""
        if self.num_shards <= 1:
            raise ValueError("cannot remove the last shard")
        self.num_shards -= 1
        self.monitor.forget(shard)
        if self.merger.expected_shards is not None:
            self.merger.expected_shards = self.num_shards

    # ----------------------------------------------------------- compute

    def _compute_delta(self, mb: Minibatch):
        """Shard-local inner loop against the round-start φ̂; returns
        ``(local_vocab, delta_rows, delta_k, ppl)`` (compacted Δφ̂, Δφ̂(k)
        the float64 column sum of the rows' Δ)."""
        dev = self.device
        ids = torch.from_numpy(np.asarray(mb.local_vocab, np.int64)).to(dev)
        phi_rows = self.phi_wk[ids]
        batch = MinibatchData(
            word_ids=torch.from_numpy(
                np.asarray(mb.local_word_ids, np.int32)).to(dev),
            counts=torch.from_numpy(np.asarray(mb.counts, np.float32)).to(dev),
        )
        mu0 = self.mu0_fn(mb) if self.mu0_fn is not None else None
        res = foem.foem_minibatch(
            self.generator, batch, phi_rows, self.phi_k.to(self.cfg.dtype),
            self.cfg, vocab_size=self.cfg.W, mu0=mu0, device=dev)
        d_rows = res.phi_wk - phi_rows
        d_k = d_rows.sum(0, dtype=torch.float64)  # lint: host-f64
        return ids, d_rows, d_k, float(res.diag.final_train_ppl)

    def _fold(self, delta) -> None:
        """Eq. 33 accumulate fold of one compacted delta (the
        ``fold_phi_delta`` path)."""
        ids, d_rows, d_k = delta
        self.phi_wk, _ = em.fold_phi_delta(self.phi_wk, self.phi_k, ids,
                                           d_rows)
        self.phi_k = self.phi_k + d_k

    # ------------------------------------------------------------- rounds

    def _requeue(self, mb: Minibatch, attempts: int) -> bool:
        """Bounded retry + linear backoff; returns False when given up."""
        if attempts > self.max_retries:
            self.lost.append(mb.index)
            return False
        if self.backoff_seconds > 0.0:
            self._sleep(self.backoff_seconds * attempts)
        self._retry.append((mb, attempts))
        return True

    def _next_assignments(
        self, it: Iterator[Minibatch]
    ) -> List[Tuple[int, Minibatch, int]]:
        """Fill up to ``num_shards`` slots: retries first, then the stream
        (each stream pull advances the resume cursor)."""
        out: List[Tuple[int, Minibatch, int]] = []
        for shard in range(self.num_shards):
            if self._retry:
                mb, attempts = self._retry.popleft()
                out.append((shard, mb, attempts))
                continue
            try:
                mb = next(it)
            except StopIteration:
                break
            self.cursor += 1
            out.append((shard, mb, 0))
        return out

    def run(
        self,
        stream: Iterable[Minibatch],
        *,
        max_rounds: Optional[int] = None,
    ) -> List[RoundReport]:
        """Drive elastic rounds until the stream (and retry queue) drain.

        Raises :class:`~repro_torch.runtime.faults.InjectedFault` when a
        seeded kill fires; φ̂/round/cursor are consistent at that point, so
        the caller may checkpoint, :meth:`remove_shard` and re-enter with
        the remaining stream.  The first run after
        :meth:`load_checkpoint_tree` takes the stream from its start.
        """
        it = iter(stream)
        if self._owed is not None:
            it = self._replay(it)
        ran = 0
        reports: List[RoundReport] = []
        while max_rounds is None or ran < max_rounds:
            assignments = self._next_assignments(it)
            if not assignments:
                break
            reports.append(self._run_round(assignments))
            ran += 1
        # end of stream: release everything still parked
        if max_rounds is None or ran < max_rounds:
            for _, _, delta in self.merger.flush():
                self._fold(delta)
        return reports

    def _run_round(
        self, assignments: List[Tuple[int, Minibatch, int]]
    ) -> RoundReport:
        r = self.round
        t_round = self._clock()
        ppls: List[float] = []
        requeued = lost = 0
        self._issued[r] = {}
        try:
            self._shard_pass(r, assignments, ppls)
        except fault_lib.InjectedFault:
            # roll the round back: re-park every assigned minibatch (the
            # killed shard's attempt counts against its retry bound) and
            # discard the round's parked deltas — on re-entry after the
            # caller shrinks the fleet, round r re-runs from the start, so
            # the kill loses no minibatch and double-folds nothing.
            self._issued.pop(r, None)
            self.merger.pending.pop(r, None)
            for shard, mb, attempts in assignments:
                self._requeue(mb, attempts + 1)
            raise
        self.round += 1
        released = self.merger.drain(self.round - 1)
        for _, _, delta in released:
            self._fold(delta)
        folded_n = len(released)
        # -- re-issue merger-dropped late arrivals (bounded retry) --
        for shard, rnd in self.merger.reissue():
            mb = self._issued.get(rnd, {}).pop(shard, None)
            if mb is not None:
                if self._requeue(mb, 1):
                    requeued += 1
                else:
                    lost += 1
        # prune the issued ledger past the staleness window
        horizon = self.round - self.merger.max_staleness - 2
        for old in [k for k in self._issued if k < horizon]:
            del self._issued[old]

        # account drops/losses recorded by the shard pass
        requeued += self._round_requeued
        lost += self._round_lost
        report = RoundReport(
            round_idx=r,
            shards_run=[s for s, _, _ in assignments],
            folded=folded_n,
            requeued=requeued,
            lost=lost,
            stragglers=self.monitor.stragglers(),
            train_ppl=float(np.mean(ppls)) if ppls else float("nan"),
            seconds=self._clock() - t_round,
        )
        self.reports.append(report)
        return report

    def _shard_pass(
        self,
        r: int,
        assignments: List[Tuple[int, Minibatch, int]],
        ppls: List[float],
    ) -> None:
        self._round_requeued = self._round_lost = 0
        for shard, mb, attempts in assignments:
            t0 = self._clock()
            survived = True
            if self.faults is not None and self.faults.fire(
                fault_lib.PRE_PROBE, shard=shard, step=r
            ):
                survived = False       # pre-probe drop: nothing computed
            if survived:
                ids, d_rows, d_k, ppl = self._compute_delta(mb)
                if self.faults is not None and self.faults.fire(
                    fault_lib.POST_FOLD, shard=shard, step=r
                ):
                    survived = False   # post-fold drop: Δ discarded
            self.monitor.record(shard, self._clock() - t0)
            if not survived:
                if self._requeue(mb, attempts + 1):
                    self._round_requeued += 1
                else:
                    self._round_lost += 1
                continue
            self._issued[r][shard] = mb
            if not self.merger.submit(shard, r, (ids, d_rows, d_k)):
                continue               # recorded in merger.dropped
            ppls.append(ppl)
