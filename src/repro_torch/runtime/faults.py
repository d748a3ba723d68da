"""Deterministic, seeded fault injection for the FOEM runtime.

The lifelong "big topic modeling on just a PC" claim (paper §3.2) only
matters if a run survives its lifetime, and Cappé's online-EM
stochastic-approximation argument guarantees the algorithm tolerates
exactly the failure modes a long run meets: late folds, lost shards,
re-issued minibatches.  This module makes every one of those modes a
*reproducible test input* instead of an operational anecdote.

A :class:`FaultPlan` is a set of :class:`FaultSpec` entries, each naming

  * an **injection point** — a named host-level boundary the runtime
    fires as it executes (``PRE_PROBE`` before a shard's sweep/compute,
    ``POST_FOLD`` after the local fold before publication, ``MID_FLUSH``
    inside ``ParameterStore.flush`` before the WAL commit, and
    ``PRE_PUBLISH`` before the manifest/checkpoint rename);
  * a **kind** — ``"kill"`` (raise :class:`InjectedFault`, or hard
    ``SIGKILL`` the process for crash-consistency tests), ``"delay"``
    (sleep, the straggler simulator) or ``"drop"`` (the firing site
    discards the shard's contribution — exercises re-issue);
  * a **match** — which step/round and (optionally) which shard.

Plans are deterministic: ``FaultPlan.from_seed(seed, ...)`` draws the
same faults for the same seed forever, and every firing is recorded in
``plan.fired`` so tests can assert exactly which faults a run saw.

Threading: components that own a step loop take the plan explicitly
(``FOEMTrainer(faults=...)``, ``ParameterStore(faults=...)``,
``ElasticFOEMRuntime(faults=...)``).  Code that cannot carry a parameter
(the ``ops.sweep`` dispatch) consults the process-wide plan installed by
:func:`active_plan`; firing is host-side only.

This module must stay dependency-light (numpy + stdlib): it is imported
by the kernel dispatch layer.  It is a copy of ``repro.runtime.faults``
(the port never imports the JAX package); the point names are shared, so a
plan means the same thing to both stores.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# Named injection points — the four host-level boundaries of a FOEM step
# (two-phase sweep entry, local-fold publication, store flush, manifest /
# checkpoint publish) plus the serving tier's replica loop.  Firing an
# unknown point is an error: a typo'd point would silently never inject.
PRE_PROBE = "pre-probe"
POST_FOLD = "post-fold"
MID_FLUSH = "mid-flush"
PRE_PUBLISH = "pre-publish"
#: Fired by a serving replica worker between receiving a batch and
#: launching it (``shard`` = replica id, ``step`` = the worker's batch
#: counter).  A ``hard=True`` kill SIGKILLs the worker process with the
#: batch in flight — the ``ReplicaPool`` re-issue path's test generator;
#: a soft kill raises inside the worker loop (the thread-backend
#: equivalent: the replica dies, the process survives).
REPLICA_KILL = "replica-kill"
POINTS = (PRE_PROBE, POST_FOLD, MID_FLUSH, PRE_PUBLISH, REPLICA_KILL)

KINDS = ("kill", "delay", "drop")

#: Matches any step / round index.
ANY_STEP = -1


class InjectedFault(RuntimeError):
    """A seeded ``kill`` fault fired — the simulated shard/process death.

    Carries the spec and the firing context so drivers can excise exactly
    the failed shard (``elastic`` resume) or re-issue its work.
    """

    def __init__(self, spec: "FaultSpec", point: str,
                 shard: Optional[int], step: Optional[int]):
        self.spec = spec
        self.point = point
        self.shard = shard
        self.step = step
        super().__init__(
            f"injected kill at {point!r} (shard={shard}, step={step})"
        )


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One seeded fault: fire ``kind`` at ``point`` when the match hits.

    ``step == ANY_STEP`` matches every step (the spec then fires on each
    match); a concrete ``step`` makes the spec one-shot.  ``shard=None``
    matches firings from any shard *including* unsharded sites (the
    single-host trainer and the store fire with ``shard=None``).
    ``hard=True`` on a kill sends ``SIGKILL`` to the process instead of
    raising — the crash-consistency tests' true torn-state generator
    (only meaningful inside a sacrificial subprocess).
    """

    point: str
    kind: str
    step: int = ANY_STEP
    shard: Optional[int] = None
    seconds: float = 0.0        # delay duration
    hard: bool = False          # kill: SIGKILL instead of raising

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"expected one of {POINTS}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "delay" and self.seconds <= 0.0:
            raise ValueError("delay faults need seconds > 0")

    def matches(self, point: str, shard: Optional[int],
                step: Optional[int]) -> bool:
        if point != self.point:
            return False
        if self.step != ANY_STEP and step != self.step:
            return False
        if self.shard is not None and shard != self.shard:
            return False
        return True


class FaultPlan:
    """A deterministic set of faults plus the record of what fired.

    ``fire(point, shard=..., step=...)`` is the single runtime hook:

      * matching ``delay`` specs sleep (and record);
      * a matching ``drop`` spec returns ``True`` — the caller must
        discard the shard's contribution for this step;
      * a matching ``kill`` spec raises :class:`InjectedFault` (or
        SIGKILLs the process when ``hard``).

    Concrete-step specs are consumed on firing (one-shot); ``ANY_STEP``
    specs persist.  ``fired`` logs ``(spec, point, shard, step)`` tuples
    in firing order — the reproducibility ledger tests assert against.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.fired: List[Tuple[FaultSpec, str, Optional[int], Optional[int]]] = []
        self._consumed: set = set()
        self._sleep = sleep

    # ------------------------------------------------------------- build

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        num_faults: int,
        max_step: int,
        num_shards: int = 0,
        points: Sequence[str] = POINTS,
        kinds: Sequence[str] = ("kill", "delay", "drop"),
        max_delay: float = 0.02,
    ) -> "FaultPlan":
        """Draw ``num_faults`` faults deterministically from ``seed``.

        Steps are drawn from ``[0, max_step)``, shards from
        ``[0, num_shards)`` (``num_shards == 0`` → unsharded specs).  The
        same arguments and seed produce the identical plan on every
        machine — the chaos suite's entire behaviour keys off one int.
        """
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(num_faults):
            point = str(rng.choice(list(points)))
            kind = str(rng.choice(list(kinds)))
            step = int(rng.integers(0, max(1, max_step)))
            shard = int(rng.integers(0, num_shards)) if num_shards else None
            seconds = float(rng.uniform(0.25, 1.0) * max_delay)
            specs.append(FaultSpec(
                point=point, kind=kind, step=step, shard=shard,
                seconds=seconds if kind == "delay" else 0.0,
            ))
        return cls(specs, seed=seed)

    # -------------------------------------------------------------- fire

    def fire(self, point: str, *, shard: Optional[int] = None,
             step: Optional[int] = None) -> bool:
        """Consult the plan at an injection point; returns ``True`` when a
        ``drop`` fault matched (the caller discards this contribution)."""
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        drop = False
        for i, spec in enumerate(self.specs):
            if i in self._consumed or not spec.matches(point, shard, step):
                continue
            if spec.step != ANY_STEP:
                self._consumed.add(i)
            self.fired.append((spec, point, shard, step))
            if spec.kind == "delay":
                self._sleep(spec.seconds)
            elif spec.kind == "drop":
                drop = True
            elif spec.kind == "kill":
                if spec.hard:
                    os.kill(os.getpid(), signal.SIGKILL)
                raise InjectedFault(spec, point, shard, step)
        return drop

    # ----------------------------------------------------------- ledger

    def fired_log(self) -> List[Tuple[str, str, Optional[int], Optional[int]]]:
        """Comparable firing ledger: ``(kind, point, shard, step)``."""
        return [(s.kind, p, sh, st) for s, p, sh, st in self.fired]

    def reset(self) -> None:
        """Clear consumption + ledger (replay the plan from scratch)."""
        self.fired.clear()
        self._consumed.clear()


# ---------------------------------------------------------------------------
# Process-wide plan — for firing sites that cannot carry a parameter
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def get_active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def active_plan(plan: Optional[FaultPlan]):
    """Install ``plan`` as the process-wide fault plan for the block.

    The ``ops.sweep``/``ops.infer`` dispatch fires ``PRE_PROBE`` against
    the active plan on *eager* (untraced) calls; components that take a
    ``faults=`` parameter ignore the active plan.
    """
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def fire_active(point: str, *, shard: Optional[int] = None,
                step: Optional[int] = None) -> bool:
    """Fire against the process-wide plan (no-op without one)."""
    if _ACTIVE is None:
        return False
    return _ACTIVE.fire(point, shard=shard, step=step)
