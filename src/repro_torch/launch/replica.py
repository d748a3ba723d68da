"""Multi-replica data-parallel serving: a :class:`ReplicaPool` of N serving
workers behind one admission router (PyTorch port of
``repro.launch.replica``).

The single-replica engine (``serve.ServingEngine``) is capped by one
launcher thread; the pool scales the same frozen-φ model over data-parallel
workers, and placement is free: per-document θ̂₀ seeds and a pinned φ
snapshot make replica assignment semantically invisible — the same
document resolves to the bitwise-identical θ̂ on any replica (at
``rel_tol = 0``; see ``serve.pad_batch`` for the ``rel_tol > 0`` caveat).

::

    submit() ──► AdmissionRouter (slots by L bucket + deadline collector)
                     │ dispatcher thread: least-loaded pick under the
                     │ per-replica in-flight cap (ReplicaBalancer)
                     ▼
       per-replica task queues ──► N replica workers
         "process" backend: one spawned process per replica, its own
           TopicServer (own CUDA context) over a READONLY store attach
         "thread" backend: one thread per replica, replica r on
           cuda:{r mod device count}
                     │ shared result queue
                     ▼
       results thread resolves futures (ThetaResult.version intact)

Every worker launches as the engine's launcher does: θ̂₀ from the padded
batch's per-document seeds through ``serve.document_theta0``, then
``TopicServer.infer(w, c, theta0=...)`` — the ``theta_sweep`` kernel on the
card — so a pool's answers equal the single engine's bitwise at
``rel_tol = 0``.  Process workers report their ``theta_sweep`` launches
with each result.  Workers are started with the ``spawn`` method (a forked
child would inherit the parent's CUDA context), after the parent has
built the kernels, so that workers only load them.  Several processes on
one card each hold a CUDA context and their kernels time-slice.

Fault handling: a seeded :class:`~repro_torch.runtime.faults.FaultPlan`
in a worker fires the ``REPLICA_KILL`` point between receiving a batch and
launching it (``hard=True`` SIGKILLs the worker mid-flight).  The monitor
thread detects the loss, re-issues the dead worker's in-flight batches —
the *identical padded arrays*, so re-issued results match an unfaulted run
bitwise — and respawns the worker; a respawned worker does not
replay the seeded kill, and takes batches only once it is ready (the JAX
pool queues them at the respawn while it starts), so the survivors serve
the orphans at once.  A worker that dies before it is ready is not
respawned.  No submitted Future is ever dropped.

Hot-swaps stay version-consistent across replicas: the pool subscribes
every worker to a :class:`~repro_torch.core.SnapshotPublisher` by
broadcasting each published snapshot (full payload + crc manifest) through
the task queues; responses carry ``ThetaResult.version``, and pool-level
``max_staleness_versions`` is the max over replicas' launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import multiprocessing.connection as mp_connection
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.streaming import ParameterStore, PhiSnapshot
from repro_torch.core.types import LDAConfig
from repro_torch.kernels.theta_sweep import theta_sweep
from repro_torch.launch.serve import (
    AdmissionRouter,
    TopicServer,
    document_theta0,
    pad_batch,
    prewarm_server,
)
from repro_torch.runtime import faults as fault_lib
from repro_torch.runtime.device import Device, resolve_device


class ReplicaBalancer:
    """Pure least-loaded dispatch accounting — no threads, no I/O.

    The pool's dispatcher drives one instance under its own lock; the
    property tests drive it directly with arbitrary interleavings of add /
    acquire / complete / remove / version notes.

    Invariants (raised on violation, never silently repaired):

    * per-replica in-flight count never goes negative — completing an
      idle replica raises;
    * :meth:`acquire` only returns a replica strictly under ``cap``, and
      always a least-loaded one (ties break to the smallest id);
    * per-replica φ version notes are monotone — a replica reporting an
      older version than it already served is a protocol violation.
    """

    def __init__(self, cap: int = 2):
        if cap < 1:
            raise ValueError("per-replica in-flight cap must be >= 1")
        self.cap = int(cap)
        self._inflight: Dict[int, int] = {}
        self._version: Dict[int, int] = {}

    # -------------------------------------------------------- membership

    def add(self, rid: int) -> None:
        if rid in self._inflight:
            raise ValueError(f"replica {rid} already registered")
        self._inflight[rid] = 0
        # a respawned rid keeps its version floor: the replacement is
        # sent the latest snapshot first, so monotonicity still holds
        self._version.setdefault(rid, -1)

    def remove(self, rid: int) -> int:
        """Deregister a (dead) replica; returns the in-flight count it
        held — the orphans the pool must re-issue."""
        return self._inflight.pop(rid)

    def replicas(self) -> List[int]:
        return sorted(self._inflight)

    # ---------------------------------------------------------- dispatch

    def acquire(self) -> Optional[int]:
        """Least-loaded replica strictly under the cap (ties -> smallest
        id), with its in-flight count bumped; ``None`` when every replica
        is at the cap (the caller waits for a completion)."""
        free = [(n, rid) for rid, n in self._inflight.items()
                if n < self.cap]
        if not free:
            return None
        _, rid = min(free)
        self._inflight[rid] += 1
        return rid

    def acquire_specific(self, rid: int) -> bool:
        """Pin-path acquire: bump ``rid`` iff it is registered and under
        the cap (the placement-parity tests force placement with this)."""
        if self._inflight.get(rid, self.cap) >= self.cap:
            return False
        self._inflight[rid] += 1
        return True

    def complete(self, rid: int) -> None:
        if rid not in self._inflight:
            raise KeyError(f"completion for unregistered replica {rid}")
        if self._inflight[rid] <= 0:
            raise ValueError(
                f"replica {rid} completion with zero in-flight — "
                "accounting would go negative"
            )
        self._inflight[rid] -= 1

    def inflight(self, rid: int) -> int:
        return self._inflight[rid]

    def total_inflight(self) -> int:
        return sum(self._inflight.values())

    # ---------------------------------------------------------- versions

    def note_version(self, rid: int, version: int) -> None:
        old = self._version.get(rid, -1)
        if version < old:
            raise ValueError(
                f"replica {rid} φ version moved backwards "
                f"({old} -> {version}); hot-swaps must be monotone"
            )
        self._version[rid] = version

    def versions(self) -> Dict[int, int]:
        return {rid: self._version.get(rid, -1) for rid in self._inflight}

    def min_version(self) -> int:
        if not self._inflight:
            return -1
        return min(self._version.get(rid, -1) for rid in self._inflight)


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Everything a worker process needs to rebuild its serving stack.

    Picklable and shipped once at spawn.  The worker attaches the trained
    store READONLY (:meth:`ParameterStore.attach`) — serving processes never
    write through the store; φ updates arrive via the snapshot broadcast.
    ``device`` is where the worker's ``TopicServer`` runs (default
    ``"cuda"``: a pool over it raises without a GPU; ``"cpu"`` runs the
    plain PyTorch path); an unindexed ``"cuda"`` puts replica ``r`` on
    ``cuda:{r mod device count}``.

    ``fault_specs`` seed a per-worker :class:`FaultPlan` that fires the
    ``REPLICA_KILL`` point (``shard`` = replica id, ``step`` = the worker's
    batch counter) between receiving a batch and launching it.
    """

    store_path: str
    cfg: LDAConfig
    vocab_capacity: int
    fit_sweeps: int = 50
    rel_tol: Optional[float] = None
    check_every: Optional[int] = None
    active_topics: int = 0
    vocab_pad: int = 512
    phi_dtype: str = "float32"
    hot_rows: int = 0
    buffer_rows: int = 0
    fault_specs: Tuple[fault_lib.FaultSpec, ...] = ()
    device: str = "cuda"

    def build_server(self, device: Optional[Device] = None) -> TopicServer:
        """The worker's ``TopicServer`` on ``device`` (default: the
        spec's) over a readonly attach of the store."""
        store = ParameterStore.attach(
            self.store_path, num_topics=self.cfg.num_topics,
            vocab_capacity=self.vocab_capacity,
            buffer_rows=self.buffer_rows,
        )
        return TopicServer(
            store, self.cfg, self.fit_sweeps,
            rel_tol=self.rel_tol, check_every=self.check_every,
            active_topics=self.active_topics, vocab_pad=self.vocab_pad,
            phi_dtype=self.phi_dtype, hot_rows=self.hot_rows,
            device=self.device if device is None else device,
        )


def snapshot_payload(snap: PhiSnapshot) -> dict:
    """Pickle-ready swap broadcast: the full φ epoch + its crc manifest.

    The worker rebuilds a :class:`PhiSnapshot` from these arrays and
    compares the recomputed crc against the publisher's — corruption
    crossing the process boundary fails loudly instead of serving garbage
    (the same contract ``TopicServer.refresh`` enforces in-process).
    """
    return {
        "version": snap.version,
        "phi": np.asarray(snap.phi),
        "phi_k": np.asarray(snap.phi_k),
        "step": snap.step,
        "live_vocab": snap.live_vocab,
        "write_version": snap.write_version,
        "flush_version": snap.flush_version,
        "changed_ids": np.asarray(snap.changed_ids),
        "crc": snap.crc,
    }


class _SwapMailbox:
    """A one-snapshot ``SnapshotPublisher`` stand-in inside a replica.

    ``TopicServer.subscribe``/``refresh`` need ``latest()``, ``get()`` and
    ``version``; the parent's swap broadcast fills the box.  Because the
    task queue is FIFO, every batch enqueued after a swap broadcast is
    served on (at least) that version — the pool-wide staleness bound.
    """

    def __init__(self):
        self._snap: Optional[PhiSnapshot] = None
        self.version = 0

    def install(self, payload: dict) -> PhiSnapshot:
        snap = PhiSnapshot(
            version=payload["version"], phi=payload["phi"],
            phi_k=payload["phi_k"], step=payload["step"],
            live_vocab=payload["live_vocab"],
            write_version=payload["write_version"],
            flush_version=payload["flush_version"],
            changed_ids=payload["changed_ids"],
        )
        if snap.crc != payload["crc"]:
            raise RuntimeError(
                f"φ snapshot v{snap.version} failed its crc manifest "
                "crossing the process boundary — refusing to install"
            )
        self._snap = snap
        self.version = snap.version
        return snap

    def latest(self) -> Optional[PhiSnapshot]:
        return self._snap

    def get(self, version: int) -> Optional[PhiSnapshot]:
        """The held snapshot if it is ``version`` (skipped versions were
        never held: the server then drops its whole cache on the swap)."""
        snap = self._snap
        return snap if snap is not None and snap.version == version else None


def _serve_loop(rid: int, server: TopicServer, mailbox: _SwapMailbox,
                plan: Optional[fault_lib.FaultPlan], task_q, result_q,
                count_launches: bool = False) -> None:
    """The replica message loop — identical for both backends.

    Messages in: ``("swap", payload)``, ``("prewarm", dims)``,
    ``("batch", batch_id, L, w, c, seeds, filled)``, ``("stop",)``.
    Messages out: ``("ready"|"swapped"|"prewarmed"|"done"|"error"|
    "fault"|"bye", rid, ...)``; ``"done"`` carries the batch's
    ``theta_sweep`` launches when ``count_launches`` (a process worker:
    the counter is its own), else ``None``.

    A ``hard=True`` kill at ``REPLICA_KILL`` SIGKILLs the process with the
    batch in flight — it is never acked, and the parent re-issues it.  A
    soft kill raises :class:`InjectedFault` here: the replica reports and
    exits its loop (the thread-backend equivalent of dying).
    """
    dev = server.device
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        n_batches = 0
        result_q.put(("ready", rid))
        while True:
            msg = task_q.get()
            kind = msg[0]
            if kind == "stop":
                result_q.put(("bye", rid))
                return
            if kind == "swap":
                try:
                    mailbox.install(msg[1])
                    server.refresh()        # between batches by FIFO order
                except Exception as e:      # a refused payload: keep serving
                    result_q.put(("swap_error", rid, msg[1]["version"],
                                  repr(e)))
                    continue
                result_q.put(("swapped", rid, mailbox.version))
                continue
            if kind == "prewarm":
                n = prewarm_server(server, **msg[1])
                result_q.put(("prewarmed", rid, n))
                continue
            _, batch_id, L, w, c, seeds, filled = msg
            try:
                if plan is not None:
                    plan.fire(fault_lib.REPLICA_KILL, shard=rid,
                              step=n_batches)
                n_batches += 1
                t0 = time.perf_counter()
                n0 = theta_sweep.launches
                theta0 = document_theta0(seeds, c, server.cfg, device=dev)
                theta = server.infer(w, c, theta0=theta0)
                version = server.last_version
                secs = time.perf_counter() - t0
                launches = (theta_sweep.launches - n0 if count_launches
                            else None)
                cache = server.hot_cache
                cw = cache.window_stats() if cache is not None else None
                result_q.put((
                    "done", rid, batch_id, np.asarray(theta[:filled]),
                    version, secs,
                    cw.hits if cw else 0, cw.misses if cw else 0, launches,
                ))
            except fault_lib.InjectedFault as e:
                result_q.put(("fault", rid, str(e)))
                return                            # soft replica death
            except Exception as e:                # deterministic failure:
                result_q.put(("error", rid, batch_id, repr(e)))  # no retry


class _PipeSender:
    """A worker's end of its own result pipe.  ``put`` sends one message
    from the serve loop's thread, the pipe's only writer: no feeder thread
    and no lock shared with other workers, so a worker killed mid-message
    can tear only its own pipe, which the pool drops at its end of file."""

    def __init__(self, conn):
        self.conn = conn

    def put(self, msg) -> None:
        self.conn.send(msg)


def _replica_worker(rid: int, spec: ReplicaSpec, device: str, threads: int,
                    task_q, result_conn) -> None:
    """Process-backend entry point (module-level for the spawn context).
    A CPU worker takes ``threads`` intra-op threads, its share of the
    host's cores."""
    result_q = _PipeSender(result_conn)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    try:
        server = spec.build_server(device=device)
    except BaseException as e:
        result_q.put(("error", rid, -1, repr(e)))
        raise
    mailbox = _SwapMailbox()
    server.subscribe(mailbox, refresh=False)
    plan = (fault_lib.FaultPlan(spec.fault_specs)
            if spec.fault_specs else None)
    _serve_loop(rid, server, mailbox, plan, task_q, result_q,
                count_launches=True)


class _ProcessReplica:
    """Handle on one spawned worker process, its task queue and the read
    end of its result pipe (``results``)."""

    backend = "process"

    def __init__(self, rid: int, spec: ReplicaSpec, device: str,
                 threads: int, ctx):
        self.rid = rid
        self.task_q = ctx.Queue()
        self.results, writer = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(
            target=_replica_worker,
            args=(rid, spec, device, threads, self.task_q, writer),
            name=f"replica-{rid}", daemon=True,
        )
        self.proc.start()
        writer.close()            # the worker holds the only write end

    def send(self, msg) -> None:
        self.task_q.put(msg)

    def discard(self) -> None:
        """Drop the task queue without waiting for its feeder thread: a
        dead worker never reads what is still queued for it."""
        self.task_q.cancel_join_thread()
        self.task_q.close()

    def alive(self) -> bool:
        return self.proc.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self.proc.join(timeout)

    def kill(self) -> None:
        self.proc.kill()

    @property
    def exitcode(self):
        return self.proc.exitcode


class _ThreadReplica:
    """Handle on one in-process replica thread."""

    backend = "thread"

    def __init__(self, rid: int, server: TopicServer,
                 plan: Optional[fault_lib.FaultPlan], result_q):
        self.rid = rid
        self.task_q: "queue.Queue" = queue.Queue()
        mailbox = _SwapMailbox()
        server.subscribe(mailbox, refresh=False)
        self.thread = threading.Thread(
            target=_serve_loop,
            args=(rid, server, mailbox, plan, self.task_q, result_q),
            name=f"replica-{rid}", daemon=True,
        )
        self.thread.start()

    def send(self, msg) -> None:
        self.task_q.put(msg)

    def alive(self) -> bool:
        return self.thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self.thread.join(timeout)

    def kill(self) -> None:
        pass                                  # threads die via soft faults

    def discard(self) -> None:
        pass

    @property
    def exitcode(self):
        return None


class ReplicaPool:
    """N serving replicas behind one :class:`AdmissionRouter`.

    ``submit`` / ``drain`` / ``metrics`` / ``close`` mirror the
    single-replica :class:`ServingEngine` surface, so callers swap between
    them freely.  See the module docstring for the thread and fault
    architecture.

    Parameters beyond the router's: ``backend`` ("process" spawns one
    worker process per replica; "thread" runs in-process replicas, each
    building its server from the spec) and ``max_inflight`` (per-replica
    dispatch cap — the balancer's least-loaded window).  The spec's device
    (default ``"cuda"``) is resolved here, before any worker starts:
    without a GPU the pool raises.

    Every message to a worker is sent under the state lock, by the thread
    that found the worker's handle registered there; the monitor removes
    a dead worker's handle and closes its task queue under the same lock.
    So no send ever meets a closed queue, and a batch sent to a worker
    that dies is in the in-flight map when the monitor collects its
    orphans.

    Records for the measurements: ``deaths`` (one dict a lost worker),
    ``ready_log`` (``{rid, seconds, respawn}``: spawn to ready),
    ``swap_acks`` (``{rid, version, seconds}``: broadcast to a worker's
    ack), ``swap_errors`` (refused payloads).
    """

    def __init__(self, spec: ReplicaSpec, *,
                 replicas: int = 2, backend: str = "process",
                 max_batch: int = 64, bucket_multiple: int = 16,
                 max_delay_ms: float = 5.0, max_len: int = 256,
                 queue_depth: int = 4, seed: int = 0,
                 max_inflight: int = 2):
        if backend not in ("process", "thread"):
            raise ValueError(f"unknown replica backend {backend!r}")
        if spec is None:
            raise ValueError("a replica pool needs a ReplicaSpec")
        self._device = resolve_device(spec.device)
        self.spec = spec
        self.backend = backend
        self._size = max(1, int(replicas))
        self.router = AdmissionRouter(
            max_batch=max_batch, bucket_multiple=bucket_multiple,
            max_delay_ms=max_delay_ms, max_len=max_len,
            queue_depth=queue_depth, seed=seed,
        )
        self.balancer = ReplicaBalancer(cap=max_inflight)
        #: test hook — force every dispatch onto one replica id (the
        #: placement-parity tests compare pinned placements bitwise)
        self.pin_replica: Optional[int] = None
        self.respawns = 0
        self.deaths: List[dict] = []
        self.ready_log: List[dict] = []
        self.swap_acks: List[dict] = []
        self.swap_errors: List[dict] = []
        self._soft_faults: Dict[int, str] = {}  # rid -> injected-fault detail
        self._start_errors: Dict[int, str] = {}  # rid -> server build error
        self._failed_start: Dict[int, str] = {}  # rid -> why it never ran
        self._state_lock = threading.Lock()
        self._state_cond = threading.Condition(self._state_lock)
        self._replicas: Dict[int, object] = {}
        self._inflight: Dict[int, dict] = {}   # batch_id -> dispatch info
        self._dispatched: Dict[int, int] = {}  # rid -> batches sent
        self._next_batch_id = 0
        self._ready: set = set()
        self._spawned_at: Dict[int, Tuple[float, bool]] = {}
        self._prewarm_acks = 0
        self._publisher = None
        self._watcher: Optional[threading.Thread] = None
        self._last_swap: Optional[dict] = None
        self._swap_version = 0
        self._swap_sent: Dict[int, float] = {}  # version -> broadcast time
        self._closing = False
        self._closed = False
        self._close_lock = threading.Lock()
        self._results_stop = threading.Event()
        self._monitor_stop = threading.Event()

        # process workers each write their own result pipe (``_readers``,
        # read end → rid); thread workers share one in-process queue
        self._readers: Dict[object, int] = {}
        if backend == "process":
            if self._device.type == "cuda":
                # workers load the libraries; they never race a build
                from repro_torch.kernels import build
                build.build(["theta_sweep"])
            self._ctx = multiprocessing.get_context("spawn")
            self._result_q = None
        else:
            self._ctx = None
            self._result_q = queue.Queue()

        with self._state_cond:
            for rid in range(int(replicas)):
                self._replicas[rid] = self._spawn(rid)
                self.balancer.add(rid)
                self._dispatched[rid] = 0

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="pool-dispatcher", daemon=True)
        self._results = threading.Thread(
            target=self._results_loop, name="pool-results", daemon=True)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="pool-monitor", daemon=True)
        self._dispatcher.start()
        self._results.start()
        self._monitor.start()

    # --------------------------------------------------------------- spawn

    def _placement(self, rid: int) -> torch.device:
        """Replica ``rid``'s device: ``cuda:{rid mod device count}`` for an
        unindexed CUDA device, else the pool's device."""
        dev = self._device
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", rid % torch.cuda.device_count())
        return dev

    def _spawn(self, rid: int, clean: bool = False):
        """Build one replica handle.  ``clean=True`` strips the fault
        specs: the seeded chaos belongs to the original cohort, a
        respawned worker must not replay it (its batch counter restarts,
        so a concrete-step kill would fire again and again)."""
        self._spawned_at[rid] = (time.perf_counter(), clean)
        if self.backend == "process":
            spec = self.spec
            if clean and spec.fault_specs:
                spec = dataclasses.replace(spec, fault_specs=())
            threads = max(1, (os.cpu_count() or 1) // self._size)
            handle = _ProcessReplica(rid, spec, str(self._placement(rid)),
                                     threads, self._ctx)
            self._readers[handle.results] = rid
            return handle
        server = self.spec.build_server(device=self._placement(rid))
        plan = None
        if not clean and self.spec.fault_specs:
            plan = fault_lib.FaultPlan(self.spec.fault_specs)
        return _ThreadReplica(rid, server, plan, self._result_q)

    def wait_ready(self, timeout: float = 120.0) -> None:
        """Block until every current replica has built its server; raises
        ``RuntimeError`` if a worker died before it was ready."""
        deadline = time.monotonic() + timeout
        with self._state_cond:
            while not self._state_cond.wait_for(
                    lambda: self._ready >= set(self._replicas)
                    or self._failed_start,
                    timeout=min(1.0, max(0.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    missing = set(self._replicas) - self._ready
                    raise TimeoutError(
                        f"replicas {sorted(missing)} not ready "
                        f"after {timeout}s")
            if self._failed_start:
                raise RuntimeError(
                    f"replica workers failed to start: {self._failed_start}")

    # ----------------------------------------------------------- admission

    def submit(self, word_ids: np.ndarray,
               counts: Optional[np.ndarray] = None,
               seed: Optional[int] = None) -> Future:
        """Admit one document; resolves to its (K,) θ̂ stamped with the φ
        version that produced it — same contract as the engine."""
        return self.router.submit(word_ids, counts, seed)

    # ----------------------------------------------------------- lifelong

    def subscribe(self, publisher, refresh: bool = True) -> None:
        """Subscribe every replica to a :class:`SnapshotPublisher`: each
        publish is broadcast (full payload + crc) through the task queues.
        The watcher thread picks up later publishes within its poll
        interval; per-replica swap acks feed the balancer's monotone
        version ledger."""
        self._publisher = publisher
        if refresh:
            snap = publisher.latest()
            if snap is not None:
                self._broadcast_swap(snap)
        if self._watcher is None:
            self._watcher = threading.Thread(
                target=self._watch_loop, name="pool-version-watcher",
                daemon=True)
            self._watcher.start()

    def _broadcast_swap(self, snap) -> None:
        payload = snapshot_payload(snap)
        self._send_swap(payload)

    def _send_swap(self, payload: dict) -> None:
        with self._state_cond:
            if payload["version"] <= self._swap_version or self._closing:
                return
            self._last_swap = payload
            self._swap_version = payload["version"]
            self._swap_sent[payload["version"]] = time.perf_counter()
            for h in self._replicas.values():
                h.send(("swap", payload))

    def _watch_loop(self) -> None:
        while not self._results_stop.is_set():
            pub = self._publisher
            if pub is not None and pub.version > self._swap_version:
                snap = pub.latest()
                if snap is not None:
                    self._broadcast_swap(snap)
            time.sleep(0.02)

    # ------------------------------------------------------------ dispatch

    def _choose(self) -> Optional[int]:
        pin = self.pin_replica
        if pin is not None:
            if pin in self._replicas and self.balancer.acquire_specific(pin):
                return pin
            return None
        return self.balancer.acquire()

    def _dispatch(self, L: int, reqs, w, c, seeds,
                  batch_id: Optional[int] = None) -> None:
        """Assign a padded batch to a least-loaded replica (blocking while
        every replica is at its in-flight cap).  Re-issue passes the
        original ``batch_id`` and the *identical* padded arrays — the
        bitwise-parity contract."""
        with self._state_cond:
            while True:
                if batch_id is not None and batch_id not in self._inflight:
                    # a re-issued orphan whose first run finished after the
                    # death was seen: its futures are resolved, and a
                    # second run would resolve them again
                    return
                why = ("closed" if self._closing
                       else "has no live replicas left"
                       if not self._replicas else None)
                rid = None if why else self._choose()
                if rid is not None:
                    break
                if why:
                    # every worker failed to start, or a re-issue raced
                    # close's timeout: fail the batch, don't hang
                    if batch_id is not None:
                        self._inflight.pop(batch_id, None)
                    exc = RuntimeError(f"replica pool {why}")
                    self._state_cond.release()
                    try:
                        self.router.fail_batch(reqs, exc)
                    finally:
                        self._state_cond.acquire()
                    return
                self._state_cond.wait(timeout=0.05)
            if batch_id is None:
                batch_id = self._next_batch_id
                self._next_batch_id += 1
            self._inflight[batch_id] = {
                "rid": rid, "L": L, "reqs": reqs,
                "w": w, "c": c, "seeds": seeds, "filled": len(reqs),
            }
            self._dispatched[rid] = self._dispatched.get(rid, 0) + 1
            # under the lock: the monitor cannot close this queue between
            # the choice and the send
            self._replicas[rid].send(
                ("batch", batch_id, L, w, c, seeds, len(reqs)))

    def _dispatch_loop(self) -> None:
        while True:
            item = self.router.next_batch()
            if item is None:
                return
            L, reqs = item
            w, c, seeds = pad_batch(L, reqs, self.router.max_batch)
            self._dispatch(L, reqs, w, c, seeds)

    # ------------------------------------------------------------- results

    def _next_results(self) -> list:
        """The messages that arrive within one poll interval: from the
        shared queue (threads), or one from every worker pipe that has one
        (processes; a pipe at its end of file — its worker died — is
        dropped)."""
        if self._result_q is not None:
            try:
                return [self._result_q.get(timeout=0.05)]
            except queue.Empty:
                return []
        with self._state_cond:
            readers = list(self._readers)
        if not readers:
            time.sleep(0.05)
            return []
        out = []
        for conn in mp_connection.wait(readers, timeout=0.05):
            try:
                out.append(conn.recv())
            except (EOFError, OSError):
                with self._state_cond:
                    self._readers.pop(conn, None)
                conn.close()
        return out

    def _results_loop(self) -> None:
        while True:
            msgs = self._next_results()
            if not msgs and self._results_stop.is_set():
                return
            for msg in msgs:
                self._handle_result(msg)

    def _handle_result(self, msg) -> None:
        """Account for one worker message."""
        kind = msg[0]
        if kind == "done":
            _, rid, bid, theta, version, secs, ch, cm, launches = msg
            with self._state_cond:
                info = self._inflight.pop(bid, None)
                if info is not None:
                    self._account_completion(info["rid"], version)
                    self._state_cond.notify_all()
            if info is None:
                return     # duplicate after a re-issue: drop
            pub = self._publisher
            rec = {
                "L": info["L"], "filled": info["filled"],
                "capacity": self.router.max_batch,
                "launch_seconds": secs,
                "cache_hits": ch, "cache_misses": cm,
                "replica": rid, "version": version,
                "published_version": (
                    pub.version if pub is not None else -1),
                "launches": launches,
            }
            self.router.resolve_batch(info["reqs"], theta, version, rec)
        elif kind == "error":
            _, rid, bid, err = msg
            if bid == -1:              # the worker's server build failed
                with self._state_cond:
                    self._start_errors[rid] = err
                return
            with self._state_cond:
                info = self._inflight.pop(bid, None)
                if info is not None:
                    self._account_completion(info["rid"], None)
                    self._state_cond.notify_all()
            if info is not None:
                self.router.fail_batch(
                    info["reqs"],
                    RuntimeError(f"replica {rid} launch failed: {err}"))
        elif kind == "ready":
            now = time.perf_counter()
            with self._state_cond:
                rid = msg[1]
                self._ready.add(rid)
                if (rid in self._replicas
                        and rid not in self.balancer.replicas()):
                    self.balancer.add(rid)       # a respawn, now ready
                t0, respawn = self._spawned_at.get(rid, (now, False))
                self.ready_log.append({"rid": rid, "seconds": now - t0,
                                       "respawn": respawn})
                self._state_cond.notify_all()
        elif kind == "swapped":
            _, rid, version = msg
            now = time.perf_counter()
            with self._state_cond:
                sent = self._swap_sent.get(version)
                self.swap_acks.append({
                    "rid": rid, "version": version,
                    "seconds": None if sent is None else now - sent})
                try:
                    self.balancer.note_version(rid, version)
                except KeyError:
                    pass                  # raced a removal
                self._state_cond.notify_all()
        elif kind == "swap_error":
            _, rid, version, err = msg
            with self._state_cond:
                self.swap_errors.append({"rid": rid, "version": version,
                                         "error": err})
                self._state_cond.notify_all()
        elif kind == "prewarmed":
            with self._state_cond:
                self._prewarm_acks += 1
                self._state_cond.notify_all()
        elif kind == "fault":
            # a soft kill also exits the worker loop: stash the detail
            # and let the monitor's death detection record the single
            # death event (otherwise one loss counts twice)
            with self._state_cond:
                self._soft_faults[msg[1]] = msg[2]
        # "bye": clean shutdown ack — nothing to account

    def _account_completion(self, rid: int, version: Optional[int]) -> None:
        """Balancer bookkeeping for one finished batch, tolerant of the
        replica having been removed while the result was in the queue."""
        try:
            self.balancer.complete(rid)
        except (KeyError, ValueError):
            pass
        if version is not None and version >= 0:
            try:
                self.balancer.note_version(rid, version)
            except KeyError:
                pass

    # ------------------------------------------------------------- monitor

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.is_set():
            time.sleep(0.05)
            dead = []
            with self._state_cond:
                if self._closing:
                    continue
                for rid, h in list(self._replicas.items()):
                    if not h.alive():
                        dead.append((rid, h, rid in self._ready))
                        del self._replicas[rid]
                        h.discard()   # no thread holds it for a send now
                        try:
                            self.balancer.remove(rid)
                        except KeyError:
                            pass
                if dead:
                    self._ready -= {rid for rid, _, _ in dead}
                    self._state_cond.notify_all()
            for rid, h, was_ready in dead:
                self._handle_death(rid, h, was_ready)

    def _handle_death(self, rid: int, handle, was_ready: bool = True
                      ) -> None:
        """Record the loss, respawn, then re-issue the dead worker's
        in-flight batches — identical padded payloads — so every submitted
        Future resolves.  A worker that died before it was ready failed to
        start: it is not respawned (a respawn would fail alike, forever),
        and :meth:`wait_ready` raises with its error."""
        with self._state_cond:
            detail = self._soft_faults.pop(rid, None)
            start_error = self._start_errors.pop(rid, None)
        kind = "soft" if detail else "hard" if was_ready else "startup"
        rec = {"rid": rid, "kind": kind, "exitcode": handle.exitcode}
        if detail or start_error:
            rec["detail"] = detail or start_error
        self.deaths.append(rec)
        with self._state_cond:
            if not was_ready:
                self._failed_start[rid] = rec.get(
                    "detail", f"exit code {handle.exitcode}")
            orphans = [(bid, info) for bid, info in self._inflight.items()
                       if info["rid"] == rid]
            if was_ready and not self._closing:
                # registered with the balancer once it is ready: until
                # then the survivors take the orphans and the new traffic
                self._replicas[rid] = self._spawn(rid, clean=True)
                self.respawns += 1
                if self._last_swap is not None:
                    self._replicas[rid].send(("swap", self._last_swap))
                self._state_cond.notify_all()
            survivors = bool(self._replicas)
        if not survivors:
            with self._state_cond:
                for bid, info in orphans:
                    self._inflight.pop(bid, None)
            for _, info in orphans:
                self.router.fail_batch(
                    info["reqs"],
                    RuntimeError(f"replica {rid} died with no survivors"))
            return
        for bid, info in orphans:
            self._dispatch(info["L"], info["reqs"], info["w"], info["c"],
                           info["seeds"], batch_id=bid)

    # ------------------------------------------------------------ plumbing

    def prewarm(self, lengths: Optional[Sequence[int]] = None,
                timeout: float = 600.0) -> int:
        """Broadcast one full launch per L bucket to every replica
        (``serve.prewarm_server``) and wait for the acks."""
        dims = {
            "max_batch": self.router.max_batch,
            "bucket_multiple": self.router.bucket_multiple,
            "max_len": self.router.max_len,
            "lengths": None if lengths is None else list(lengths),
        }
        with self._state_cond:
            self._prewarm_acks = 0
            handles = list(self._replicas.values())
            for h in handles:
                h.send(("prewarm", dims))
        deadline = time.monotonic() + timeout
        with self._state_cond:
            ok = self._state_cond.wait_for(
                lambda: self._prewarm_acks >= len(handles),
                timeout=deadline - time.monotonic())
        if not ok:
            raise TimeoutError("replica prewarm did not ack in time")
        return len(handles)

    def metrics(self, reset: bool = False) -> dict:
        """Router window metrics + pool aggregation: per-replica dispatch
        counts, deaths/respawns, the balancer's version ledger and the
        workers' reported ``theta_sweep`` launches over the window (process
        backend; ``None`` when no batch reported a count)."""
        with self.router._lock:
            counts = [b["launches"] for b in self.router.batch_log
                      if b.get("launches") is not None]
        out = self.router.metrics(reset=reset)
        with self._state_cond:
            out.update(
                replicas=len(self._replicas),
                backend=self.backend,
                dispatch={rid: n for rid, n in sorted(
                    self._dispatched.items())},
                deaths=len(self.deaths),
                respawns=self.respawns,
                replica_versions=self.balancer.versions(),
                theta_sweep_launches=sum(counts) if counts else None,
            )
        return out

    def drain(self) -> None:
        """Block until every admitted request has resolved (including
        batches in flight at the workers — the router counts resolutions,
        not launches)."""
        self.router.drain()

    def close(self, timeout: float = 60.0) -> None:
        """Flush, dispatch, and resolve everything, then stop the world.

        Idempotent and safe under concurrent callers (the close lock
        serializes them; every caller returns only after the threads and
        workers are joined).  The router closes first so the dispatcher
        drains every flushed bucket; worker stop messages go out only after
        the in-flight map empties, so no batch is ever abandoned by
        shutdown.
        """
        with self._close_lock:
            if self._closed:
                return
            self.router.close()
            self._dispatcher.join()
            deadline = time.monotonic() + timeout
            with self._state_cond:
                self._state_cond.wait_for(
                    lambda: not self._inflight,
                    timeout=max(0.0, deadline - time.monotonic()))
                leftovers = list(self._inflight.items())
                self._inflight.clear()
                self._closing = True
                handles = list(self._replicas.values())
                for h in handles:
                    h.send(("stop",))
            for _, info in leftovers:         # timeout path: never hang
                self.router.fail_batch(
                    info["reqs"],
                    RuntimeError("replica pool closed with the batch "
                                 "still in flight"))
            for h in handles:
                h.join(timeout=10.0)
                if h.alive():
                    h.kill()
                    h.join(timeout=10.0)
                h.discard()
            self._results_stop.set()
            self._monitor_stop.set()
            self._results.join()
            self._monitor.join()
            if self._watcher is not None:
                self._watcher.join()
            with self._state_cond:
                readers, self._readers = list(self._readers), {}
            for conn in readers:
                conn.close()
            self._closed = True

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
