"""The port's multi-replica serving pool on the CPU: the cases of
``tests/test_replica_pool.py`` run on ``repro_torch.launch.replica``, plus
the cross-package and port-only cases.

* ``ReplicaBalancer``: the unit cases and the hypothesis properties; one
  seeded op sequence drives the port's and the JAX package's balancers,
  which agree step for step (return values, raised errors, ledgers).
* Thread backend: 2 replicas bitwise equal to the single
  ``ServingEngine`` (``rel_tol=0``: placement is invisible); replica 0
  against replica 3 of a 4-replica pool, pinned; monotone hot-swap
  versions; a concurrent, idempotent close; a corrupt swap payload refused
  (the replica keeps serving its version).
* Process backend: the two kill cases marked ``slow`` as the JAX file marks
  them, and one 2-replica soft kill that is not slow, so the spawn path,
  the monitor, the respawn and the re-issue run in tier-1.
* The serve CLI's ``--replicas 2`` on the CPU.
"""
import threading
import time

import numpy as np
import pytest

from repro.launch.replica import ReplicaBalancer as JBalancer
from repro_torch.core import LDAConfig, ParameterStore
from repro_torch.core.streaming import SnapshotPublisher
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.replica import (
    ReplicaBalancer,
    ReplicaPool,
    ReplicaSpec,
    snapshot_payload,
)
from repro_torch.launch.serve import (
    ServingEngine,
    TopicServer,
    TrafficGenerator,
    pad_batch,
)
from repro_torch.runtime.faults import FaultSpec, REPLICA_KILL

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st_
    HAVE_HYPOTHESIS = True
except ImportError:                               # CI installs it; local
    HAVE_HYPOTHESIS = False                       # runs skip gracefully

    def given(**_kw):                             # no-op stand-ins so the
        return lambda f: f                        # decorated tests still

    def settings(**_kw):                          # collect (and then skip)
        return lambda f: f

    class st_:                                    # noqa: N801
        @staticmethod
        def none():
            return None

needs_hypothesis = pytest.mark.skipif(
    not HAVE_HYPOTHESIS, reason="hypothesis not installed")

K, W = 8, 96
TIMEOUT = 120


# ---------------------------------------------------------------------------
# ReplicaBalancer: deterministic unit tests
# ---------------------------------------------------------------------------


def test_balancer_least_loaded_with_smallest_id_ties():
    b = ReplicaBalancer(cap=2)
    for rid in (3, 1, 7):
        b.add(rid)
    assert b.acquire() == 1
    assert b.acquire() == 3
    assert b.acquire() == 7
    assert b.acquire() == 1
    b.complete(7)
    assert b.acquire() == 7


def test_balancer_cap_and_negative_accounting():
    b = ReplicaBalancer(cap=1)
    b.add(0)
    assert b.acquire() == 0
    assert b.acquire() is None
    assert not b.acquire_specific(0)
    b.complete(0)
    with pytest.raises(ValueError):
        b.complete(0)
    with pytest.raises(KeyError):
        b.complete(99)
    with pytest.raises(ValueError):
        b.add(0)


def test_balancer_remove_returns_orphans_and_respawn_keeps_version_floor():
    b = ReplicaBalancer(cap=4)
    b.add(0)
    b.add(1)
    for _ in range(3):
        b.acquire_specific(1)
    b.note_version(1, 5)
    assert b.remove(1) == 3
    assert b.replicas() == [0]
    b.add(1)
    assert b.inflight(1) == 0
    with pytest.raises(ValueError):
        b.note_version(1, 4)
    b.note_version(1, 5)
    b.note_version(1, 6)


def test_balancer_version_ledger():
    b = ReplicaBalancer(cap=2)
    b.add(0)
    b.add(1)
    assert b.min_version() == -1
    b.note_version(0, 3)
    assert b.versions() == {0: 3, 1: -1}
    assert b.min_version() == -1
    b.note_version(1, 2)
    assert b.min_version() == 2
    with pytest.raises(ValueError):
        b.note_version(0, 1)


def _apply(b, op, rid, v):
    """One op on a balancer: its return value, or the exception's type."""
    try:
        if op == "add":
            return b.add(rid)
        if op == "acq":
            return b.acquire()
        if op == "acq_at":
            return b.acquire_specific(rid)
        if op == "done":
            return b.complete(rid)
        if op == "rm":
            return b.remove(rid)
        return b.note_version(rid, v)
    except (KeyError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_balancer_matches_jax_step_for_step(seed):
    """The port's and the JAX package's balancers under one seeded op
    sequence: every return value (or raised error type) and every ledger
    read equal at every step."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 4))
    ours, theirs = ReplicaBalancer(cap=cap), JBalancer(cap=cap)
    ops = ["add", "acq", "acq_at", "done", "rm", "ver"]
    for _ in range(300):
        op = ops[int(rng.integers(0, len(ops)))]
        rid, v = int(rng.integers(0, 5)), int(rng.integers(0, 12))
        assert _apply(ours, op, rid, v) == _apply(theirs, op, rid, v)
        assert ours.replicas() == theirs.replicas()
        assert ours.versions() == theirs.versions()
        assert ours.min_version() == theirs.min_version()
        assert ours.total_inflight() == theirs.total_inflight()
        for r in ours.replicas():
            assert ours.inflight(r) == theirs.inflight(r)


# ---------------------------------------------------------------------------
# ReplicaBalancer: hypothesis property tests
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:
    _ops_st = st_.lists(
        st_.tuples(st_.sampled_from(["add", "acq", "acq_at", "done", "rm"]),
                   st_.integers(0, 4)),
        min_size=1, max_size=60)
    _caps_st = st_.integers(1, 3)
    _notes_st = st_.lists(
        st_.tuples(st_.integers(0, 3), st_.integers(0, 20)),
        min_size=1, max_size=40)


@needs_hypothesis
@settings(max_examples=60, deadline=None)
@given(cap=_caps_st if HAVE_HYPOTHESIS else st_.none(),
       ops=_ops_st if HAVE_HYPOTHESIS else st_.none())
def test_balancer_inflight_bounded_and_least_loaded(cap, ops):
    """Under any interleaving of membership/dispatch ops every in-flight
    count stays in ``[0, cap]``, acquire returns a least-loaded registered
    replica under the cap, and a shadow model never diverges."""
    b = ReplicaBalancer(cap=cap)
    model = {}
    for op, rid in ops:
        if op == "add":
            if rid in model:
                with pytest.raises(ValueError):
                    b.add(rid)
            else:
                b.add(rid)
                model[rid] = 0
        elif op == "acq":
            got = b.acquire()
            free = {r: n for r, n in model.items() if n < cap}
            if not free:
                assert got is None
            else:
                lo = min(free.values())
                assert got in free and free[got] == lo
                assert got == min(r for r, n in free.items() if n == lo)
                model[got] += 1
        elif op == "acq_at":
            ok = b.acquire_specific(rid)
            assert ok == (model.get(rid, cap) < cap)
            if ok:
                model[rid] += 1
        elif op == "done":
            if model.get(rid, 0) > 0:
                b.complete(rid)
                model[rid] -= 1
            elif rid in model:
                with pytest.raises(ValueError):
                    b.complete(rid)
            else:
                with pytest.raises(KeyError):
                    b.complete(rid)
        elif op == "rm":
            if rid in model:
                assert b.remove(rid) == model.pop(rid)
        assert b.replicas() == sorted(model)
        for r, n in model.items():
            assert 0 <= n <= cap
            assert b.inflight(r) == n
        assert b.total_inflight() == sum(model.values())


@needs_hypothesis
@settings(max_examples=60, deadline=None)
@given(notes=_notes_st if HAVE_HYPOTHESIS else st_.none())
def test_balancer_version_notes_monotone(notes):
    """φ version notes are accepted iff nondecreasing per replica."""
    b = ReplicaBalancer(cap=2)
    high = {}
    for rid in range(4):
        b.add(rid)
        high[rid] = -1
    for rid, v in notes:
        if v < high[rid]:
            with pytest.raises(ValueError):
                b.note_version(rid, v)
        else:
            b.note_version(rid, v)
            high[rid] = v
        assert b.versions() == high
        assert b.min_version() == min(high.values())


# ---------------------------------------------------------------------------
# Serving fixtures: a small trained store shared across the pool tests
# ---------------------------------------------------------------------------


def _make_store(d: str) -> ParameterStore:
    store = ParameterStore(d, num_topics=K, vocab_capacity=W, buffer_rows=0)
    rng = np.random.default_rng(0)
    store.ensure_vocab(W - 1)
    store.write_rows(np.arange(W, dtype=np.int64),
                     rng.random((W, K)).astype(np.float32) + 0.1)
    store.phi_k[:] = store.dense_phi().sum(0)
    store.flush()
    return store


@pytest.fixture(scope="module")
def pool_store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("replica_store"))
    _make_store(d)
    return d


@pytest.fixture(scope="module")
def pool_docs():
    rng = np.random.default_rng(42)
    docs = []
    for _ in range(24):
        n = int(rng.integers(4, 12))
        w = rng.choice(W, size=n, replace=False).astype(np.int32)
        c = rng.integers(1, 4, size=n).astype(np.float32)
        docs.append((w, c))
    return docs


def _cfg():
    return LDAConfig(num_topics=K, vocab_size=W)


def _spec(store_path, **kw):
    return ReplicaSpec(
        store_path=store_path, cfg=_cfg(), vocab_capacity=W, fit_sweeps=10,
        rel_tol=0.0, check_every=10, vocab_pad=32, hot_rows=16,
        device="cpu", **kw)


POOL = dict(max_batch=8, max_delay_ms=2.0, max_len=64, seed=0)


@pytest.fixture(scope="module")
def engine_ref(pool_store, pool_docs):
    """Single-replica ServingEngine reference answers (router seed 0)."""
    store = ParameterStore.attach(pool_store, num_topics=K, vocab_capacity=W)
    server = TopicServer(store, _cfg(), 10, rel_tol=0.0, check_every=10,
                         vocab_pad=32, hot_rows=16, device="cpu")
    with ServingEngine(server, **POOL) as eng:
        futs = [eng.submit(w, c) for w, c in pool_docs]
        ref = [np.asarray(f.result(timeout=TIMEOUT)) for f in futs]
        eng.drain()
    return ref


# ---------------------------------------------------------------------------
# Cross-replica determinism (thread backend)
# ---------------------------------------------------------------------------


def test_thread_pool_bitwise_matches_single_engine(pool_store, pool_docs,
                                                   engine_ref):
    with ReplicaPool(_spec(pool_store), replicas=2, backend="thread",
                     **POOL) as pool:
        pool.wait_ready(60)
        futs = [pool.submit(w, c) for w, c in pool_docs]
        got = [np.asarray(f.result(timeout=TIMEOUT)) for f in futs]
        pool.drain()
        m = pool.metrics()
    assert m["requests"] == len(pool_docs)
    assert m["replicas"] == 2 and m["deaths"] == 0
    assert sum(m["dispatch"].values()) == m["batches"]
    assert m["theta_sweep_launches"] is None     # threads share the counter
    for i, (a, b) in enumerate(zip(engine_ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"doc {i}")


def test_pinned_placement_parity_replica0_vs_replica3(pool_store, pool_docs,
                                                      engine_ref):
    answers = {}
    for pin in (0, 3):
        with ReplicaPool(_spec(pool_store), replicas=4, backend="thread",
                         **POOL) as pool:
            pool.wait_ready(60)
            pool.pin_replica = pin
            futs = [pool.submit(w, c) for w, c in pool_docs]
            answers[pin] = [np.asarray(f.result(timeout=TIMEOUT))
                            for f in futs]
            pool.drain()
            m = pool.metrics()
        assert {r for r, n in m["dispatch"].items() if n > 0} == {pin}
    for i in range(len(pool_docs)):
        np.testing.assert_array_equal(answers[0][i], answers[3][i],
                                      err_msg=f"doc {i} r0 vs r3")
        np.testing.assert_array_equal(answers[0][i], engine_ref[i],
                                      err_msg=f"doc {i} vs engine")


def test_thread_pool_hot_swap_versions_are_monotone(tmp_path, pool_docs):
    d = str(tmp_path / "swap_store")
    store = _make_store(d)
    pub = SnapshotPublisher(store)
    pub.publish()
    with ReplicaPool(_spec(d), replicas=2, backend="thread",
                     max_batch=4, max_delay_ms=1.0, max_len=64,
                     seed=0) as pool:
        pool.wait_ready(60)
        pool.subscribe(pub, refresh=True)
        seen = []
        for _round in range(3):
            futs = [pool.submit(w, c) for w, c in pool_docs[:8]]
            seen += [f.result(timeout=TIMEOUT).version for f in futs]
            pool.drain()
            pub.publish()
            deadline = time.monotonic() + 30
            while (min(pool.balancer.versions().values()) < pub.version
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        assert pool.balancer.versions() == {0: pub.version, 1: pub.version}
        acks = {(a["rid"], a["version"]) for a in pool.swap_acks}
        assert acks == {(r, v) for r in (0, 1)
                        for v in range(1, pub.version + 1)}
    assert all(1 <= v <= pub.version for v in seen)


def test_corrupt_swap_payload_is_refused(tmp_path, pool_docs):
    """A payload whose arrays do not match its crc manifest is refused by
    every replica: no ack, a ``swap_errors`` record each, and the replicas
    keep serving their installed version."""
    d = str(tmp_path / "corrupt_store")
    store = _make_store(d)
    pub = SnapshotPublisher(store)
    good = pub.publish()
    with ReplicaPool(_spec(d), replicas=2, backend="thread", **POOL) as pool:
        pool.wait_ready(60)
        pool.subscribe(pub, refresh=True)
        deadline = time.monotonic() + 30
        while len(pool.swap_acks) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        bad = snapshot_payload(good)
        bad["version"] = 2
        bad["phi"] = bad["phi"].copy()
        bad["phi"][0, 0] += 1.0                  # torn in transit
        pool._send_swap(bad)
        deadline = time.monotonic() + 30
        while len(pool.swap_errors) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(e["rid"] for e in pool.swap_errors) == [0, 1]
        assert all("crc" in e["error"] for e in pool.swap_errors)
        futs = [pool.submit(w, c) for w, c in pool_docs[:8]]
        assert {f.result(timeout=TIMEOUT).version for f in futs} == {1}
        assert pool.balancer.versions() == {0: 1, 1: 1}


def test_pool_close_idempotent_and_concurrent(pool_store, pool_docs):
    pool = ReplicaPool(_spec(pool_store), replicas=2, backend="thread",
                       **POOL)
    pool.wait_ready(60)
    futs = [pool.submit(w, c) for w, c in pool_docs[:6]]
    errs = []

    def closer():
        try:
            pool.close()
        except Exception as e:          # pragma: no cover - the assertion
            errs.append(e)

    threads = [threading.Thread(target=closer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errs
    for f in futs:
        assert np.asarray(f.result(timeout=1)).shape == (K,)
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(pool_docs[0][0], pool_docs[0][1])
    pool.close()


def test_pool_needs_a_spec_and_a_known_backend(pool_store):
    with pytest.raises(ValueError, match="ReplicaSpec"):
        ReplicaPool(None, backend="process")
    with pytest.raises(ValueError, match="ReplicaSpec"):
        ReplicaPool(None, backend="thread")
    with pytest.raises(ValueError, match="backend"):
        ReplicaPool(_spec(pool_store), backend="fork")


class _LostBetweenChoiceAndSend:
    """A replica handle whose worker dies while its first batch is being
    sent: that send marks the worker dead and lasts six monitor polls, and
    a send after :meth:`discard` raises, as ``multiprocessing.Queue.put``
    does on a closed queue."""

    backend = "thread"
    exitcode = None

    def __init__(self, inner):
        self.inner, self.dead, self.closed = inner, False, False

    def send(self, msg):
        if self.closed:
            raise ValueError("queue is closed")
        if msg[0] == "batch" and not self.dead:
            self.dead = True
            time.sleep(0.3)
            if self.closed:
                raise ValueError("queue is closed")
            return                      # the batch is lost with the worker
        self.inner.send(msg)

    def alive(self):
        return not self.dead

    def discard(self):
        self.closed = True
        self.inner.send(("stop",))

    def join(self, timeout=None):
        self.inner.join(timeout)

    def kill(self):
        pass


def test_worker_lost_between_choice_and_send(pool_store, pool_docs,
                                             engine_ref):
    """Replica 0 dies after the dispatcher chose it for a batch and before
    the send returned: the monitor re-issues that batch, the dispatcher
    lives on, and every later request resolves, bitwise the engine's."""
    with ReplicaPool(_spec(pool_store), replicas=2, backend="thread",
                     **POOL) as pool:
        pool.wait_ready(60)
        with pool._state_cond:
            pool._replicas[0] = _LostBetweenChoiceAndSend(pool._replicas[0])
        futs = [pool.submit(w, c) for w, c in pool_docs]
        got = [np.asarray(f.result(timeout=TIMEOUT)) for f in futs]
        pool.drain()
        m = pool.metrics()
    assert m["deaths"] == 1 and m["respawns"] == 1
    for i, (a, b) in enumerate(zip(engine_ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"doc {i}")


def test_reissue_of_a_batch_finished_meanwhile_sends_nothing(pool_store):
    """An orphan whose first run resolved it after the death was seen (the
    completion landed between the monitor's orphan scan and the re-issue)
    is not sent again: a second run would resolve its futures twice."""
    with ReplicaPool(_spec(pool_store), replicas=2, backend="thread",
                     **POOL) as pool:
        pool.wait_ready(60)
        with pool._state_cond:
            sent = dict(pool._dispatched)
            load = {r: pool.balancer.inflight(r)
                    for r in pool.balancer.replicas()}
        w, c, seeds = pad_batch(16, [], POOL["max_batch"])
        pool._dispatch(16, [], w, c, seeds, batch_id=10 ** 6)
        with pool._state_cond:
            assert pool._dispatched == sent
            assert {r: pool.balancer.inflight(r)
                    for r in pool.balancer.replicas()} == load
            assert 10 ** 6 not in pool._inflight


# ---------------------------------------------------------------------------
# Replica-kill chaos (process backend)
# ---------------------------------------------------------------------------


def test_process_pool_soft_kill_two_replicas(pool_store, pool_docs,
                                            engine_ref):
    """Two spawned workers, replica 1 soft-killed on its first batch: one
    death, one respawn, back to two replicas, every future resolved and
    bitwise equal to the single engine; the workers report their
    ``theta_sweep`` launches."""
    kill = (FaultSpec(point=REPLICA_KILL, kind="kill", step=0, shard=1,
                      hard=False),)
    with ReplicaPool(_spec(pool_store, fault_specs=kill), replicas=2,
                     backend="process", **POOL) as pool:
        pool.wait_ready(TIMEOUT)
        futs = [pool.submit(w, c) for w, c in pool_docs]
        got = [np.asarray(f.result(timeout=TIMEOUT)) for f in futs]
        pool.drain()
        deadline = time.monotonic() + TIMEOUT
        while pool.respawns < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        pool.wait_ready(TIMEOUT)
        m = pool.metrics()
        respawned = [r for r in pool.ready_log if r["respawn"]]
    assert len(got) == len(pool_docs)
    assert m["deaths"] == 1 and m["respawns"] == 1 and m["replicas"] == 2
    assert m["requests"] == len(pool_docs) and m["failed_batches"] == 0
    assert [r["rid"] for r in respawned] == [1]
    assert m["theta_sweep_launches"] == 0        # the CPU runs the plain path
    for i, (a, b) in enumerate(zip(engine_ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"doc {i}")


@pytest.mark.slow
def test_process_pool_kill_reissue_bitwise_parity(pool_store):
    gen = TrafficGenerator(W, doc_len=(4, 12), seed=7)
    trace = gen.trace([(500.0, 48)])

    def run(fault_specs):
        spec = _spec(pool_store, fault_specs=fault_specs)
        with ReplicaPool(spec, replicas=4, backend="process",
                         **POOL) as pool:
            pool.wait_ready(180)
            futs = TrafficGenerator.replay(trace, pool.submit, pace=True)
            got = [np.asarray(f.result(timeout=240)) for f in futs]
            pool.drain()
            m = pool.metrics()
        return got, m

    ref, m0 = run(())
    assert m0["deaths"] == 0 and m0["respawns"] == 0
    kill = (FaultSpec(point=REPLICA_KILL, kind="kill", step=0, shard=0,
                      hard=True),)
    got, m1 = run(kill)
    assert len(got) == len(trace) and all(g.shape == (K,) for g in got)
    assert m1["requests"] == len(trace)
    assert m1["deaths"] == 1 and m1["respawns"] == 1
    assert m1["replicas"] == 4
    assert sum(m1["dispatch"].values()) >= m1["batches"]
    assert sum(n for rid, n in m1["dispatch"].items() if rid != 0) > 0
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"doc {i}")


@pytest.mark.slow
def test_process_pool_soft_kill_reissue(pool_store, pool_docs):
    kill = (FaultSpec(point=REPLICA_KILL, kind="kill", step=0, shard=1,
                      hard=False),)
    with ReplicaPool(_spec(pool_store, fault_specs=kill), replicas=2,
                     backend="process", **POOL) as pool:
        pool.wait_ready(180)
        futs = [pool.submit(w, c) for w, c in pool_docs]
        got = [np.asarray(f.result(timeout=240)) for f in futs]
        pool.drain()
        m = pool.metrics()
    assert len(got) == len(pool_docs)
    assert m["deaths"] == 1 and m["respawns"] == 1


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_replicas_on_cpu(tmp_path, capsys):
    serve_cli.main([
        "--device", "cpu", "--workdir", str(tmp_path / "store"),
        "--topics", "8", "--vocab", "300", "--make-store", "--traffic",
        "--requests", "40", "--qps", "400", "--batch", "8",
        "--replicas", "2", "--replica-backend", "thread",
    ])
    out = capsys.readouterr().out
    assert "served 40 requests" in out and "over 2 thread replicas" in out
    assert "deaths 0, respawns 0" in out
