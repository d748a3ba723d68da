"""The port's continuous-batching serving engine (``ServingEngine`` over
``TopicServer(device="cpu")``): the cases of ``tests/test_serving_engine.py``
that do not need lifelong hot-swap or the jit cache, plus slot invariance
and the prewarm count.

The contract: the engine packs asynchronously submitted documents into
``(max_batch, L)`` launches without changing any answer — under
``rel_tol=0`` a document's θ is bitwise the same whether it arrived alone,
mid-batch, or padded next to strangers, because its θ̂₀ is drawn from its
own seed (``document_theta0``) and the θ-sweep keeps documents independent.
Every ``future.result`` has a timeout, so a hang fails the test.
"""
import sys
import threading

import numpy as np
import pytest

from repro_torch.core import LDAConfig, ParameterStore
from repro_torch.launch import serve
from repro_torch.launch.serve import (
    ServingEngine,
    TopicServer,
    TrafficGenerator,
    document_theta0,
    pad_batch,
)

K, W = 8, 96
TIMEOUT = 30


@pytest.fixture()
def store(tmp_path):
    rng = np.random.default_rng(0)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32) * 1e4
    store = ParameterStore(str(tmp_path / "phi"), num_topics=K,
                           vocab_capacity=W, buffer_rows=0)
    store.write_rows(np.arange(W), phi)
    store.phi_k[:] = phi.sum(0)
    return store


@pytest.fixture()
def server(store):
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    return TopicServer(store, cfg, fit_sweeps=10, rel_tol=0.0,
                       check_every=10, vocab_pad=32, hot_rows=48,
                       device="cpu")


def _doc(rng, n):
    uniq = rng.choice(W, size=n, replace=False).astype(np.int32)
    return uniq, rng.integers(1, 5, n).astype(np.float32)


def _direct(server, docs, seeds, order, rows, L):
    """The documents ``order`` names, in that slot order, in one hand-padded
    (rows, L) ``server.infer`` launch with their per-document θ̂₀."""
    wp = np.zeros((rows, L), np.int32)
    cp = np.zeros((rows, L), np.float32)
    sp = np.full(rows, -1, np.int64)
    for slot, i in enumerate(order):
        w, c = docs[i]
        wp[slot, : len(w)] = w
        cp[slot, : len(c)] = c
        sp[slot] = seeds[i]
    return server.infer(wp, cp, theta0=document_theta0(
        sp, cp, server.cfg, device="cpu"))


def test_engine_matches_direct_batch_bitwise(server):
    """Continuous batching is semantically invisible: a doc's θ̂ equals a
    hand-padded direct ``server.infer`` launch with the same per-doc seed,
    regardless of slot position (rel_tol=0)."""
    rng = np.random.default_rng(1)
    docs = [_doc(rng, n) for n in (5, 9, 3, 8)]
    seeds = rng.integers(0, 2**32, 4).tolist()

    with ServingEngine(server, max_batch=4, bucket_multiple=16,
                       max_delay_ms=50.0, max_len=16) as eng:
        futs = [eng.submit(w, c, seed=s) for (w, c), s in zip(docs, seeds)]
        got = [f.result(timeout=TIMEOUT) for f in futs]

    order = [2, 0, 3, 1]
    theta = _direct(server, docs, seeds, order, 4, 16)
    for slot, i in enumerate(order):
        np.testing.assert_array_equal(got[i], theta[slot])
        assert got[i].version == -1


def test_slot_invariance_alone_and_among_strangers(server):
    """The same documents resolve to the same bits submitted alone (one a
    launch), all together, or in a launch padded with strangers in other
    slots — and through the engine's own derived seeds, which depend on the
    admission number alone."""
    rng = np.random.default_rng(5)
    docs = [_doc(rng, n) for n in (4, 7, 11, 2, 6, 9)]
    seeds = [serve._sub_seed(3, i) for i in range(len(docs))]
    with ServingEngine(server, max_batch=8, bucket_multiple=16,
                       max_delay_ms=20.0, max_len=16, seed=3) as eng:
        together = [f.result(timeout=TIMEOUT)
                    for f in [eng.submit(w, c) for w, c in docs]]
    with ServingEngine(server, max_batch=8, bucket_multiple=16,
                       max_delay_ms=1.0, max_len=16) as eng:
        alone = [eng.submit(w, c, seed=s).result(timeout=TIMEOUT)
                 for (w, c), s in zip(docs, seeds)]
        assert all(b["filled"] == 1 for b in eng.batch_log)
    strangers = [_doc(rng, 5) for _ in range(2)]
    order = [6, 5, 4, 7, 3, 2, 1, 0]
    mixed = _direct(server, docs + strangers, seeds + [7, 8], order, 8, 16)
    for i in range(len(docs)):
        np.testing.assert_array_equal(together[i], alone[i])
        np.testing.assert_array_equal(together[i], mixed[order.index(i)])


def test_document_theta0_is_a_function_of_its_seed():
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    rng = np.random.default_rng(2)
    c = rng.integers(0, 4, (3, 16)).astype(np.float32)
    a = document_theta0([5, -1, 9], c, cfg, device="cpu")
    b = document_theta0([9, 7, 5], c[[2, 1, 0]], cfg, device="cpu")
    assert bool((a[1] == 0).all())                  # an empty slot
    assert np.array_equal(a[0].numpy(), b[2].numpy())
    assert np.array_equal(a[2].numpy(), b[0].numpy())
    np.testing.assert_allclose(a.sum(1).numpy(), c.sum(1) * [1, 0, 1],
                               rtol=1e-6)


def test_deadline_flush_resolves_partial_batch(server):
    """A lone request must not wait for the bucket to fill: the collector
    flushes once the oldest request ages past max_delay_ms."""
    with ServingEngine(server, max_batch=64, bucket_multiple=16,
                       max_delay_ms=20.0, max_len=16) as eng:
        rng = np.random.default_rng(2)
        w, c = _doc(rng, 6)
        theta = eng.submit(w, c).result(timeout=TIMEOUT)
        assert theta.shape == (K,)
        assert eng.batch_log and eng.batch_log[0]["filled"] == 1


def test_prewarm_counts_one_launch_per_bucket(server):
    """prewarm() runs one launch per reachable L bucket and returns the
    count; traffic afterwards resolves and the metrics add up."""
    with ServingEngine(server, max_batch=4, bucket_multiple=8,
                       max_delay_ms=2.0, max_len=16) as eng:
        assert eng.prewarm() == 2                   # L = 8 and 16
        assert eng.prewarm(lengths=[8, 12, 24]) == 2   # 12 is off the grid
        assert server.hot_cache.stats.hits == 0     # warm-up not counted
        assert not eng.batch_log
        gen = TrafficGenerator(W, doc_len=(2, 14), seed=3)
        futs = [eng.submit(*gen.document()) for _ in range(40)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        eng.drain()
        m = eng.metrics()
        assert m["requests"] == 40 and m["failed_batches"] == 0
        assert m["p99_ms"] >= m["p50_ms"] > 0.0
        assert sum(b["filled"] for b in eng.batch_log) == 40
        assert {b["L"] for b in eng.batch_log} <= {8, 16}


def test_engine_rejects_oversized_and_closed(server):
    eng = ServingEngine(server, max_len=16, max_delay_ms=1.0)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(17, dtype=np.int32))
    eng.close()
    eng.close()                                   # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.arange(4, dtype=np.int32))


def test_close_flushes_pending_requests(server):
    """close() must resolve every admitted request, even ones still
    sitting in a partially-filled slot."""
    eng = ServingEngine(server, max_batch=64, bucket_multiple=16,
                        max_delay_ms=10_000.0, max_len=16)
    rng = np.random.default_rng(4)
    futs = [eng.submit(*_doc(rng, 5)) for _ in range(3)]
    eng.close()
    for f in futs:
        assert f.result(timeout=TIMEOUT).shape == (K,)


def test_failed_launch_reaches_every_future(server, monkeypatch):
    """A launch that raises resolves every future of its bucket with the
    exception; the engine keeps serving the next bucket."""
    calls = []
    real = server.infer

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected launch failure")
        return real(*a, **kw)

    monkeypatch.setattr(server, "infer", flaky)
    rng = np.random.default_rng(6)
    eng = ServingEngine(server, max_batch=4, bucket_multiple=16,
                        max_delay_ms=10_000.0, max_len=16)
    try:
        bad = [eng.submit(*_doc(rng, 3)) for _ in range(4)]
        for f in bad:
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=TIMEOUT)
        good = [eng.submit(*_doc(rng, 3)) for _ in range(4)]
        for f in good:
            assert f.result(timeout=TIMEOUT).shape == (K,)
        eng.drain()
        assert eng.metrics()["failed_batches"] == 1
        assert eng._resolved == eng._seq == 8
    finally:
        eng.close()


def test_pad_batch_empty_slots():
    from concurrent.futures import Future

    r = serve._Request(0, np.array([3, 5], np.int32),
                       np.array([1.0, 2.0], np.float32), 42, Future(), 0.0)
    w, c, s = pad_batch(8, [r], 3)
    assert w.shape == c.shape == (3, 8) and s.tolist() == [42, -1, -1]
    assert w[0, :2].tolist() == [3, 5] and c[0].sum() == 3.0
    assert not c[1:].any()


def test_traffic_replay_unpaced_preserves_order():
    gen = TrafficGenerator(W, doc_len=(4, 8), seed=5)
    trace = gen.trace([(1000.0, 10)])
    seen = []
    futs = TrafficGenerator.replay(
        trace, lambda w, c: seen.append((w, c)) or len(seen), pace=False)
    assert futs == list(range(1, 11))
    for (_, w, c), (w2, c2) in zip(trace, seen):
        np.testing.assert_array_equal(w, w2)
        np.testing.assert_array_equal(c, c2)


def test_traffic_replay_paced_honours_arrivals():
    import time

    trace = [(0.0, None, None), (0.03, None, None), (0.06, None, None)]
    stamps = []
    t0 = time.perf_counter()
    TrafficGenerator.replay(
        trace, lambda w, c: stamps.append(time.perf_counter() - t0),
        pace=True)
    assert stamps[1] >= 0.03 and stamps[2] >= 0.06


# ---------------------------------------------------------------------------
# Concurrency: racing submitters, drain and close
# ---------------------------------------------------------------------------


def test_concurrent_submitters_racing_drain_and_close(server):
    """N submitter threads race the collector, a drain() caller, and the
    final close(): every admitted future resolves exactly once, none are
    lost, and the engine's resolved counter matches its admission counter."""
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)            # force frequent thread preemption
    try:
        eng = ServingEngine(server, max_batch=8, bucket_multiple=8,
                            max_delay_ms=1.0, max_len=16)
        eng.prewarm()
        n_threads, per_thread = 6, 25
        futures = [[] for _ in range(n_threads)]
        barrier = threading.Barrier(n_threads + 1)
        rejected = []

        def submitter(tid):
            rng = np.random.default_rng(100 + tid)
            barrier.wait()
            for _ in range(per_thread):
                w, c = _doc(rng, int(rng.integers(2, 14)))
                try:
                    futures[tid].append(eng.submit(w, c))
                except RuntimeError:       # lost the race with close()
                    rejected.append(tid)

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        barrier.wait()
        eng.drain()                        # races the submitters mid-flight
        for th in threads:
            th.join(TIMEOUT)
            assert not th.is_alive()
        eng.close()                        # must flush everything admitted

        admitted = [f for fs in futures for f in fs]
        assert len(admitted) + len(rejected) == n_threads * per_thread
        assert not rejected                # close() came after all joins
        for f in admitted:
            theta = f.result(timeout=TIMEOUT)   # resolved — no lost futures
            assert theta.shape == (K,)
            assert np.isfinite(np.asarray(theta)).all()
        # exactly-once resolution: the engine's own books must balance
        assert eng._resolved == eng._seq == len(admitted)
        assert sum(b["filled"] for b in eng.batch_log) == len(admitted)
    finally:
        sys.setswitchinterval(old_interval)


def test_close_is_idempotent_under_concurrent_callers(server):
    """Every concurrent closer returns with the collector and launcher
    joined, every admitted future resolved, and later submits see the
    closed error."""
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        eng = ServingEngine(server, max_batch=64, bucket_multiple=16,
                            max_delay_ms=10_000.0, max_len=16)
        rng = np.random.default_rng(9)
        futs = [eng.submit(*_doc(rng, 5)) for _ in range(5)]

        n_closers, errs = 6, []
        barrier = threading.Barrier(n_closers)

        def closer(kind):
            try:
                barrier.wait()
                if kind:           # drain() racing close() must also return
                    eng.drain()
                eng.close()
            except Exception as e:             # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=closer, args=(i % 2,))
                   for i in range(n_closers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()            # no closer deadlocked
        assert not errs
        assert not eng._launcher.is_alive()
        assert not eng.router._collector.is_alive()
        for f in futs:                          # close flushed the slot
            assert f.result(timeout=1).shape == (K,)
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(np.arange(4, dtype=np.int32))
        eng.close()                             # and still idempotent after
    finally:
        sys.setswitchinterval(old_interval)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_serve_cli_traffic_on_cpu(tmp_path, capsys):
    serve.main(["--workdir", str(tmp_path / "s"), "--topics", "8",
                "--vocab", "300", "--make-store", "--device", "cpu",
                "--traffic", "--requests", "40", "--qps", "4000",
                "--batch", "16", "--min-len", "4", "--max-len", "20",
                "--max-delay-ms", "2"])
    out = capsys.readouterr().out
    assert "served 40 requests" in out and "latency p50" in out
    assert "2 warm-up launches" in out
