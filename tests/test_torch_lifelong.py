"""Port's lifelong train-while-serve path vs the JAX package, on the CPU.

* The port copies of ``tests/test_lifelong.py``'s cases, with
  ``device="cpu"``: immutable crc-manifested snapshots, the publisher's
  versions, retention and changed-row delta, memoized quantization, version
  pinning, the server's hot-swap and its refusal of a corrupt snapshot, the
  hot-row cache's epoch invalidation, int8 serving close to f32, the shift
  detector, the trainer's publish cadence, and the end-to-end
  train-while-serve run (bitwise equal to the run without traffic); and
  beyond them, a swap over skipped versions dropping every skipped delta
  (the JAX server drops only the newest) and a corrupt swap failing its
  engine bucket.
* Against the JAX package on the same seeded inputs: ``_host_quantize_rows``
  int8 bitwise (in row blocks too) and bf16 bitwise against
  ``ml_dtypes``; ``PhiSnapshot.crc`` equal for one store state (the on-disk
  format is shared); ``ShiftDetector`` event for event on a seeded signal
  series, topic birth and death included; a subscribed ``TopicServer``
  with the JAX θ̂₀ injected at the serving tolerances (rtol 1e-4 / atol
  1e-5, eq. 21 rtol 1e-5, as ``tests/test_torch_serving.py``), in f32, bf16
  and int8, across a hot-swap; the trainers' publish sequence and
  changed-row counts; a latched refresh step (``warmup_sweeps +
  refresh_extra_sweeps`` dense sweeps) within rtol 1e-4 of the JAX
  trainer's (the tolerance of ``tests/test_torch_training.py``: float32
  sums in other orders over a few Gauss-Seidel sweeps); and
  ``run_lifelong --quick --device cpu``, whose report has the JAX
  report's keys.

Every ``future.result`` and thread ``join`` has a timeout.
"""
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FOEMTrainer as JTrainer
from repro.core import ParameterStore as JStore
from repro.core import ShiftDetector as JShiftDetector
from repro.core import SnapshotPublisher as JPublisher
from repro.core import em as jem
from repro.core.streaming import _host_quantize_rows as j_quantize
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import uniform_responsibilities
from repro.launch.serve import TopicServer as JServer
from repro.sparse import MinibatchStream as JStream
from repro_torch.core import (
    FOEMTrainer,
    HotRowCache,
    LDAConfig,
    ParameterStore,
    ShiftDetector,
    SnapshotPublisher,
    em,
    streaming,
)
from repro_torch.core.perplexity import split_heldout_counts
from repro_torch.core.streaming import _host_quantize_rows
from repro_torch.data import synthetic_lda_corpus
from repro_torch.launch import lifelong
from repro_torch.launch.serve import (
    ServingEngine,
    ThetaResult,
    TopicServer,
    TrafficGenerator,
)
from repro_torch.sparse import MinibatchStream, bucketize

K, W = 8, 120
TIMEOUT = 60


def _store(tmp_path, name="phi", buffer_rows=0, seed=7, cls=ParameterStore):
    rng = np.random.default_rng(seed)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32) * 1e4
    store = cls(str(tmp_path / name), num_topics=K,
                vocab_capacity=W + 16, buffer_rows=buffer_rows)
    store.write_rows(np.arange(W), phi)
    store.phi_k[:] = np.asarray(phi.sum(0), np.float64)  # lint: host-f64
    store.ensure_vocab(W - 1)
    return store, phi


def _jax_theta0(counts, K_):
    mu0 = uniform_responsibilities(jax.random.PRNGKey(0), counts.shape + (K_,))
    return np.asarray(jem.fold_theta(mu0, jnp.asarray(counts)))


# ---------------------------------------------------------------------------
# PhiSnapshot / SnapshotPublisher
# ---------------------------------------------------------------------------


def test_snapshot_immutable_and_crc_manifested(tmp_path):
    store, phi = _store(tmp_path)
    pub = SnapshotPublisher(store)
    snap = pub.publish()
    np.testing.assert_array_equal(snap.phi[:W], phi)
    # read-only: a reader cannot mutate a published version
    with pytest.raises(ValueError):
        snap.phi[0, 0] = 1.0
    assert snap.verify()
    # a (forced) mutation fails the crc manifest loudly
    snap.phi.setflags(write=True)
    snap.phi[0, 0] += 1.0
    assert not snap.verify()


def test_publisher_versions_retention_and_wait(tmp_path):
    store, _ = _store(tmp_path)
    pub = SnapshotPublisher(store, retain=2)
    assert pub.latest() is None and pub.version == 0
    s1, s2, s3 = pub.publish(), pub.publish(), pub.publish()
    assert (s1.version, s2.version, s3.version) == (1, 2, 3)
    assert pub.latest() is s3
    assert pub.get(2) is s2
    assert pub.get(1) is None              # aged out (retain=2)
    assert pub.wait_for(3, timeout=0.1) is s3
    assert pub.wait_for(99, timeout=0.05) is None
    with pytest.raises(ValueError):
        SnapshotPublisher(store, retain=0)


def test_publish_changed_ids_are_the_delta(tmp_path):
    store, _ = _store(tmp_path)
    pub = SnapshotPublisher(store)
    s1 = pub.publish()                      # initial load wrote all W rows
    assert len(s1.changed_ids) == W
    store.write_rows(np.array([3, 7]), np.full((2, K), 5.0, np.float32))
    s2 = pub.publish()
    np.testing.assert_array_equal(s2.changed_ids, [3, 7])
    s3 = pub.publish()                      # nothing written since
    assert len(s3.changed_ids) == 0


def test_snapshot_quantize_memoized_and_accurate(tmp_path):
    store, phi = _store(tmp_path)
    snap = SnapshotPublisher(store).publish()
    v32, s32 = snap.quantize("float32")
    assert s32 is None and v32 is snap.phi
    vi, si = snap.quantize("int8")
    assert vi.dtype == np.int8 and si.dtype == np.float32
    assert snap.quantize("int8")[0] is vi   # memoized per dtype
    deq = vi.astype(np.float32) * si[:, None]
    # symmetric per-row int8: relative row error bounded by the step size
    amax = np.abs(snap.phi).max(axis=1)
    err = np.abs(deq - snap.phi).max(axis=1)
    assert (err <= amax / 127.0 * 0.5 + 1e-6).all()
    # bf16 storage is always bf16 (no float32 fallback)
    vb, sb = snap.quantize("bfloat16")
    assert sb is None and vb.dtype == torch.bfloat16
    assert snap.quantize("bfloat16")[0] is vb
    with pytest.raises(ValueError, match="phi_dtype"):
        snap.quantize("float16")


def test_snapshot_fetch_rows_pins_the_version(tmp_path):
    """A reader holding snapshot v keeps seeing v's rows whatever the
    trainer writes afterwards — in-flight pinning."""
    store, phi = _store(tmp_path)
    pub = SnapshotPublisher(store)
    s1 = pub.publish()
    store.write_rows(np.arange(W), np.zeros((W, K), np.float32))
    pub.publish()
    np.testing.assert_array_equal(
        s1.fetch_rows(np.array([0, 5, 9])), phi[[0, 5, 9]]
    )


# ---------------------------------------------------------------------------
# TopicServer hot-swap
# ---------------------------------------------------------------------------


def _server(store, **kw):
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    kw.setdefault("hot_rows", 48)
    return TopicServer(store, cfg, fit_sweeps=8, rel_tol=0.0,
                       check_every=8, vocab_pad=64, device="cpu", **kw)


def test_server_swaps_between_versions(tmp_path):
    store, _ = _store(tmp_path)
    pub = SnapshotPublisher(store, retain=2)
    pub.publish()
    srv = _server(store)
    srv.subscribe(pub)
    rng = np.random.default_rng(0)
    w = rng.integers(0, W, (2, 16)).astype(np.int32)
    c = np.ones_like(w, np.float32)
    th1 = srv.infer(w, c)
    assert srv.last_version == 1
    store.write_rows(np.array([1]), np.full((1, K), 9.0, np.float32))
    snap2 = pub.publish()
    old = srv._active
    assert srv.refresh() is True
    assert srv.refresh() is False          # idempotent at the same version
    th2 = srv.infer(w, c)
    assert srv.last_version == 2
    assert len(srv.swap_log) == 2          # subscribe() + the explicit swap
    assert srv.swap_log[-1]["version"] == 2
    # the OLD epoch's view still serves v1 rows: in-flight launches that
    # captured it before the swap are never torn
    assert old.fetch_rows(np.array([1]))[0, 0] != 9.0
    np.testing.assert_array_equal(
        srv._active.fetch_rows(np.array([1])), snap2.phi[1][None]
    )
    # swapping changed φ, so θ differs
    assert not np.array_equal(th1, th2)


def test_server_refuses_corrupt_snapshot(tmp_path):
    store, _ = _store(tmp_path)
    pub = SnapshotPublisher(store)
    snap = pub.publish()
    snap.phi.setflags(write=True)
    snap.phi[0, 0] += 1.0                  # torn publish
    srv = _server(store, hot_rows=0)
    with pytest.raises(RuntimeError, match="crc"):
        srv.subscribe(pub)


def test_hot_cache_epoch_invalidation_drops_only_changed_rows(tmp_path):
    store, phi = _store(tmp_path)
    pub = SnapshotPublisher(store)
    s1 = pub.publish()
    cache = HotRowCache(store, capacity=32)
    cache.install_version(s1.version, changed_ids=s1.changed_ids)
    ids = np.array([2, 3, 4, 5], np.int64)
    cache.fetch(ids, source=s1, version=s1.version)     # warm 4 rows
    store.write_rows(np.array([3]), np.full((1, K), 8.0, np.float32))
    s2 = pub.publish()
    dropped = cache.install_version(s2.version, changed_ids=s2.changed_ids)
    assert dropped == 1                    # only the changed resident row
    assert cache.resident_rows() == 3      # the Zipf head survived
    got = cache.fetch(ids, source=s2, version=s2.version)
    np.testing.assert_array_equal(got[1], np.full(K, 8.0, np.float32))
    np.testing.assert_array_equal(got[0], phi[2])
    win = cache.window_stats(reset=True)
    assert win.hits == 3 and win.misses == 5 and win.rows_dropped == 1
    # a straggler pinned to the old version bypasses the cache entirely
    before = cache.resident_rows()
    old_rows = cache.fetch(ids, source=s1, version=s1.version)
    np.testing.assert_array_equal(old_rows, s1.fetch_rows(ids))
    assert cache.resident_rows() == before  # no pollution from the old epoch


@pytest.mark.parametrize("retain", [3, 1])
def test_swap_over_skipped_versions_drops_their_rows(tmp_path, retain):
    """A swap from v1 straight to v3 drops the rows v2 changed too (the
    union of the retained deltas, or everything once v2 has aged out), so
    the cache never serves a v1 row under v3.  The JAX package drops only
    v3's delta here, and serves row 5 from v1."""
    store, phi = _store(tmp_path)
    pub = SnapshotPublisher(store, retain=retain)
    pub.publish()
    srv = _server(store, hot_rows=48)
    srv.subscribe(pub)
    ids = np.array([2, 5, 9], np.int64)
    w = np.tile(ids.astype(np.int32), (2, 1))
    srv.infer(w, np.ones_like(w, np.float32))
    assert srv.hot_cache.resident_rows() == 3
    store.write_rows(np.array([5]), np.full((1, K), 7.0, np.float32))
    pub.publish()                              # v2 changes row 5
    pub.publish()                              # v3 changes nothing
    assert srv.refresh() and srv.last_version == 1
    assert srv.hot_cache.resident_rows() == (2 if retain == 3 else 0)
    got = srv._fetch_rows(ids, srv._active)
    np.testing.assert_array_equal(got[1], np.full(K, 7.0, np.float32))
    np.testing.assert_array_equal(got[[0, 2]], phi[[2, 9]])


def test_engine_fails_the_bucket_of_a_corrupt_swap(tmp_path):
    """The launcher's hot-swap runs inside the launch's error handling: a
    snapshot failing its crc fails that bucket's futures, and the server
    stays pinned to the version it had."""
    store, _ = _store(tmp_path)
    pub = SnapshotPublisher(store)
    pub.publish()
    srv = _server(store)
    srv.subscribe(pub)
    snap = pub.publish()
    snap.phi.setflags(write=True)
    snap.phi[0, 0] += 1.0                   # torn v2
    with ServingEngine(srv, max_batch=4, max_delay_ms=1.0,
                       max_len=16) as eng:
        fut = eng.submit(np.array([1, 2, 3], np.int32))
        with pytest.raises(RuntimeError, match="crc"):
            fut.result(timeout=TIMEOUT)
        eng.drain()
        assert eng.metrics()["failed_batches"] == 1
    assert srv._active.version == 1 and srv.last_version == -1


def test_quantized_serving_version_close_to_f32(tmp_path):
    store, _ = _store(tmp_path)
    pub = SnapshotPublisher(store)
    pub.publish()
    rng = np.random.default_rng(3)
    w = rng.integers(0, W, (2, 16)).astype(np.int32)
    c = np.ones_like(w, np.float32)
    srv32 = _server(store, hot_rows=0)
    srv32.subscribe(pub)
    srv8 = _server(store, hot_rows=0, phi_dtype="int8")
    srv8.subscribe(pub)
    t32 = srv32.infer(w, c)
    t8 = srv8.infer(w, c)
    assert np.abs(t32 - t8).max() < 0.05   # int8 row quant ≈ f32 mixtures


# ---------------------------------------------------------------------------
# ShiftDetector wiring
# ---------------------------------------------------------------------------


def test_shift_detector_fires_and_latches_refresh():
    det = ShiftDetector(warmup=3, threshold=4.0)
    for i in range(6):
        det.update(step=i, residual_mass=10.0 + 0.01 * i, perplexity=500.0)
    assert det.consume_refresh() is False
    evs = det.update(step=6, residual_mass=400.0, perplexity=500.0)
    assert [e.kind for e in evs] == ["residual-shift"]
    assert det.consume_refresh() is True
    assert det.consume_refresh() is False  # latched: cleared on read
    evs = det.update(step=7, perplexity=5000.0)
    assert [e.kind for e in evs] == ["ppl-shift"]


def test_shift_detector_topic_birth_death():
    det = ShiftDetector(topic_floor_frac=0.05)
    det.update(step=0, phi_k=np.array([1.0, 1.0, 1.0, 1e-4]))
    evs = det.update(step=1, phi_k=np.array([1.0, 1e-4, 1.0, 1.0]))
    kinds = {(e.kind, e.topic) for e in evs}
    assert kinds == {("topic-birth", 3), ("topic-death", 1)}
    assert det.consume_refresh() is False  # birth/death alone: no refresh


def test_trainer_publishes_on_cadence_and_reports_metrics(tmp_path):
    corpus, _ = synthetic_lda_corpus(60, W, 4, mean_doc_len=20, seed=1)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=6)
    store = ParameterStore(str(tmp_path / "t"), num_topics=K,
                           vocab_capacity=W + 16, buffer_rows=0)
    pub = SnapshotPublisher(store, retain=3)
    det = ShiftDetector(warmup=2)
    tr = FOEMTrainer(cfg, store, seed=0, publisher=pub, publish_every=2,
                     shift_detector=det, device="cpu")
    ms = tr.fit_stream(
        iter(MinibatchStream(corpus, 30, seed=0, epochs=None)), max_steps=6
    )
    assert [m.published_version for m in ms] == [-1, 1, -1, 2, -1, 3]
    assert pub.version == 3
    assert all(np.isfinite(m.residual_mass) for m in ms)
    assert all(isinstance(m.shift_events, tuple) for m in ms)
    # cadence publishes are committed: each one flushed the WAL
    for snap_ver in (2, 3):
        snap = pub.get(snap_ver)
        assert snap is not None and snap.verify()


# ---------------------------------------------------------------------------
# The end-to-end train-while-serve scenario
# ---------------------------------------------------------------------------


def test_train_while_serve_end_to_end(tmp_path):
    """Trainer publishing on a cadence while the engine replays a traffic
    trace: every response used a committed version, nothing tears, and
    training is bitwise identical to a run without any serving."""
    corpus, _ = synthetic_lda_corpus(200, W, 4, mean_doc_len=24, seed=2)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=8)

    store = ParameterStore(str(tmp_path / "live"), num_topics=K,
                           vocab_capacity=W + 16, buffer_rows=16)
    pub = SnapshotPublisher(store, retain=2)
    trainer = FOEMTrainer(cfg, store, seed=5, publisher=pub,
                          publish_every=2, device="cpu")
    pub.publish()                              # v1: committed before traffic

    srv = _server(store)
    srv.subscribe(pub)
    gen = TrafficGenerator(W, doc_len=(4, 14), seed=9)
    trace = gen.trace([(500.0, 60)])

    errors = []

    def train_loop():
        try:
            trainer.fit_stream(
                iter(MinibatchStream(corpus, 50, seed=1, epochs=None)),
                max_steps=8,
            )
        except BaseException as e:
            errors.append(e)

    results = []
    with ServingEngine(srv, max_batch=8, max_delay_ms=2.0,
                       max_len=16) as eng:
        th = threading.Thread(target=train_loop)
        th.start()
        futs = TrafficGenerator.replay(trace, eng.submit, pace=False)
        for f in futs:
            results.append(f.result(timeout=TIMEOUT))
        th.join(timeout=TIMEOUT)
        assert not th.is_alive()
        srv.refresh()
        eng.drain()
        batch_log = list(eng.batch_log)
        m = eng.metrics()
    assert not errors, errors

    # ≥ 3 committed publishes (initial + cadence at steps 2, 4, 6, 8)
    assert pub.version >= 3
    committed = {rec["version"] for rec in pub.publish_log}

    # every response is tagged with a COMMITTED snapshot version
    assert len(results) == 60
    for theta in results:
        assert isinstance(theta, ThetaResult)
        assert theta.version in committed
        assert theta.shape == (K,)
        assert np.isfinite(np.asarray(theta)).all()

    # the launcher swaps monotonically: served versions never go backwards
    versions = [b["version"] for b in batch_log if b.get("version", -1) > 0]
    assert versions == sorted(versions)
    # ... and never ahead of the committed publish sequence
    assert all(
        b["version"] <= b["published_version"] for b in batch_log
        if b.get("version", -1) > 0
    )
    assert 0 <= m["max_staleness_versions"] <= pub.retain

    # retained snapshots are still consistent after all the traffic
    for rec in pub.publish_log:
        snap = pub.get(rec["version"])
        if snap is not None:
            assert snap.verify()

    # serving is read-only: training with traffic is BITWISE identical to
    # the same training run without any serving attached
    store2 = ParameterStore(str(tmp_path / "replica"), num_topics=K,
                            vocab_capacity=W + 16, buffer_rows=16)
    pub2 = SnapshotPublisher(store2, retain=2)
    trainer2 = FOEMTrainer(cfg, store2, seed=5, publisher=pub2,
                           publish_every=2, device="cpu")
    pub2.publish()
    trainer2.fit_stream(
        iter(MinibatchStream(corpus, 50, seed=1, epochs=None)), max_steps=8
    )
    np.testing.assert_array_equal(store.dense_phi(), store2.dense_phi())
    np.testing.assert_array_equal(store.phi_k, store2.phi_k)
    assert pub.latest().crc == pub2.latest().crc

    # held-out perplexity through the lifelong server matches a fresh
    # train-then-serve server on the replica store (same final φ)
    srv.refresh()
    srv2 = _server(store2, hot_rows=0)
    srv2.subscribe(pub2)
    ev_rng = np.random.default_rng(11)
    w, c = bucketize(corpus, list(range(48)), pad_multiple=16)
    est, ev = split_heldout_counts(c, ev_rng)
    _, p1 = srv.evaluate(w, est, ev)
    _, p2 = srv2.evaluate(w, est, ev)
    assert abs(p1 / p2 - 1.0) < 1e-3


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _quant_input():
    rng = np.random.default_rng(0)
    phi = rng.gamma(0.5, 3.0, (53, 37)).astype(np.float32)
    phi[4] = 0.0                                  # all-zero row: scale 1
    phi[5, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]   # halves at scale 1
    phi[5, 6:] = 0.0
    phi[6] *= -1.0
    return phi


@pytest.mark.parametrize("block", [streaming.QUANT_BLOCK_ROWS, 7])
def test_int8_quantize_bitwise_equal_to_jax(monkeypatch, block):
    monkeypatch.setattr(streaming, "QUANT_BLOCK_ROWS", block)
    phi = _quant_input()
    q, s = _host_quantize_rows(phi, "int8")
    jq, js = j_quantize(phi, "int8")
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))
    np.testing.assert_array_equal(q[5, :6], [127, 2, -4, 0, 0, 2])  # half-even
    assert s[4] == 1.0


@pytest.mark.parametrize("block", [streaming.QUANT_BLOCK_ROWS, 7])
def test_bf16_quantize_bitwise_equal_to_ml_dtypes(monkeypatch, block):
    pytest.importorskip("ml_dtypes")
    monkeypatch.setattr(streaming, "QUANT_BLOCK_ROWS", block)
    phi = _quant_input()
    bits = np.array([0x3F808000, 0x3F818000, 0x00000001, 0x7F7FFFFF,
                     0xBF800001, 0x7F800000], np.uint32)  # ties, subnormal,
    phi[7, :6] = bits.view(np.float32)                    # overflow, inf
    v, s = _host_quantize_rows(phi, "bfloat16")
    jv, js = j_quantize(phi, "bfloat16")
    assert s is None and js is None and v.dtype == torch.bfloat16
    np.testing.assert_array_equal(v.view(torch.int16).numpy().view(np.uint16),
                                  jv.view(np.uint16))


def _jax_and_port_stores(tmp_path):
    jstore, phi = _store(tmp_path, "jax", cls=JStore)
    pstore, pphi = _store(tmp_path, "port")
    np.testing.assert_array_equal(phi, pphi)
    return jstore, pstore


def test_snapshot_crc_equals_jax(tmp_path):
    jstore, pstore = _jax_and_port_stores(tmp_path)
    jpub, ppub = JPublisher(jstore, retain=2), SnapshotPublisher(pstore)
    js, ps = jpub.publish(), ppub.publish()
    assert ps.crc == js.crc
    np.testing.assert_array_equal(ps.changed_ids, js.changed_ids)
    for store in (jstore, pstore):
        store.write_rows(np.array([9, 2]), np.full((2, K), 3.25, np.float32))
        store.phi_k[0] += 1.0
        store.step += 1
    js, ps = jpub.publish(), ppub.publish()
    assert (ps.version, ps.write_version, ps.step, ps.crc) == (
        js.version, js.write_version, js.step, js.crc)
    np.testing.assert_array_equal(ps.changed_ids, js.changed_ids)
    assert [{k: r[k] for k in ("version", "step", "changed_rows")}
            for r in ppub.publish_log] == [
        {k: r[k] for k in ("version", "step", "changed_rows")}
        for r in jpub.publish_log]


def test_shift_detector_matches_jax_event_for_event():
    rng = np.random.default_rng(4)
    kw = dict(alpha=0.3, threshold=5.0, warmup=4, topic_floor_frac=0.1)
    port, ref = ShiftDetector(**kw), JShiftDetector(**kw)
    phi_k = rng.gamma(2.0, 1.0, 12)
    fired, refreshes = [], []
    for step in range(60):
        res = 100.0 + rng.normal(0, 1.0) + (300.0 if step in (20, 41) else 0)
        ppl = 900.0 + rng.normal(0, 5.0) + (4000.0 if step == 33 else 0)
        phi_k = phi_k * rng.uniform(0.7, 1.3, 12)
        phi_k[rng.integers(12)] *= rng.choice([1e-3, 1e3, 1.0])
        sig = dict(step=step,
                   residual_mass=float("nan") if step % 7 == 3 else res,
                   perplexity=float("nan") if step % 11 == 5 else ppl,
                   phi_k=None if step % 9 == 8 else phi_k)
        a, b = port.update(**sig), ref.update(**sig)
        assert [vars(e) for e in a] == [vars(e) for e in b], step
        fired += a
        refreshes.append((port.consume_refresh(), ref.consume_refresh()))
    assert all(x == y for x, y in refreshes)
    assert [vars(e) for e in port.events] == [vars(e) for e in ref.events]
    kinds = {e.kind for e in fired}
    assert {"residual-shift", "ppl-shift", "topic-birth",
            "topic-death"} <= kinds
    assert any(x for x, _ in refreshes)


@pytest.mark.parametrize("phi_dtype,hot_rows", [
    ("float32", 48), ("float32", 0), ("bfloat16", 0), ("int8", 48)])
def test_subscribed_server_matches_jax(tmp_path, phi_dtype, hot_rows):
    """Subscribed servers of both packages, over one store state, across a
    hot-swap: θ and eq. 21 at the serving tolerances, the same versions."""
    jstore, pstore = _jax_and_port_stores(tmp_path)
    jpub, ppub = JPublisher(jstore), SnapshotPublisher(pstore)
    jpub.publish()
    ppub.publish()
    kw = dict(fit_sweeps=20, check_every=5, vocab_pad=64,
              phi_dtype=phi_dtype, hot_rows=hot_rows)
    jsrv = JServer(jstore, JLDAConfig(num_topics=K, vocab_size=W), **kw)
    srv = TopicServer(pstore, LDAConfig(num_topics=K, vocab_size=W),
                      device="cpu", **kw)
    jsrv.subscribe(jpub)
    srv.subscribe(ppub)
    corpus, _ = synthetic_lda_corpus(24, W, 4, mean_doc_len=30, seed=11)
    w, c = bucketize(corpus, list(range(8)))
    est, ev = split_heldout_counts(c, np.random.default_rng(0))
    for version in (1, 2):
        if version == 2:
            rows = np.random.default_rng(5).gamma(1.0, 1e4, (6, K))
            for store, pub, s in ((jstore, jpub, jsrv), (pstore, ppub, srv)):
                store.write_rows(np.arange(10, 16), rows.astype(np.float32))
                store.phi_k[:] += rows.sum(0)
                pub.publish()
                assert s.refresh() is True
        want = jsrv.infer(w, c)
        got = srv.infer(w, c, theta0=_jax_theta0(c, K))
        assert srv.last_version == jsrv.last_version == version
        assert srv.last_sweeps == jsrv.last_sweeps
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        jt, jppl = jsrv.evaluate(w, est, ev)
        t, ppl = srv.evaluate(w, est, ev, theta0=_jax_theta0(est, K))
        np.testing.assert_allclose(t, jt, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ppl, jppl, rtol=1e-5)
    assert [s["version"] for s in srv.swap_log] == [
        s["version"] for s in jsrv.swap_log] == [1, 2]
    assert [s["changed_rows"] for s in srv.swap_log] == [
        s["changed_rows"] for s in jsrv.swap_log] == [W, 6]


def test_trainer_publish_sequence_matches_jax(tmp_path):
    corpus, _ = synthetic_lda_corpus(60, W, 4, mean_doc_len=20, seed=1)
    kw = dict(num_topics=K, vocab_size=W, max_sweeps=4)
    logs = []
    for name, Store, Pub, Trainer, Stream, cfg, extra in (
            ("jax", JStore, JPublisher, JTrainer, JStream,
             JLDAConfig(**kw), {}),
            ("port", ParameterStore, SnapshotPublisher, FOEMTrainer,
             MinibatchStream, LDAConfig(**kw), {"device": "cpu"})):
        store = Store(str(tmp_path / name), num_topics=K,
                      vocab_capacity=W + 16, buffer_rows=0)
        pub = Pub(store, retain=3)
        ms = Trainer(cfg, store, seed=0, publisher=pub, publish_every=2,
                     prefetch_depth=1, **extra).fit_stream(
            iter(Stream(corpus, 30, seed=0, epochs=None)), max_steps=6)
        logs.append(([m.published_version for m in ms],
                     [(r["version"], r["step"], r["changed_rows"])
                      for r in pub.publish_log]))
    assert logs[0] == logs[1]
    assert logs[1][0] == [-1, 1, -1, 2, -1, 3]


def _latched_detector(cls):
    """A detector whose refresh is latched through its public API: after
    one observation, any change beats ``threshold × dev`` with dev = 0."""
    det = cls(warmup=1)
    det.update(step=0, residual_mass=1.0)
    assert [e.kind for e in det.update(step=1, residual_mass=2.0)] == [
        "residual-shift"]
    return det


def test_refresh_step_runs_extra_dense_sweeps_like_jax(tmp_path, monkeypatch):
    """A latched refresh gives the next step ``warmup_sweeps +
    refresh_extra_sweeps`` dense sweeps; the port's refreshed step agrees
    with the JAX trainer's from one store and one μ₀ (rtol 1e-4)."""
    W_, K_ = 150, 8
    jcorpus, _ = synthetic_lda_corpus(120, W_, K_, mean_doc_len=30, seed=11)
    kw = dict(num_topics=K_, vocab_size=W_, max_sweeps=8, active_topics=3,
              ppl_check_every=2)
    base = tmp_path / "base"
    jstore = JStore(str(base), num_topics=K_, vocab_capacity=W_,
                    buffer_rows=64)
    JTrainer(JLDAConfig(**kw), jstore, seed=0, prefetch_depth=0).fit_stream(
        iter(JStream(jcorpus, 40, seed=0, epochs=None)), max_steps=2)
    del jstore
    shutil.copytree(base, tmp_path / "jax")
    shutil.copytree(base, tmp_path / "port")
    mb = list(zip(range(3), MinibatchStream(jcorpus, 40, seed=0,
                                            epochs=None)))[2][1]
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    mu0 = np.array(uniform_responsibilities(
        sub, mb.local_word_ids.shape + (K_,)))

    dense = []
    sweep = em.gs_sweep_with_residuals

    def counted(*a, **k):
        dense.append(1)
        return sweep(*a, **k)

    monkeypatch.setattr(em, "gs_sweep_with_residuals", counted)
    jst = JStore(str(tmp_path / "jax"), num_topics=K_, vocab_capacity=W_,
                 buffer_rows=64)
    jm = JTrainer(JLDAConfig(**kw), jst, seed=0, prefetch_depth=0,
                  shift_detector=_latched_detector(JShiftDetector)).step(mb)
    jst.flush()
    pst = ParameterStore(str(tmp_path / "port"), num_topics=K_,
                         vocab_capacity=W_, buffer_rows=64)
    tr = FOEMTrainer(LDAConfig(**kw), pst, seed=0, prefetch_depth=0,
                     shift_detector=_latched_detector(ShiftDetector),
                     refresh_extra_sweeps=2, mu0_fn=lambda _: mu0,
                     device="cpu")
    pm = tr.step(mb)
    pst.flush()
    assert pm.scheduler_refresh and jm.scheduler_refresh
    assert len(dense) == LDAConfig(**kw).warmup_sweeps + 2 == 4
    assert pm.sweeps == jm.sweeps
    np.testing.assert_allclose(pm.train_ppl, jm.train_ppl, rtol=1e-4)
    np.testing.assert_allclose(pst.dense_phi(), jst.dense_phi(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pst.phi_k, jst.phi_k, rtol=1e-4)
    # without a latched shift a step runs the configured warm-ups
    tr.shift_detector = ShiftDetector()
    dense.clear()
    nxt = list(zip(range(4), MinibatchStream(jcorpus, 40, seed=0,
                                             epochs=None)))[3][1]
    assert not tr.step(nxt).scheduler_refresh
    assert len(dense) == LDAConfig(**kw).warmup_sweeps == 2


def test_run_lifelong_quick_on_cpu_has_the_jax_report_keys(tmp_path, capsys):
    from repro.launch.lifelong import run_lifelong as j_run

    report = lifelong.main(["--quick", "--device", "cpu",
                            "--workdir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "lifelong: 6 train steps, 4 publishes" in out
    want = j_run(workdir=str(tmp_path / "jax"), topics=8, vocab=64, docs=32,
                 minibatch=32, steps=2, publish_every=1, requests=8,
                 doc_len=(4, 12), max_batch=8, fit_sweeps=4, hot_rows=16,
                 prewarm=False)
    assert set(report) == set(want)
    assert report["failed_requests"] == 0
    assert report["uncommitted_versions"] == []
    assert report["publishes"] == 4 and report["train_steps"] == 6
    assert 0 <= report["staleness_versions_max"] <= 2
    assert report["served_version_min"] >= 1
    assert report["recompiled"] is False
    assert 1.0 < report["heldout_ppl"] < 512
