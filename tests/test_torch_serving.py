"""Port serving path vs the JAX package: the shared store format and the
``TopicServer`` round trip on the CPU.

* A store the JAX ``ParameterStore`` wrote (``write_rows`` + ``flush``), and
  one the JAX ``FOEMTrainer`` wrote after a few steps, open in the port with
  bitwise-equal rows and ``phi_k``; ``store_from_arrays`` round-trips and
  opens in the JAX package.
* The port store's WAL flush/recover, readonly ``attach`` and
  ``HotRowCache`` behave as the JAX store's do.
* ``TopicServer.infer``/``evaluate``/``infer_stream`` with ``device="cpu"``
  match the JAX ``TopicServer`` given the JAX package's θ̂₀ (rtol 1e-4 /
  atol 1e-5, eq. 21 perplexity rtol 1e-5) and are deterministic per seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ParameterStore as JStore
from repro.core import em as jem
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import uniform_responsibilities
from repro.data import synthetic_lda_corpus as j_corpus
from repro.launch.serve import TopicServer as JServer
from repro.sparse.docword import bucketize as j_bucketize
from repro_torch.core import (
    HotRowCache,
    LDAConfig,
    ParameterStore,
    store_from_arrays,
)
from repro_torch.core.perplexity import split_heldout_counts
from repro_torch.data import synthetic_lda_corpus
from repro_torch.launch.serve import TopicServer, TrafficGenerator
from repro_torch.runtime import FaultPlan, FaultSpec, InjectedFault, MID_FLUSH
from repro_torch.sparse import bucketize, localize_vocab


def _jax_store(path, W, K, seed=0, buffer_rows=32):
    """The JAX package's trained store (``_trained_store`` of
    ``tests/test_theta_sweep.py``), flushed to disk."""
    rng = np.random.default_rng(seed)
    store = JStore(str(path), num_topics=K, vocab_capacity=W,
                   buffer_rows=buffer_rows)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    store.write_rows(np.arange(W), phi)
    store.phi_k[:] = phi.sum(0)
    store.ensure_vocab(W - 1)
    store.flush()
    return store, phi


def _jax_theta0(key, counts, K):
    mu0 = uniform_responsibilities(key, counts.shape + (K,))
    return np.asarray(jem.fold_theta(mu0, jnp.asarray(counts)))


# ---------------------------------------------------------------------------
# The shared on-disk format
# ---------------------------------------------------------------------------

def test_jax_store_opens_in_port(tmp_path):
    W, K = 120, 6
    jstore, phi = _jax_store(tmp_path / "s", W, K)
    port = ParameterStore(str(tmp_path / "s"), num_topics=K,
                          vocab_capacity=W, buffer_rows=16)
    ids = np.array([3, 0, 119, 57, 8])
    np.testing.assert_array_equal(port.fetch_rows(ids),
                                  jstore.fetch_rows(ids))
    np.testing.assert_array_equal(port.fetch_rows(np.arange(W)), phi)
    np.testing.assert_array_equal(port.phi_k, jstore.phi_k)
    assert port.phi_k.dtype == np.float64
    assert (port.live_vocab, port.step, port.flush_version) == (
        jstore.live_vocab, jstore.step, jstore.flush_version)


def test_jax_trainer_store_opens_in_port(tmp_path):
    from repro.core import FOEMTrainer
    from repro.sparse import MinibatchStream

    W, K = 150, 5
    corpus, _ = j_corpus(80, W, K, mean_doc_len=30, seed=11)
    cfg = JLDAConfig(num_topics=K, vocab_size=W, max_sweeps=4)
    jstore = JStore(str(tmp_path / "t"), num_topics=K, vocab_capacity=W,
                    buffer_rows=64)
    tr = FOEMTrainer(cfg, jstore, seed=0, prefetch_depth=0)
    tr.fit_stream(iter(MinibatchStream(corpus, 40, seed=0, epochs=None)),
                  max_steps=2)
    jstore.flush()
    port = ParameterStore.attach(str(tmp_path / "t"), num_topics=K,
                                 vocab_capacity=W)
    ids = np.arange(W)
    np.testing.assert_array_equal(port.fetch_rows(ids),
                                  jstore.fetch_rows(ids))
    np.testing.assert_array_equal(port.phi_k, jstore.phi_k)
    assert port.step == jstore.step == 2
    assert port.phi_k.sum() > 0


def test_store_from_arrays_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    W, K = 50, 4
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    s = store_from_arrays(str(tmp_path / "a"), phi, live_vocab=W, step=3)
    np.testing.assert_allclose(s.phi_k, phi.sum(0, dtype=np.float64))
    again = ParameterStore(str(tmp_path / "a"), num_topics=K,
                           vocab_capacity=W)
    np.testing.assert_array_equal(again.fetch_rows(np.arange(W)), phi)
    np.testing.assert_array_equal(again.phi_k, s.phi_k)
    assert (again.step, again.live_vocab, again.flush_version) == (3, W, 1)
    # the JAX package reads the port's store as it is
    j = JStore(str(tmp_path / "a"), num_topics=K, vocab_capacity=W)
    np.testing.assert_array_equal(j.fetch_rows(np.arange(W)), phi)
    np.testing.assert_array_equal(j.phi_k, s.phi_k)
    # row blocks with explicit totals
    blocks = [phi[:20], phi[20:]]
    b = store_from_arrays(str(tmp_path / "b"), iter(blocks),
                          np.ones(K), live_vocab=W, vocab_capacity=W)
    np.testing.assert_array_equal(b.phi_k, np.ones(K))
    with pytest.raises(FileExistsError):
        store_from_arrays(str(tmp_path / "b"), phi, live_vocab=W)


def test_port_wal_flush_recover_and_attach(tmp_path):
    W, K = 40, 3
    rng = np.random.default_rng(2)
    base = rng.random((W, K)).astype(np.float32)
    store_from_arrays(str(tmp_path / "w"), base, live_vocab=W)
    plan = FaultPlan([FaultSpec(point=MID_FLUSH, kind="kill", step=0)])
    s = ParameterStore(str(tmp_path / "w"), num_topics=K, vocab_capacity=W,
                       buffer_rows=8, faults=plan)
    new = base[:4] + 1.0
    s.write_rows(np.arange(4), new)
    with pytest.raises(InjectedFault):
        s.flush()                       # killed before the WAL commit
    old = ParameterStore(str(tmp_path / "w"), num_topics=K, vocab_capacity=W)
    np.testing.assert_array_equal(old.fetch_rows(np.arange(4)), base[:4])
    assert old.flush_version == 1
    s.flush()                           # one-shot fault consumed: commits
    reopened = ParameterStore(str(tmp_path / "w"), num_topics=K,
                              vocab_capacity=W)
    np.testing.assert_array_equal(reopened.fetch_rows(np.arange(4)), new)
    assert reopened.flush_version == 2
    ro = ParameterStore.attach(str(tmp_path / "w"), num_topics=K,
                               vocab_capacity=W)
    np.testing.assert_array_equal(ro.fetch_rows(np.arange(4)), new)
    with pytest.raises(PermissionError):
        ro.write_rows(np.arange(1), new[:1])


def test_hot_row_cache_hits_and_invalidation(tmp_path):
    W, K = 64, 4
    phi = np.arange(W * K, dtype=np.float32).reshape(W, K)
    store = store_from_arrays(str(tmp_path / "c"), phi, live_vocab=W)
    store = ParameterStore(str(tmp_path / "c"), num_topics=K,
                           vocab_capacity=W, buffer_rows=16)
    cache = HotRowCache(store, capacity=8)
    ids = np.array([1, 5, 9])
    np.testing.assert_array_equal(cache.fetch(ids), phi[ids])
    np.testing.assert_array_equal(cache.fetch(ids), phi[ids])
    s = cache.window_stats()
    assert (s.hits, s.misses) == (3, 3)
    assert store.stats.promotions == 0          # never double-cached
    store.write_rows(np.array([5]), np.full((1, K), -1.0, np.float32))
    out = cache.fetch(ids)                      # version moved: refetch
    assert (out[1] == -1.0).all()
    assert cache.stats.invalidations == 1
    cache.fetch(np.arange(20, 32))              # overflow evicts LRU rows
    assert cache.resident_rows() == 8


# ---------------------------------------------------------------------------
# TopicServer parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active", [0, 2])
def test_topic_server_infer_matches_jax(tmp_path, active):
    K, W = 6, 200
    _jax_store(tmp_path / "s", W, K)
    jstore = JStore(str(tmp_path / "s"), num_topics=K, vocab_capacity=W,
                    buffer_rows=32)
    port = ParameterStore.attach(str(tmp_path / "s"), num_topics=K,
                                 vocab_capacity=W)
    corpus, _ = synthetic_lda_corpus(24, W, 4, mean_doc_len=30, seed=11)
    w, c = bucketize(corpus, list(range(8)))
    kw = dict(fit_sweeps=20, check_every=5, active_topics=active)
    jsrv = JServer(jstore, JLDAConfig(num_topics=K, vocab_size=W), **kw)
    srv = TopicServer(port, LDAConfig(num_topics=K, vocab_size=W),
                      device="cpu", **kw)
    want = jsrv.infer(w, c)                     # JAX default key
    theta0 = _jax_theta0(jax.random.PRNGKey(0), c, K)
    got = srv.infer(w, c, theta0=theta0)
    assert srv.last_sweeps == jsrv.last_sweeps
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-4)


def test_topic_server_evaluate_matches_jax(tmp_path):
    K, W = 5, 160
    _jax_store(tmp_path / "s", W, K, seed=3)
    jstore = JStore(str(tmp_path / "s"), num_topics=K, vocab_capacity=W)
    port = ParameterStore.attach(str(tmp_path / "s"), num_topics=K,
                                 vocab_capacity=W)
    corpus, _ = synthetic_lda_corpus(21, W, 4, mean_doc_len=25, seed=5)
    w, c = bucketize(corpus, list(range(8)))
    est, ev = split_heldout_counts(c, np.random.default_rng(0))
    for phi_dtype in ("float32", "int8"):
        kw = dict(fit_sweeps=20, check_every=5, phi_dtype=phi_dtype)
        jsrv = JServer(jstore, JLDAConfig(num_topics=K, vocab_size=W), **kw)
        srv = TopicServer(port, LDAConfig(num_topics=K, vocab_size=W),
                          device="cpu", **kw)
        jt, jppl = jsrv.evaluate(w, est, ev)
        theta0 = _jax_theta0(jax.random.PRNGKey(0), est, K)
        t, ppl = srv.evaluate(w, est, ev, theta0=theta0)
        np.testing.assert_allclose(t, jt, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ppl, jppl, rtol=1e-5)
        assert 1.0 < ppl < W


def test_topic_server_stream_matches_jax(tmp_path, monkeypatch):
    """infer_stream batch i starts from the JAX stream's θ̂₀ of batch i
    (``fold_in(PRNGKey(0), i)``), injected through ``infer``."""
    K, W = 5, 160
    _jax_store(tmp_path / "s", W, K, seed=3)
    jstore = JStore(str(tmp_path / "s"), num_topics=K, vocab_capacity=W)
    port = ParameterStore.attach(str(tmp_path / "s"), num_topics=K,
                                 vocab_capacity=W)
    corpus, _ = synthetic_lda_corpus(21, W, 4, mean_doc_len=25, seed=5)
    ids = list(range(corpus.num_docs))
    kw = dict(fit_sweeps=20, check_every=5, active_topics=2)
    jsrv = JServer(jstore, JLDAConfig(num_topics=K, vocab_size=W), **kw)
    srv = TopicServer(port, LDAConfig(num_topics=K, vocab_size=W),
                      device="cpu", **kw)
    want = list(jsrv.infer_stream(corpus, ids, batch_size=8))
    calls = []
    infer = srv.infer

    def with_jax_init(w, c, *, seed=0, theta0=None):
        key = jax.random.fold_in(jax.random.PRNGKey(0), len(calls))
        calls.append(seed)
        return infer(w, c, theta0=_jax_theta0(key, c, K))

    monkeypatch.setattr(srv, "infer", with_jax_init)
    got = list(srv.infer_stream(corpus, ids, batch_size=8))
    assert [ch for ch, _ in got] == [ch for ch, _ in want] == [
        ids[:8], ids[8:16], ids[16:]]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert len(set(calls)) == 3                 # a distinct seed per batch


def test_topic_server_deterministic_per_seed(tmp_path):
    K, W = 6, 300
    gen = TrafficGenerator(W, seed=2)
    from repro_torch.data import trained_like_phi_blocks

    store = store_from_arrays(
        str(tmp_path / "d"),
        trained_like_phi_blocks(W, K, ranks=gen.word_ranks(), seed=1),
        live_vocab=W, vocab_capacity=W)
    srv = TopicServer(store, LDAConfig(num_topics=K, vocab_size=W),
                      fit_sweeps=20, check_every=5, hot_rows=256,
                      device="cpu")
    corpus = gen.corpus(12)
    w, c = bucketize(corpus, list(range(12)), pad_multiple=16)
    a, b = srv.infer(w, c), srv.infer(w, c)
    np.testing.assert_array_equal(a, b)         # same seed: same bits
    other = srv.infer(w, c, seed=1)
    assert not np.array_equal(a, other)         # another init stream
    np.testing.assert_allclose(other, a, atol=0.05)   # same fixed point
    assert srv.hot_cache.stats.hits > 0
    uniq, _ = localize_vocab(w)
    assert srv.hot_cache.resident_rows() == len(uniq)


def test_docword_copy_matches_jax():
    """The port's numpy copies draw the same corpus and buckets."""
    a, pa = synthetic_lda_corpus(30, 90, 4, mean_doc_len=20, seed=3)
    b, pb = j_corpus(30, 90, 4, mean_doc_len=20, seed=3)
    np.testing.assert_array_equal(pa, pb)
    for x, y in zip(bucketize(a, list(range(30)), pad_multiple=16),
                    j_bucketize(b, list(range(30)), pad_multiple=16)):
        np.testing.assert_array_equal(x, y)
