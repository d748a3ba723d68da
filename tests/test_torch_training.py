"""Port's streaming FOEM trainer vs the JAX package, on the CPU.

* ``foem_minibatch`` given the JAX package's μ₀, scheduling on and off:
  the same number of sweeps, and φ̂, φ̂(k) and the final training
  perplexity within rtol 1e-4.  Why that tolerance: the two packages take
  float32 sums over K and over a column's documents in different orders
  (a few ulps, ~1e-7 relative, per sweep), and up to ten Gauss-Seidel
  sweeps carry those differences forward; the eq. 36 top-A selection is
  discrete, so the inputs are seeded away from near-ties.
* The JAX ``FOEMTrainer`` writes a store for two steps; the port's trainer
  and the JAX trainer each continue a copy of it for one more step with the
  same μ₀, and the two stores agree (rtol 1e-4, the same reason).
* Within the port: prefetch depth 0, 1 and 2 give bitwise-equal stores; the
  stream prefetcher's version token; the store's flush/restart and
  crash-after-flush cases (``tests/test_streaming_store.py``); the
  minibatch stream equals the JAX package's; the eq. 33/20 merges; and the
  train CLI runs two steps with ``--device cpu``.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FOEMTrainer as JTrainer
from repro.core import ParameterStore as JStore
from repro.core import foem as jfoem
from repro.core.types import GlobalStats as JGlobalStats
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import MinibatchData as JMinibatchData
from repro.core.types import uniform_responsibilities
from repro.data import synthetic_lda_corpus as j_corpus
from repro.sparse import MinibatchStream as JStream
from repro_torch.core import (
    FOEMTrainer,
    GlobalStats,
    LDAConfig,
    MinibatchData,
    ParameterStore,
    StreamPrefetcher,
    foem,
    from_numpy,
    store_from_arrays,
)
from repro_torch.data import synthetic_lda_corpus
from repro_torch.launch import train as train_cli
from repro_torch.sparse import MinibatchStream, prefetch_iterator

RTOL = 1e-4


def _jax_mu0(key, shape):
    return np.array(uniform_responsibilities(key, shape))


def _batch(D, L, W, seed):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 5, (D, L)).astype(np.float32)
    cnt[:, -2:] = 0.0                       # a padded tail
    return wid, cnt


# ---------------------------------------------------------------------------
# (c) foem_minibatch with the JAX μ₀
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active_topics,frac", [(0, 1.0), (3, 1.0),
                                                (4, 0.8)])
def test_foem_minibatch_matches_jax(active_topics, frac):
    D, L, K, W = 12, 10, 8, 48
    cfg_kw = dict(num_topics=K, vocab_size=W, max_sweeps=9,
                  ppl_check_every=3, active_topics=active_topics,
                  active_words_frac=frac)
    wid, cnt = _batch(D, L, W, seed=active_topics + 1)
    rng = np.random.default_rng(5)
    phi_in = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32) * 4
    phi_k_in = phi_in.sum(0)
    key = jax.random.PRNGKey(active_topics)
    want = jfoem.foem_minibatch(
        key, JMinibatchData(jnp.asarray(wid), jnp.asarray(cnt)),
        jnp.asarray(phi_in), jnp.asarray(phi_k_in), JLDAConfig(**cfg_kw),
        vocab_size=500)
    got = foem.foem_minibatch(
        None, MinibatchData(wid, cnt), phi_in, phi_k_in, LDAConfig(**cfg_kw),
        vocab_size=500, mu0=_jax_mu0(key, (D, L, K)), device="cpu")
    assert got.diag.sweeps_run == int(want.diag.sweeps_run)
    np.testing.assert_allclose(got.phi_wk.numpy(), np.asarray(want.phi_wk),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got.phi_k.numpy(), np.asarray(want.phi_k),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.diag.final_train_ppl),
                               float(want.diag.final_train_ppl), rtol=RTOL)
    np.testing.assert_allclose(float(got.diag.residual_mass),
                               float(want.diag.residual_mass), rtol=1e-3)


def test_foem_minibatch_stops_on_the_rule():
    """A loose tolerance stops at the first check sweep after warm-up; the
    cap holds otherwise."""
    D, L, K, W = 8, 6, 5, 30
    wid, cnt = _batch(D, L, W, seed=2)
    phi = np.zeros((W, K), np.float32)
    gen = torch.Generator().manual_seed(0)
    loose = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=20,
                      ppl_check_every=4, ppl_rel_tol=10.0)
    r = foem.foem_minibatch(gen, MinibatchData(wid, cnt), phi, phi[0], loose,
                            device="cpu")
    assert r.diag.sweeps_run == 4
    tight = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=7,
                      ppl_check_every=4, ppl_rel_tol=0.0)
    r = foem.foem_minibatch(gen, MinibatchData(wid, cnt), phi, phi[0], tight,
                            device="cpu")
    assert r.diag.sweeps_run == 7
    np.testing.assert_allclose(float(r.phi_k.sum()), float(cnt.sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("rho_mode", ["accumulate", "stepwise"])
def test_foem_step_matches_jax(rho_mode):
    D, L, K, W = 8, 6, 5, 20
    wid, cnt = _batch(D, L, W, seed=9)
    rng = np.random.default_rng(1)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    kw = dict(num_topics=K, vocab_size=W, max_sweeps=4, rho_mode=rho_mode)
    key = jax.random.PRNGKey(3)
    jstats = JGlobalStats(jnp.asarray(phi), jnp.asarray(phi.sum(0)),
                          jnp.int32(2))
    want, _, wdiag = jfoem.foem_step(
        key, JMinibatchData(jnp.asarray(wid), jnp.asarray(cnt)), jstats,
        JLDAConfig(**kw), stream_scale=3.0)
    stats = from_numpy(jax.device_get(jstats))
    assert isinstance(stats, GlobalStats) and int(stats.step) == 2
    got, _, diag = foem.foem_step(
        None, MinibatchData(wid, cnt), stats, LDAConfig(**kw),
        stream_scale=3.0, mu0=_jax_mu0(key, (D, L, K)), device="cpu")
    assert int(got.step) == int(want.step) == 3
    assert diag.sweeps_run == int(wdiag.sweeps_run)
    np.testing.assert_allclose(got.phi_wk.numpy(), np.asarray(want.phi_wk),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got.phi_k.numpy(), np.asarray(want.phi_k),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# (d) the two trainers continue one store
# ---------------------------------------------------------------------------

def test_trainers_continue_one_store_to_the_same_stats(tmp_path):
    # K = 8, A = 3: at K = 5, A = 2 this store's post-warm-up residuals hold
    # near-ties that flip the top-A selection on last-bit differences — the
    # JAX package's own jitted and eager inner loops then disagree by ~5
    # tokens in φ̂ — so the comparison would measure the ties, not the port
    W, K = 150, 8
    corpus, _ = j_corpus(120, W, K, mean_doc_len=30, seed=11)
    jcfg = JLDAConfig(num_topics=K, vocab_size=W, max_sweeps=6,
                      active_topics=3, ppl_check_every=2)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=6,
                    active_topics=3, ppl_check_every=2)
    base = tmp_path / "base"
    jstore = JStore(str(base), num_topics=K, vocab_capacity=W,
                    buffer_rows=64)
    JTrainer(jcfg, jstore, seed=0, prefetch_depth=0).fit_stream(
        iter(JStream(corpus, 40, seed=0, epochs=None)), max_steps=2)
    del jstore
    shutil.copytree(base, tmp_path / "jax")
    shutil.copytree(base, tmp_path / "port")
    mb = list(zip(range(3), MinibatchStream(corpus, 40, seed=0,
                                            epochs=None)))[2][1]
    # a fresh JAX trainer's first step draws μ₀ from split(PRNGKey(seed))[1]
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    mu0 = _jax_mu0(sub, mb.local_word_ids.shape + (K,))

    jst = JStore(str(tmp_path / "jax"), num_topics=K, vocab_capacity=W,
                 buffer_rows=64)
    jm = JTrainer(jcfg, jst, seed=0, prefetch_depth=0).step(mb)
    jst.flush()
    pst = ParameterStore(str(tmp_path / "port"), num_topics=K,
                         vocab_capacity=W, buffer_rows=64)
    assert pst.step == 2
    pm = FOEMTrainer(cfg, pst, seed=0, prefetch_depth=0,
                     mu0_fn=lambda _: mu0, device="cpu").step(mb)
    pst.flush()
    assert pm.step == jm.step == 3 and pm.sweeps == jm.sweeps
    np.testing.assert_allclose(pm.train_ppl, jm.train_ppl, rtol=RTOL)
    np.testing.assert_allclose(pst.dense_phi(), jst.dense_phi(), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(pst.phi_k, jst.phi_k, rtol=RTOL)
    assert pst.live_vocab == jst.live_vocab


def test_store_from_jax_global_stats(tmp_path):
    """A JAX GlobalStats carried across as numpy becomes a port store with
    its rows, totals and step."""
    rng = np.random.default_rng(0)
    phi = rng.gamma(1.0, 1.0, (40, 6)).astype(np.float32)
    js = jax.device_get(JGlobalStats(jnp.asarray(phi),
                                     jnp.asarray(phi.sum(0)), jnp.int32(7)))
    s = store_from_arrays(str(tmp_path / "g"), js, live_vocab=40)
    np.testing.assert_array_equal(s.fetch_rows(np.arange(40)), phi)
    np.testing.assert_allclose(s.phi_k, phi.sum(0), rtol=1e-6)
    assert s.step == 7


# ---------------------------------------------------------------------------
# (e) prefetch on/off within the port
# ---------------------------------------------------------------------------

def _port_run(tmp_path, depth, *, buffer_rows=64, steps=5, tag=""):
    corpus, _ = synthetic_lda_corpus(120, 150, 5, mean_doc_len=30, seed=11)
    cfg = LDAConfig(num_topics=5, vocab_size=150, max_sweeps=5,
                    active_topics=2, ppl_check_every=2)
    store = ParameterStore(str(tmp_path / f"d{depth}{tag}"), num_topics=5,
                           vocab_capacity=150, buffer_rows=buffer_rows)
    tr = FOEMTrainer(cfg, store, seed=0, prefetch_depth=depth, device="cpu")
    ms = tr.fit_stream(iter(MinibatchStream(corpus, 40, seed=0, epochs=None)),
                       max_steps=steps)
    return store.dense_phi().copy(), np.array(store.phi_k), ms


@pytest.mark.parametrize("depth,buffer_rows", [(1, 64), (2, 64), (1, 0)])
def test_prefetch_is_bitwise_deterministic(tmp_path, depth, buffer_rows):
    phi0, k0, _ = _port_run(tmp_path, 0, buffer_rows=buffer_rows)
    phi1, k1, ms = _port_run(tmp_path, depth, buffer_rows=buffer_rows)
    np.testing.assert_array_equal(phi0, phi1)
    np.testing.assert_array_equal(k0, k1)
    assert len(ms) == 5 and all(m.sweeps >= 2 for m in ms)
    assert all(m.compute_seconds > 0 for m in ms)


def test_stream_prefetcher_reconciliation_token(tmp_path):
    store = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=32,
                           buffer_rows=8)

    class _MB:
        def __init__(self, ids):
            self.local_vocab = np.asarray(ids, np.int64)

    pf = StreamPrefetcher(store, [_MB([1, 2, 3])], depth=1)
    try:
        (staged, _wait), = list(pf)
    finally:
        pf.close()
    v_after = store.write_rows(np.array([2]), np.ones((1, 4), np.float32))
    assert staged.version < v_after
    assert store.fetch_rows_versioned(np.array([2]))[1] == v_after


def test_minibatch_stream_matches_jax():
    corpus, _ = j_corpus(90, 120, 4, mean_doc_len=20, seed=3)
    a = list(zip(range(4), JStream(corpus, 20, seed=5, epochs=None)))
    b = list(zip(range(4), MinibatchStream(corpus, 20, seed=5,
                                           epochs=None)))
    for (_, x), (_, y) in zip(a, b):
        for f in ("word_ids", "counts", "local_vocab", "local_word_ids"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        assert x.index == y.index
    assert list(prefetch_iterator(iter(range(7)), depth=2)) == list(range(7))


# ---------------------------------------------------------------------------
# (f) store flush/restart and crash-after-flush
# ---------------------------------------------------------------------------

def _mk(path, buffer_rows=0, K=8, W=100):
    return ParameterStore(str(path), num_topics=K, vocab_capacity=W,
                          buffer_rows=buffer_rows)


def test_flush_restart_restores_state(tmp_path):
    st = _mk(tmp_path, buffer_rows=4)
    ids = np.array([5, 6])
    st.write_rows(ids, np.full((2, 8), 3.0, np.float32))
    st.phi_k = np.full(8, 1.5)
    st.step = 17
    st.ensure_vocab(6)
    st.flush()
    st2 = _mk(tmp_path, buffer_rows=4)
    np.testing.assert_allclose(st2.fetch_rows(ids), 3.0)
    np.testing.assert_allclose(st2.phi_k, 1.5)
    assert st2.step == 17 and st2.live_vocab == 7
    with pytest.raises(ValueError):
        st2.ensure_vocab(100)


def test_dirty_rows_survive_crash_after_flush(tmp_path):
    st = _mk(tmp_path, buffer_rows=8)
    st.write_rows(np.array([1]), np.full((1, 8), 9.0, np.float32))
    st.flush()
    del st                                      # simulated crash
    st2 = _mk(tmp_path, buffer_rows=0)
    np.testing.assert_allclose(st2.fetch_rows(np.array([1])), 9.0)


def test_pipeline_counters_and_window(tmp_path):
    st = _mk(tmp_path, buffer_rows=2)
    st.fetch_rows(np.array([1, 2, 3]))
    assert st.bump_pipeline_stats(overlap_seconds=0.5,
                                  prefetch_hit=True) == (3, 0, 0)
    w = st.stats_window()
    assert (w.disk_reads, w.prefetch_hits, w.overlap_seconds) == (3, 1, 0.5)
    assert st.stats_window().disk_reads == 0


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------

def test_train_cli_two_steps_on_cpu(tmp_path, capsys):
    train_cli.main(["--workdir", str(tmp_path / "cli"), "--steps", "2",
                    "--topics", "8", "--vocab", "300", "--docs", "120",
                    "--minibatch", "32", "--max-sweeps", "4",
                    "--active-topics", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2
    ppl = float(out.strip().splitlines()[-1].split(":")[-1])
    assert np.isfinite(ppl) and 1.0 < ppl < 300
    st = ParameterStore(str(tmp_path / "cli"), num_topics=8,
                        vocab_capacity=300)
    assert st.step == 2
