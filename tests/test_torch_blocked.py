"""The coarse-block and ``"scan"`` FOEM paths and the SEM baseline vs the JAX
package, on the CPU.

Every comparison injects the JAX package's initial μ₀ and feeds both
packages the same numpy-seeded data; the JAX side runs its plain path (its
E-steps go through ``ref.fused_estep_ref`` / ``ref.topk_estep_ref`` on this
host), the port its kernels' plain versions.  Tolerances:

* one sweep or one E-step: rtol 2e-5 and atol 1e-5 scaled by the array's
  magnitude (the reference's kernel-vs-portable tolerance,
  ``tests/test_gs_sweep.py``): float32 sums over K and over a block's
  tokens are taken in another order, a few ulps apart;
* inner loops, steps and trainers: rtol 1e-4 (``tests/test_torch_training``'s
  reason: up to a dozen sweeps carry those ulps forward); the scheduled
  cases use K = 8, A = 3, where the eq. 36 top-A selection has no
  near-ties that a last-bit difference could flip.

Also here: the single-document serial-IEM oracle (``iem_exact_numpy``), the
BEM/IEM loglik curves, the residual helpers on the blocked path's (D, L, A)
token topics, the train CLI with ``--algorithm sem --iem-blocks 4``, and
the trainer's φ̂(k) repair: the store's φ̂(k) grows by the rows' float64
increment, not by the inner loop's running total.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FOEMTrainer as JTrainer
from repro.core import ParameterStore as JStore
from repro.core import em as jem
from repro.core import foem as jfoem
from repro.core import scheduling as jsched
from repro.core import sem as jsem
from repro.core.types import GlobalStats as JGlobalStats
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import LocalState as JLocalState
from repro.core.types import MinibatchData as JMinibatchData
from repro.core.types import SchedulerState as JSchedulerState
from repro.core.types import uniform_responsibilities
from repro.data import synthetic_lda_corpus as j_corpus
from repro.sparse import MinibatchStream as JStream
from repro_torch.core import (
    FOEMTrainer,
    GlobalStats,
    LDAConfig,
    LocalState,
    MinibatchData,
    ParameterStore,
    SchedulerState,
    em,
    foem,
    scheduling,
    sem,
)
from repro_torch.core import trainer as trainer_mod
from repro_torch.launch import train as train_cli
from repro_torch.sparse import MinibatchStream

RTOL = 1e-4


def _close(x, y, name, rtol=2e-5, atol=1e-5):
    y = np.asarray(y)
    scale = max(1.0, float(np.abs(y).max())) if y.size else 1.0
    np.testing.assert_allclose(np.asarray(x), y, rtol=rtol,
                               atol=atol * scale, err_msg=name)


def _state(D, L, K, W, seed):
    """A minibatch state with duplicate words in a column, zero counts and
    a padded tail column, its μ folded into φ̂ (a consistent working
    copy)."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = np.array(jem.fold_phi(jnp.asarray(mu), jnp.asarray(cnt),
                                jnp.asarray(wid), W)[0])
    phi = phi + rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    return wid, cnt, mu, theta, phi, phi.sum(0)


def _both(wid, cnt, mu, theta):
    jb = JMinibatchData(jnp.asarray(wid), jnp.asarray(cnt))
    jl = JLocalState(jnp.asarray(mu), jnp.asarray(theta))
    pb = MinibatchData(torch.from_numpy(wid), torch.from_numpy(cnt))
    pl = LocalState(torch.from_numpy(mu), torch.from_numpy(theta))
    return jb, jl, pb, pl


def _jax_mu0(key, shape):
    return np.array(uniform_responsibilities(key, shape))


# ---------------------------------------------------------------------------
# E-step and sweeps
# ---------------------------------------------------------------------------

def test_estep_matches_jax_with_and_without_exclusion():
    D, L, K, W = 5, 7, 9, 11
    wid, cnt, mu, theta, phi, ptot = _state(D, L, K, W, 1)
    rows = phi[wid]
    ex = cnt[..., None] * mu
    jcfg = JLDAConfig(num_topics=K, vocab_size=W)
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    t = torch.from_numpy
    for th_rows in (theta[:, None, :], np.repeat(theta[:, None, :], L, 1)):
        for exclude in (None, ex):
            want = jem.estep(jnp.asarray(th_rows), jnp.asarray(rows),
                             jnp.asarray(ptot), jcfg, vocab_size=400,
                             exclude=None if exclude is None
                             else jnp.asarray(exclude))
            got = em.estep(t(np.ascontiguousarray(th_rows)), t(rows),
                           t(ptot), cfg, vocab_size=400,
                           exclude=None if exclude is None else t(exclude))
            _close(got.numpy(), want, "mu")


@pytest.mark.parametrize("blocks,impl", [(2, "fused"), (3, "fused"),
                                         (0, "scan"), (4, "scan")])
def test_blocked_iem_sweep_matches_jax(blocks, impl):
    """Coarse blocks (3 blocks of L = 8 leave a ragged last block) and the
    ``"scan"`` sweep (B = L columns of the legacy scan when blocks = 0)."""
    D, L, K, W = 6, 8, 5, 11
    wid, cnt, mu, theta, phi, ptot = _state(D, L, K, W, blocks + 3)
    jb, jl, pb, pl = _both(wid, cnt, mu, theta)
    kw = dict(num_topics=K, vocab_size=W, iem_blocks=blocks, sweep_impl=impl)
    jloc, jdwk, jdk = jem.blocked_iem_sweep(
        jb, jl, jnp.asarray(phi), jnp.asarray(ptot), JLDAConfig(**kw),
        vocab_size=300)
    loc, dwk, dk = em.blocked_iem_sweep(pb, pl, torch.from_numpy(phi),
                                        torch.from_numpy(ptot),
                                        LDAConfig(**kw), vocab_size=300)
    _close(loc.mu.numpy(), jloc.mu, "mu")
    _close(loc.theta_dk.numpy(), jloc.theta_dk, "theta")
    _close(dwk.numpy(), jdwk, "delta phi_wk")
    _close(dk.numpy(), jdk, "delta phi_k")
    # mass: the sweep moves responsibility mass, it does not create it
    np.testing.assert_allclose(loc.theta_dk.sum(-1).numpy(), cnt.sum(1),
                               rtol=1e-5)
    np.testing.assert_allclose(dwk.sum(0).numpy(), dk.numpy(), atol=1e-4)


def test_blocked_sweep_modifies_no_input():
    D, L, K, W = 4, 6, 5, 7
    wid, cnt, mu, theta, phi, ptot = _state(D, L, K, W, 9)
    args = [torch.from_numpy(x.copy()) for x in (mu, theta, phi, ptot)]
    cfg = LDAConfig(num_topics=K, vocab_size=W, iem_blocks=2,
                    active_topics=3)
    batch = MinibatchData(torch.from_numpy(wid), torch.from_numpy(cnt))
    local = LocalState(args[0], args[1])
    em.blocked_iem_sweep(batch, local, args[2], args[3], cfg)
    r = torch.rand((W, K), generator=torch.Generator().manual_seed(0))
    foem.scheduled_iem_sweep(batch, local, args[2], args[3],
                             SchedulerState(r, r.sum(-1)), cfg)
    for a, b in zip(args, (mu, theta, phi, ptot)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("blocks,impl,frac", [(2, "fused", 1.0),
                                              (3, "fused", 0.7),
                                              (0, "scan", 1.0)])
@pytest.mark.parametrize("loglik", [False, True])
def test_blocked_scheduled_sweep_matches_jax(blocks, impl, frac, loglik):
    D, L, K, W, A = 6, 8, 8, 12, 3
    wid, cnt, mu, theta, phi, ptot = _state(D, L, K, W, blocks + 11)
    jb, jl, pb, pl = _both(wid, cnt, mu, theta)
    r = np.random.default_rng(blocks).gamma(1.0, 1.0, (W, K)).astype(
        np.float32)
    kw = dict(num_topics=K, vocab_size=W, iem_blocks=blocks, sweep_impl=impl,
              active_topics=A, active_words_frac=frac)
    want = jfoem.scheduled_iem_sweep(
        jb, jl, jnp.asarray(phi), jnp.asarray(ptot),
        JSchedulerState(jnp.asarray(r), jnp.asarray(r.sum(-1))),
        JLDAConfig(**kw), vocab_size=300, compute_loglik=loglik)
    got = foem.scheduled_iem_sweep(
        pb, pl, torch.from_numpy(phi), torch.from_numpy(ptot),
        SchedulerState(torch.from_numpy(r), torch.from_numpy(r.sum(-1))),
        LDAConfig(**kw), vocab_size=300, compute_loglik=loglik)
    _close(got[0].mu.numpy(), want[0].mu, "mu")
    _close(got[0].theta_dk.numpy(), want[0].theta_dk, "theta")
    _close(got[1].numpy(), want[1], "phi_wk")
    _close(got[2].numpy(), want[2], "phi_k")
    _close(got[3].r_wk.numpy(), want[3].r_wk, "r_wk")
    _close(got[3].r_w.numpy(), want[3].r_w, "r_w")
    if loglik:
        np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    else:
        assert got[4] is None and want[4] is None


def test_residual_helpers_match_jax_on_token_topics():
    """``scatter_residuals``/``update_residuals`` on the blocked path's
    (D, L, A) token topics (duplicate (word, topic) pairs inside the
    batch), and ``full_sweep_residuals``."""
    D, L, K, W, A = 7, 6, 9, 5, 4
    rng = np.random.default_rng(3)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    wt = np.stack([rng.choice(K, A, replace=False) for _ in range(W)]
                  ).astype(np.int32)
    tt = wt[wid]
    absd = rng.random((D, L, A)).astype(np.float32)
    js, jt = jsched.scatter_residuals(jnp.asarray(absd), jnp.asarray(wid),
                                      jnp.asarray(tt), W, K)
    ps, pt = scheduling.scatter_residuals(torch.from_numpy(absd),
                                          torch.from_numpy(wid),
                                          torch.from_numpy(tt), W, K)
    _close(ps.numpy(), js, "summed")
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    r0 = rng.random((W, K)).astype(np.float32)
    jn = jsched.update_residuals(
        JSchedulerState(jnp.asarray(r0), jnp.asarray(r0.sum(-1))), js, jt)
    pn = scheduling.update_residuals(
        SchedulerState(torch.from_numpy(r0), torch.from_numpy(r0.sum(-1))),
        ps, pt)
    _close(pn.r_wk.numpy(), jn.r_wk, "r_wk")
    _close(pn.r_w.numpy(), jn.r_w, "r_w")
    mu_new = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    mu_old = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    cnt = rng.integers(0, 4, (D, L)).astype(np.float32)
    jf = jsched.full_sweep_residuals(*map(jnp.asarray,
                                          (mu_new, mu_old, cnt, wid)), W)
    pf = scheduling.full_sweep_residuals(*map(torch.from_numpy,
                                              (mu_new, mu_old, cnt, wid)), W)
    _close(pf.r_wk.numpy(), jf.r_wk, "full r_wk")
    _close(pf.r_w.numpy(), jf.r_w, "full r_w")


# ---------------------------------------------------------------------------
# The inner loop
# ---------------------------------------------------------------------------

def _batch(D, L, W, seed):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 5, (D, L)).astype(np.float32)
    cnt[:, -2:] = 0.0
    return wid, cnt


@pytest.mark.parametrize("blocks,impl,active_topics", [
    (4, "fused", 3), (4, "fused", 0), (0, "scan", 3), (3, "scan", 0)])
def test_foem_minibatch_blocked_matches_jax(blocks, impl, active_topics):
    D, L, K, W = 12, 10, 8, 48
    cfg_kw = dict(num_topics=K, vocab_size=W, max_sweeps=9,
                  ppl_check_every=3, active_topics=active_topics,
                  iem_blocks=blocks, sweep_impl=impl)
    wid, cnt = _batch(D, L, W, seed=blocks + active_topics)
    rng = np.random.default_rng(5)
    phi_in = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32) * 4
    key = jax.random.PRNGKey(blocks)
    want = jfoem.foem_minibatch(
        key, JMinibatchData(jnp.asarray(wid), jnp.asarray(cnt)),
        jnp.asarray(phi_in), jnp.asarray(phi_in.sum(0)),
        JLDAConfig(**cfg_kw), vocab_size=500)
    got = foem.foem_minibatch(
        None, MinibatchData(wid, cnt), phi_in, phi_in.sum(0),
        LDAConfig(**cfg_kw), vocab_size=500, mu0=_jax_mu0(key, (D, L, K)),
        device="cpu")
    assert got.diag.sweeps_run == int(want.diag.sweeps_run)
    np.testing.assert_allclose(got.phi_wk.numpy(), np.asarray(want.phi_wk),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got.phi_k.numpy(), np.asarray(want.phi_k),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.diag.final_train_ppl),
                               float(want.diag.final_train_ppl), rtol=RTOL)
    np.testing.assert_allclose(float(got.diag.residual_mass),
                               float(want.diag.residual_mass), rtol=1e-3)


def test_bem_and_iem_fit_loglik_curves_match_jax():
    """BEM climbs monotonically (eq. 12), and the BEM and IEM (B = L and
    B = 4) curves agree with the JAX package's sweep for sweep."""
    corpus, _ = j_corpus(60, 120, 5, mean_doc_len=30, seed=2)
    mb = next(iter(JStream(corpus, 24, seed=0, epochs=1)))
    K, W = 5, 120
    mu0 = np.asarray(jax.random.dirichlet(
        jax.random.PRNGKey(1), jnp.ones(K), mb.word_ids.shape)
        ).astype(np.float32)
    jb = JMinibatchData(jnp.asarray(mb.word_ids), jnp.asarray(mb.counts))
    pb = MinibatchData(torch.from_numpy(mb.word_ids),
                       torch.from_numpy(mb.counts))
    for blocks in (0, 4):
        kw = dict(num_topics=K, vocab_size=W, iem_blocks=blocks)
        jcfg, cfg = JLDAConfig(**kw), LDAConfig(**kw)
        _, _, _, jb_ll = jem.bem_fit(jb, jnp.asarray(mu0), jcfg, sweeps=8)
        _, _, _, pb_ll = em.bem_fit(pb, torch.from_numpy(mu0), cfg, sweeps=8)
        np.testing.assert_allclose(pb_ll.numpy(), np.asarray(jb_ll),
                                   rtol=1e-5)
        assert np.all(np.diff(pb_ll.numpy()) >= -1e-2)
        _, jphi, _, ji_ll = jem.iem_fit(jb, jnp.asarray(mu0), jcfg, sweeps=8)
        loc, phi, ptot, pi_ll = em.iem_fit(pb, torch.from_numpy(mu0), cfg,
                                           sweeps=8)
        np.testing.assert_allclose(pi_ll.numpy(), np.asarray(ji_ll),
                                   rtol=1e-5)
        _close(phi.numpy(), jphi, "phi", rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(float(ptot.sum()), float(mb.counts.sum()),
                                   rtol=1e-4)


def test_blocked_iem_matches_serial_oracle_single_doc():
    """B == L blocked IEM ≡ the paper's serial per-non-zero IEM (Fig. 2),
    through the scan and through the fused sweep; the port's oracle is the
    JAX package's, bit for bit."""
    rng = np.random.default_rng(0)
    L, K, W = 8, 5, 40
    word_ids = rng.permutation(W)[:L].reshape(1, L).astype(np.int32)
    counts = rng.integers(1, 5, size=(1, L)).astype(np.float32)
    mu0 = rng.dirichlet(np.ones(K), size=(1, L)).astype(np.float32)
    out = em.iem_exact_numpy(word_ids, counts, mu0,
                             LDAConfig(num_topics=K, vocab_size=W), sweeps=4)
    ref = jem.iem_exact_numpy(word_ids, counts, mu0,
                              JLDAConfig(num_topics=K, vocab_size=W),
                              sweeps=4)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    mu_np, _, phi_np = out
    batch = MinibatchData(torch.from_numpy(word_ids),
                          torch.from_numpy(counts))
    for impl in ("scan", "fused"):
        cfg = LDAConfig(num_topics=K, vocab_size=W, sweep_impl=impl)
        local, phi, _, _ = em.iem_fit(batch, torch.from_numpy(mu0), cfg,
                                      sweeps=4, num_blocks=L)
        np.testing.assert_allclose(local.mu.numpy(), mu_np, atol=2e-5)
        np.testing.assert_allclose(phi.numpy(), phi_np, atol=2e-4)


# ---------------------------------------------------------------------------
# SEM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rho_mode", ["accumulate", "stepwise"])
def test_sem_step_matches_jax(rho_mode):
    D, L, K, W = 10, 8, 6, 40
    wid, cnt = _batch(D, L, W, seed=4)
    rng = np.random.default_rng(2)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    kw = dict(num_topics=K, vocab_size=W, max_sweeps=12, ppl_check_every=3,
              rho_mode=rho_mode)
    key = jax.random.PRNGKey(7)
    jstats = JGlobalStats(jnp.asarray(phi), jnp.asarray(phi.sum(0)),
                          jnp.int32(4))
    want, wloc, wdiag = jsem.sem_step(
        key, JMinibatchData(jnp.asarray(wid), jnp.asarray(cnt)), jstats,
        JLDAConfig(**kw), stream_scale=2.0, vocab_size=300)
    got, loc, diag = sem.sem_step(
        None, MinibatchData(wid, cnt),
        GlobalStats(phi, phi.sum(0), np.int32(4)), LDAConfig(**kw),
        stream_scale=2.0, vocab_size=300, mu0=_jax_mu0(key, (D, L, K)),
        device="cpu")
    assert diag.sweeps_run == int(wdiag.sweeps_run)
    assert int(got.step) == int(want.step) == 5
    np.testing.assert_allclose(float(diag.final_train_ppl),
                               float(wdiag.final_train_ppl), rtol=RTOL)
    np.testing.assert_allclose(got.phi_wk.numpy(), np.asarray(want.phi_wk),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got.phi_k.numpy(), np.asarray(want.phi_k),
                               rtol=RTOL)
    _close(loc.theta_dk.numpy(), wloc.theta_dk, "theta", rtol=RTOL,
           atol=RTOL)


def test_sem_step_refuses_out_of_range_words():
    from repro_torch.kernels.ops import ContractError

    wid, cnt = _batch(3, 4, 9, seed=1)
    phi = np.ones((8, 3), np.float32)
    with pytest.raises(ContractError, match="word_ids"):
        sem.sem_step(torch.Generator(), MinibatchData(wid, cnt),
                     GlobalStats(phi, phi.sum(0), np.int32(0)),
                     LDAConfig(num_topics=3, vocab_size=9), device="cpu")


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm,blocks", [("foem", 4), ("sem", 0)])
def test_trainers_continue_one_store_to_the_same_stats(tmp_path, algorithm,
                                                       blocks):
    """The JAX trainer writes a store for two steps; each package's trainer
    continues a copy for one more step with the same μ₀.  K = 8, A = 3 (see
    the module docstring)."""
    W, K = 150, 8
    corpus, _ = j_corpus(120, W, K, mean_doc_len=30, seed=11)
    kw = dict(num_topics=K, vocab_size=W, max_sweeps=6, active_topics=3,
              ppl_check_every=2, iem_blocks=blocks)
    jcfg, cfg = JLDAConfig(**kw), LDAConfig(**kw)
    base = tmp_path / "base"
    jstore = JStore(str(base), num_topics=K, vocab_capacity=W,
                    buffer_rows=64)
    JTrainer(jcfg, jstore, seed=0, prefetch_depth=0,
             algorithm=algorithm).fit_stream(
        iter(JStream(corpus, 40, seed=0, epochs=None)), max_steps=2)
    del jstore
    shutil.copytree(base, tmp_path / "jax")
    shutil.copytree(base, tmp_path / "port")
    mb = list(zip(range(3), MinibatchStream(corpus, 40, seed=0,
                                            epochs=None)))[2][1]
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    mu0 = _jax_mu0(sub, mb.local_word_ids.shape + (K,))

    jst = JStore(str(tmp_path / "jax"), num_topics=K, vocab_capacity=W,
                 buffer_rows=64)
    jm = JTrainer(jcfg, jst, seed=0, prefetch_depth=0,
                  algorithm=algorithm).step(mb)
    jst.flush()
    pst = ParameterStore(str(tmp_path / "port"), num_topics=K,
                         vocab_capacity=W, buffer_rows=64)
    pm = FOEMTrainer(cfg, pst, seed=0, prefetch_depth=0, algorithm=algorithm,
                     mu0_fn=lambda _: mu0, device="cpu").step(mb)
    pst.flush()
    assert pm.step == jm.step == 3 and pm.sweeps == jm.sweeps
    np.testing.assert_allclose(pm.train_ppl, jm.train_ppl, rtol=RTOL)
    np.testing.assert_allclose(pst.dense_phi(), jst.dense_phi(), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(pst.phi_k, jst.phi_k, rtol=RTOL)
    if algorithm == "sem":
        assert np.isnan(pm.residual_mass)
    else:
        np.testing.assert_allclose(pm.residual_mass, jm.residual_mass,
                                   rtol=1e-3)


def test_foem_store_phi_k_follows_the_rows(tmp_path, monkeypatch):
    """The repair: a FOEM step adds the rows' float64 increment to the
    store's φ̂(k), whatever running total the inner loop returns.  The
    patched inner loop returns φ̂(k) offset from its rows by 3 tokens per
    topic; the store ignores the offset.  SEM stores its own φ̂(k), as the
    JAX package does."""
    W, K = 60, 4
    corpus, _ = j_corpus(40, W, K, mean_doc_len=20, seed=3)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=3)
    store = ParameterStore(str(tmp_path / "s"), num_topics=K,
                           vocab_capacity=W)
    rng = np.random.default_rng(0)
    store.write_rows(np.arange(W), rng.gamma(1.0, 1.0, (W, K)).astype(
        np.float32) * 10)
    store.ensure_vocab(W - 1)
    store.phi_k = store.dense_phi().astype(np.float64).sum(0)
    real = foem.foem_minibatch

    def offset(*args, **kw):
        res = real(*args, **kw)
        return res._replace(phi_k=res.phi_wk.sum(0) + 3.0)

    monkeypatch.setattr(trainer_mod.foem, "foem_minibatch", offset)
    tr = FOEMTrainer(cfg, store, seed=0, prefetch_depth=0, device="cpu")
    mbs = list(zip(range(2), MinibatchStream(corpus, 16, seed=0,
                                             epochs=None)))
    for _, mb in mbs:
        before_rows = store.fetch_rows(mb.local_vocab).astype(np.float64)
        before_k = store.phi_k.copy()
        tr.step(mb)
        after_rows = store.fetch_rows(mb.local_vocab).astype(np.float64)
        growth = (after_rows - before_rows).sum(0)
        np.testing.assert_allclose(store.phi_k - before_k, growth,
                                   rtol=1e-12, atol=1e-6)
        np.testing.assert_allclose(growth.sum(), mb.counts.sum(), rtol=1e-5)
    np.testing.assert_allclose(store.phi_k,
                               store.dense_phi().astype(np.float64).sum(0),
                               rtol=1e-9)

    real_sem = sem.sem_step

    def sem_offset(*args, **kw):
        stats, local, diag = real_sem(*args, **kw)
        return stats._replace(phi_k=stats.phi_k + 3.0), local, diag

    monkeypatch.setattr(trainer_mod.sem, "sem_step", sem_offset)
    st = FOEMTrainer(cfg, store, seed=0, prefetch_depth=0, algorithm="sem",
                     device="cpu")
    before_k = store.phi_k.copy()
    _, mb = mbs[0]
    before_rows = store.fetch_rows(mb.local_vocab).astype(np.float64)
    m = st.step(mb)
    growth = (store.fetch_rows(mb.local_vocab).astype(np.float64)
              - before_rows).sum(0)
    np.testing.assert_allclose(store.phi_k - before_k, growth + 3.0,
                               rtol=1e-4, atol=1e-2)
    assert np.isnan(m.residual_mass)


def test_trainer_rejects_an_unknown_algorithm(tmp_path):
    store = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=8)
    with pytest.raises(ValueError, match="algorithm"):
        FOEMTrainer(LDAConfig(num_topics=4, vocab_size=8), store,
                    algorithm="ovb", device="cpu")


def test_prefetch_is_bitwise_deterministic_blocked_and_sem(tmp_path):
    corpus, _ = j_corpus(120, 150, 5, mean_doc_len=30, seed=11)
    out = {}
    for algorithm, blocks in (("foem", 3), ("sem", 0)):
        for depth in (0, 1):
            cfg = LDAConfig(num_topics=5, vocab_size=150, max_sweeps=5,
                            active_topics=2, ppl_check_every=2,
                            iem_blocks=blocks)
            store = ParameterStore(str(tmp_path / f"{algorithm}{depth}"),
                                   num_topics=5, vocab_capacity=150,
                                   buffer_rows=64)
            FOEMTrainer(cfg, store, seed=0, prefetch_depth=depth,
                        algorithm=algorithm, device="cpu").fit_stream(
                iter(MinibatchStream(corpus, 40, seed=0, epochs=None)),
                max_steps=4)
            out[depth] = (store.dense_phi().copy(), store.phi_k.copy())
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_array_equal(out[0][1], out[1][1])


def test_train_cli_sem_and_blocks_on_cpu(tmp_path, capsys):
    for extra in (["--algorithm", "sem", "--iem-blocks", "4"],
                  ["--iem-blocks", "4"]):
        wd = tmp_path / "-".join(extra)
        train_cli.main(["--workdir", str(wd), "--steps", "2",
                        "--topics", "8", "--vocab", "300", "--docs", "120",
                        "--minibatch", "32", "--max-sweeps", "4",
                        "--active-topics", "3", "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert out.count("step ") == 2
        ppl = float(out.strip().splitlines()[-1].split(":")[-1])
        assert np.isfinite(ppl) and 1.0 < ppl < 300
        st = ParameterStore(str(wd), num_topics=8, vocab_capacity=300)
        assert st.step == 2


def test_blocked_and_sem_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    store = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=8)
    cfg = LDAConfig(num_topics=4, vocab_size=8, iem_blocks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FOEMTrainer(cfg, store, algorithm="sem")
    phi = np.ones((8, 4), np.float32)
    w, c = np.zeros((2, 3), np.int32), np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sem.sem_step(None, MinibatchData(w, c),
                     GlobalStats(phi, phi.sum(0), np.int32(0)), cfg,
                     mu0=np.full((2, 3, 4), 0.25, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--workdir", str(tmp_path / "cli"), "--steps", "1",
                        "--algorithm", "sem"])
    cfg2 = dataclasses.replace(cfg, sweep_impl="scan")
    res = foem.foem_minibatch(None, MinibatchData(w, c), phi, phi.sum(0),
                              cfg2, mu0=np.full((2, 3, 4), 0.25, np.float32),
                              device="cpu")
    assert res.phi_wk.device.type == "cpu"
