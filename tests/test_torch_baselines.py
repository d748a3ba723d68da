"""The paper's online baselines in the port (``repro_torch.core.baselines``)
against the JAX package's (``repro.core.baselines``), on the CPU.

* OVB and SCVB with the JAX package's μ₀ (``uniform_responsibilities``)
  injected: φ̂, φ̂(k), θ̂ and the training perplexity at rtol 1e-4 — float32
  sums over K and over the minibatch in another order, and torch's digamma
  against XLA's (OVB), carried through 8–12 sweeps, as in
  ``test_torch_training.py``.
* OGS with the JAX package's z₀ and per-sweep Gumbel draws injected: the
  sampled topics (μ = one-hot(z)·counts) and θ̂ bit for bit — integer-count
  sums, exact in any order.  The merged φ̂ matches to 1e-6 relative: the
  step size ρ = (τ0+s)^(−κ) comes from XLA's and torch's ``pow``, which
  differ by one float32 ulp; at κ = 0 (ρ = 1) the merged φ̂ is the
  minibatch's counts times stream_scale and matches bit for bit.  The
  logits differ by an ulp of ``log`` between the packages, so a seed whose
  Gumbel-perturbed logits hold an exact-to-the-ulp argmax tie could pick
  another topic; the seeds here hold none.
* Port-only copies of ``tests/test_baselines_perplexity.py``: each step runs,
  FOEM beats OVB on predictive perplexity (× 1.15), SCVB's mass equals
  SEM's.
* The OVB and SCVB E-steps through ``ops.fused_estep`` equal the JAX
  package's formulas (rtol 1e-5: one normalisation in float32), each sweep
  is one ``ops.fused_estep`` call (OGS makes none), inputs are untouched,
  and ``debug_checks=True`` raises ``ContractError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.types import GlobalStats as JGlobalStats
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import MinibatchData as JMinibatchData
from repro.core.types import uniform_responsibilities
from repro_torch.core import (
    GlobalStats,
    LDAConfig,
    MinibatchData,
    baselines,
    foem,
    sem,
)
from repro_torch.core.perplexity import (
    predictive_perplexity,
    split_heldout_counts,
)
from repro_torch.data import synthetic_lda_corpus
from repro_torch.kernels import ops as kops
from repro_torch.sparse import MinibatchStream
from repro_torch.sparse.docword import bucketize

RTOL = 1e-4
D, L, K, W = 10, 8, 6, 40


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 5, (D, L)).astype(np.float32)
    cnt[:, -2:] = 0.0
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    return wid, cnt, phi


def _jax(fn, key, wid, cnt, phi, step, cfg, **kw):
    return fn(key, JMinibatchData(jnp.asarray(wid), jnp.asarray(cnt)),
              JGlobalStats(jnp.asarray(phi), jnp.asarray(phi.sum(0)),
                           jnp.int32(step)),
              JLDAConfig(**cfg), **kw)


def _port(fn, wid, cnt, phi, step, cfg, **kw):
    return fn(None, MinibatchData(wid, cnt),
              GlobalStats(phi, phi.sum(0), np.int32(step)), LDAConfig(**cfg),
              device="cpu", **kw)


# ---------------------------------------------------------------------------
# OVB and SCVB against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ovb", "scvb"])
@pytest.mark.parametrize("sweeps,step,scale", [(8, 0, 1.0), (12, 3, 2.0)])
def test_ovb_scvb_match_jax(algo, sweeps, step, scale):
    wid, cnt, phi = _batch()
    cfg = dict(num_topics=K, vocab_size=W, max_sweeps=sweeps,
               rho_mode="stepwise")
    key = jax.random.PRNGKey(7 + step)
    want, wloc, wdiag = _jax(getattr(jb, f"{algo}_step"), key, wid, cnt,
                             phi, step, cfg, stream_scale=scale)
    mu0 = np.array(uniform_responsibilities(key, (D, L, K)))
    got, loc, diag = _port(baselines.ALGORITHMS[algo], wid, cnt, phi, step,
                           cfg, stream_scale=scale, mu0=mu0)
    assert diag.sweeps_run == int(wdiag.sweeps_run) == sweeps
    assert int(got.step) == int(want.step) == step + 1
    np.testing.assert_allclose(got.phi_wk.numpy(), np.asarray(want.phi_wk),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got.phi_k.numpy(), np.asarray(want.phi_k),
                               rtol=RTOL)
    np.testing.assert_allclose(loc.theta_dk.numpy(),
                               np.asarray(wloc.theta_dk), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(loc.mu.numpy(), np.asarray(wloc.mu),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(diag.final_train_ppl),
                               float(wdiag.final_train_ppl), rtol=RTOL)


# ---------------------------------------------------------------------------
# OGS against the JAX package, with its draws injected
# ---------------------------------------------------------------------------

def _jax_ogs_draws(key, sweeps):
    """The JAX ``ogs_step``'s z₀ and Gumbel draws, rebuilt from its key:
    ``categorical`` is ``argmax(gumbel(k, logits.shape) + logits)``."""
    k0, key = jax.random.split(key)
    z0 = np.array(jax.random.randint(k0, (D, L), 0, K))
    gumbel = [np.array(jax.random.gumbel(k, (D, L, K), jnp.float32))
              for k in jax.random.split(key, sweeps)]
    return z0, gumbel


@pytest.mark.parametrize("seed,kappa,step,scale", [
    (0, 0.9, 0, 1.0), (1, 0.9, 3, 2.0), (2, 0.0, 0, 1.0), (3, 0.0, 5, 3.0)])
def test_ogs_matches_jax(seed, kappa, step, scale):
    wid, cnt, phi = _batch()
    cfg = dict(num_topics=K, vocab_size=W, kappa=kappa)
    key = jax.random.PRNGKey(seed)
    want, wloc, wdiag = _jax(jb.ogs_step, key, wid, cnt, phi, step, cfg,
                             stream_scale=scale, gibbs_sweeps=6)
    z0, gumbel = _jax_ogs_draws(key, 6)
    got, loc, diag = _port(baselines.ogs_step, wid, cnt, phi, step, cfg,
                           stream_scale=scale, gibbs_sweeps=6, z0=z0,
                           gumbel=gumbel)
    assert diag.sweeps_run == int(wdiag.sweeps_run) == 6
    # the sampled topics and every integer-count sum: bit for bit
    np.testing.assert_array_equal(loc.mu.numpy(), np.asarray(wloc.mu))
    np.testing.assert_array_equal(loc.theta_dk.numpy(),
                                  np.asarray(wloc.theta_dk))
    if kappa == 0.0:      # ρ = 1: φ̂ = stream_scale · the minibatch's counts
        np.testing.assert_array_equal(got.phi_wk.numpy(),
                                      np.asarray(want.phi_wk))
        np.testing.assert_array_equal(got.phi_k.numpy(),
                                      np.asarray(want.phi_k))
    np.testing.assert_allclose(got.phi_wk.numpy(), np.asarray(want.phi_wk),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.phi_k.numpy(), np.asarray(want.phi_k),
                               rtol=1e-6)
    np.testing.assert_allclose(float(diag.final_train_ppl),
                               float(wdiag.final_train_ppl), rtol=RTOL)


def test_ogs_draws_from_its_generator():
    """Without injected draws OGS samples from the generator: the same seed
    gives the same step, another seed other topics; the stats hold exactly
    the minibatch's tokens."""
    wid, cnt, phi = _batch()
    cfg = LDAConfig(num_topics=K, vocab_size=W, kappa=0.0)
    stats = GlobalStats(np.zeros_like(phi), np.zeros(K, np.float32),
                        np.int32(0))

    def run(seed):
        return baselines.ogs_step(torch.Generator().manual_seed(seed),
                                  MinibatchData(wid, cnt), stats, cfg,
                                  device="cpu")

    a, la, _ = run(0)
    b, lb, _ = run(0)
    _, lc, _ = run(1)
    assert torch.equal(la.mu, lb.mu) and torch.equal(a.phi_wk, b.phi_wk)
    assert not torch.equal(la.mu, lc.mu)
    assert float(a.phi_k.sum()) == float(cnt.sum())
    np.testing.assert_array_equal(la.theta_dk.sum(1).numpy(), cnt.sum(1))
    with pytest.raises(ValueError, match="gibbs_sweeps"):
        baselines.ogs_step(torch.Generator(), MinibatchData(wid, cnt), stats,
                           cfg, gibbs_sweeps=3, gumbel=[None] * 2,
                           device="cpu")
    with pytest.raises(ValueError, match="generator"):
        baselines.ogs_step(None, MinibatchData(wid, cnt), stats, cfg,
                           device="cpu")
    with pytest.raises(ValueError, match="z0"):
        baselines.ogs_step(torch.Generator(), MinibatchData(wid, cnt), stats,
                           cfg, z0=np.full((D, L), K), device="cpu")


# ---------------------------------------------------------------------------
# The E-steps through ops.fused_estep; launches; inputs; contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ovb", "scvb"])
def test_estep_through_fused_estep_equals_the_formula(algo, monkeypatch):
    """One sweep (max_sweeps = 1) from μ₀: the port's μ, which is one
    ``ops.fused_estep`` call with θ̂ one row per document, equals the JAX
    package's ``_ovb_estep`` / ``_scvb_estep`` on the same θ̂₀."""
    wid, cnt, phi = _batch(seed=9)
    cfg = dict(num_topics=K, vocab_size=W, max_sweeps=1)
    rng = np.random.default_rng(3)
    mu0 = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta0 = np.einsum("dlk,dl->dk", mu0, cnt).astype(np.float32)
    jcfg = JLDAConfig(**cfg)
    alpha, beta = jcfg.alpha_m1 + 1.0, jcfg.beta_m1 + 1.0
    formula = jb._ovb_estep if algo == "ovb" else jb._scvb_estep
    want = np.asarray(formula(jnp.asarray(theta0), jnp.asarray(phi[wid]),
                              jnp.asarray(phi.sum(0)), jcfg, alpha, beta))
    calls = []
    real = kops.fused_estep

    def spy(theta_rows, phi_rows, *args, **kw):
        calls.append((tuple(theta_rows.shape), tuple(phi_rows.shape), kw))
        return real(theta_rows, phi_rows, *args, **kw)

    monkeypatch.setattr(kops, "fused_estep", spy)
    _, loc, _ = _port(baselines.ALGORITHMS[algo], wid, cnt, phi, 0, cfg,
                      mu0=mu0)
    np.testing.assert_allclose(loc.mu.numpy(), want, rtol=1e-5, atol=1e-7)
    assert [c[:2] for c in calls] == [((D, K), (D * L, K))]
    kw = calls[0][2]
    if algo == "ovb":
        assert kw == dict(alpha_m1=0.0, beta_m1=0.0, wb=0.0)
    else:
        assert kw == dict(alpha_m1=alpha, beta_m1=beta, wb=W * beta)


@pytest.mark.parametrize("algo,calls", [("ovb", 7), ("scvb", 7), ("ogs", 0)])
def test_each_sweep_is_one_fused_estep_call(algo, calls, monkeypatch):
    wid, cnt, phi = _batch()
    n = []
    real = kops.fused_estep
    monkeypatch.setattr(kops, "fused_estep",
                        lambda *a, **kw: n.append(1) or real(*a, **kw))
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=7)
    phi_t = torch.from_numpy(phi.copy())
    stats = GlobalStats(phi_t, phi_t.sum(0), torch.tensor(2))
    keep = (phi_t.clone(), stats.phi_k.clone())
    baselines.ALGORITHMS[algo](torch.Generator().manual_seed(0),
                               MinibatchData(wid, cnt), stats, cfg,
                               device="cpu")
    assert len(n) == calls
    assert torch.equal(stats.phi_wk, keep[0])     # inputs untouched
    assert torch.equal(stats.phi_k, keep[1])


@pytest.mark.parametrize("algo", sorted(baselines.ALGORITHMS))
def test_debug_checks_raise_contract_error(algo):
    wid, cnt, phi = _batch()
    cfg = LDAConfig(num_topics=K, vocab_size=W, debug_checks=True)
    with pytest.raises(kops.ContractError, match="debug_checks"):
        baselines.ALGORITHMS[algo](
            torch.Generator(), MinibatchData(wid, cnt),
            GlobalStats(phi, phi.sum(0), np.int32(0)), cfg, device="cpu")


@pytest.mark.parametrize("algo", sorted(baselines.ALGORITHMS))
def test_out_of_range_words_raise(algo):
    wid, cnt, phi = _batch()
    with pytest.raises(kops.ContractError, match="word_ids"):
        baselines.ALGORITHMS[algo](
            torch.Generator(), MinibatchData(wid, cnt),
            GlobalStats(phi[:W // 2], phi.sum(0), np.int32(0)),
            LDAConfig(num_topics=K, vocab_size=W), device="cpu")


# ---------------------------------------------------------------------------
# Port copies of tests/test_baselines_perplexity.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    return synthetic_lda_corpus(96, 240, 6, mean_doc_len=50, seed=7)[0]


@pytest.fixture(scope="module")
def tiny_cfg():
    return LDAConfig(num_topics=6, vocab_size=240, max_sweeps=16)


@pytest.fixture(scope="module")
def tiny_batch(corpus):
    mb = next(iter(MinibatchStream(corpus, 48, seed=0, epochs=1)))
    return MinibatchData(mb.word_ids, mb.counts)


def _zeros(cfg):
    return GlobalStats(torch.zeros((cfg.W, cfg.K)), torch.zeros(cfg.K),
                       torch.tensor(0, dtype=torch.int32))


STEPS = {"sem": sem.sem_step, **baselines.ALGORITHMS}


@pytest.mark.parametrize("algo", sorted(STEPS))
def test_baseline_step_runs(algo, tiny_batch, tiny_cfg):
    cfg = dataclasses.replace(tiny_cfg, max_sweeps=8, rho_mode="stepwise")
    new_stats, local, diag = STEPS[algo](
        torch.Generator().manual_seed(0), tiny_batch, _zeros(cfg), cfg,
        device="cpu")
    assert int(new_stats.step) == 1
    assert np.isfinite(float(diag.final_train_ppl))
    assert float(new_stats.phi_k.sum()) > 0
    assert bool((new_stats.phi_wk >= 0).all())


def _train(step, corpus, cfg, steps=6):
    stats = _zeros(cfg)
    gen = torch.Generator().manual_seed(0)
    for i, mb in enumerate(MinibatchStream(corpus, 32, seed=3, epochs=4)):
        if i >= steps:
            break
        stats, _, _ = step(gen, MinibatchData(mb.word_ids, mb.counts),
                           stats, cfg, device="cpu")
    return stats


def _predictive(corpus, stats, cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = list(range(corpus.num_docs - 24, corpus.num_docs))
    w, c = bucketize(corpus, ids)
    est, ev = split_heldout_counts(c, rng)
    return float(predictive_perplexity(
        1, MinibatchData(w, est), MinibatchData(w, ev),
        stats.phi_wk, stats.phi_k, cfg, fit_sweeps=30, device="cpu"))


def test_foem_beats_ovb_predictive_perplexity(corpus, tiny_cfg):
    """paper Figs. 9/11/12: the EM posterior yields lower perplexity than
    the VB-family baselines (loose CPU-scale check)."""
    cfg_em = dataclasses.replace(tiny_cfg, active_topics=3, max_sweeps=12)
    cfg_vb = dataclasses.replace(tiny_cfg, max_sweeps=12,
                                 rho_mode="stepwise")
    p_em = _predictive(corpus, _train(foem.foem_step, corpus, cfg_em),
                       cfg_em)
    p_vb = _predictive(corpus, _train(baselines.ovb_step, corpus, cfg_vb),
                       cfg_vb)
    assert p_em < p_vb * 1.15, (p_em, p_vb)
    assert 1 < p_em < tiny_cfg.W


def test_scvb_equiv_sem_shape_behaviour(tiny_batch, tiny_cfg):
    """paper Table 3: SCVB ≡ SEM up to pseudo-count constants — both must
    produce the same sufficient-statistics mass."""
    cfg = dataclasses.replace(tiny_cfg, max_sweeps=6, rho_mode="stepwise")
    s1, _, _ = sem.sem_step(torch.Generator().manual_seed(0), tiny_batch,
                            _zeros(cfg), cfg, device="cpu")
    s2, _, _ = baselines.scvb_step(torch.Generator().manual_seed(0),
                                   tiny_batch, _zeros(cfg), cfg,
                                   device="cpu")
    m1, m2 = float(s1.phi_k.sum()), float(s2.phi_k.sum())
    assert m1 == pytest.approx(m2, rel=1e-3)
