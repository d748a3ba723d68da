"""PyTorch port of frozen-φ inference vs the JAX package.

The same numpy inputs (seeded) and the same injected θ̂₀ go through the JAX
package's plain path (``ops.infer(use_pallas=False)``) and the port's
``ops.infer(device="cpu")`` / ``theta_sweep_reference``; the tolerances are
those of ``tests/test_theta_sweep.py`` (kernel vs portable: θ rtol 2e-6 /
atol 1e-5, logliks rtol 1e-5; quantized θ rtol 2e-5 / atol 2e-6).  The
port's own invariants (padding invisibility, zero-count inertness, the
chunk contract) are held within the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem
from repro.core.perplexity import serving_active_topics as j_active
from repro.core.perplexity import split_heldout_counts
from repro.core.types import InferPlan as JInferPlan
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import uniform_responsibilities
from repro.kernels import ops as jops
from repro.kernels.theta_sweep import quantize_phi as j_quantize
from repro_torch.core import em
from repro_torch.core.perplexity import (
    infer_heldout,
    predictive_perplexity,
    serving_active_topics,
)
from repro_torch.core.types import InferPlan, LDAConfig, MinibatchData
from repro_torch.kernels import ops
from repro_torch.kernels.theta_sweep import (
    RING_BUDGET,
    SMEM_BUDGET,
    dequantize_phi,
    doc_order,
    quantize_phi,
    sweep_path,
    theta_sweep,
    theta_sweep_reference,
)


def _state(D, L, K, W, seed=0):
    """Trained-ish φ̂, an 80/20-split held-out batch and a θ̂₀, as numpy."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 6, (D, L)).astype(np.float32)
    est, ev = split_heldout_counts(cnt, rng)
    phi_wk = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    phi_k = phi_wk.sum(0)
    mu0 = np.array(uniform_responsibilities(jax.random.PRNGKey(seed),
                                            (D, L, K)))
    theta0 = np.einsum("dlk,dl->dk", mu0, est).astype(np.float32)
    return wid, est, ev, phi_wk, phi_k, theta0


def _phi_norm(phi_wk, phi_k, K, W):
    cfg = JLDAConfig(num_topics=K, vocab_size=W)
    return np.array(jem.normalize_phi(jnp.asarray(phi_wk),
                                      jnp.asarray(phi_k), cfg))


def _jax_infer(wid, est, ev, theta0, phi_norm, **kw):
    return jops.infer(jnp.asarray(wid), jnp.asarray(est), jnp.asarray(theta0),
                      jnp.asarray(phi_norm), ev_counts=jnp.asarray(ev),
                      use_pallas=False, **kw)


def _close(a, b, *, theta_tol=(2e-6, 1e-5)):
    rtol, atol = theta_tol
    assert a.sweeps == int(b.sweeps)
    np.testing.assert_allclose(a.theta.numpy(), np.asarray(b.theta),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(a.est_loglik), float(b.est_loglik),
                               rtol=1e-5)
    np.testing.assert_allclose(float(a.ev_loglik), float(b.ev_loglik),
                               rtol=1e-5)
    np.testing.assert_allclose(a.ev_loglik_doc.numpy(),
                               np.asarray(b.ev_loglik_doc),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D,L,K,W", [(5, 6, 7, 64), (8, 4, 16, 64),
                                     (12, 9, 5, 128)])
@pytest.mark.parametrize("active", [0, 3])
def test_infer_matches_jax(D, L, K, W, active):
    """Dense and scheduled (top-A-by-φ-mass) fits, fixed sweep budget."""
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=D)
    phi_norm = _phi_norm(phi_wk, phi_k, K, W)
    jwt = j_active(jnp.asarray(phi_norm), active) if active else None
    wt = serving_active_topics(torch.from_numpy(phi_norm), active) \
        if active else None
    if active:
        np.testing.assert_array_equal(wt.numpy(), np.asarray(jwt))
    kw = dict(alpha_m1=0.01, max_sweeps=12, check_every=4)
    a = ops.infer(wid, est, theta0, phi_norm, ev_counts=ev, word_topics=wt,
                  device="cpu", **kw)
    b = _jax_infer(wid, est, ev, theta0, phi_norm, word_topics=jwt, **kw)
    assert a.sweeps == 12
    _close(a, b)


@pytest.mark.parametrize("rel_tol", [0.0, 0.01])
def test_infer_stop_rule_matches_jax(rel_tol):
    """The chunked stop rule stops at the same chunk; rel_tol 0 runs the
    whole budget."""
    D, L, K, W = 16, 10, 8, 160
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=2)
    phi_norm = _phi_norm(phi_wk, phi_k, K, W)
    kw = dict(alpha_m1=0.01, max_sweeps=60, check_every=5, rel_tol=rel_tol)
    a = ops.infer(wid, est, theta0, phi_norm, ev_counts=ev, device="cpu",
                  **kw)
    b = _jax_infer(wid, est, ev, theta0, phi_norm, **kw)
    if rel_tol == 0.0:
        assert a.sweeps == 60
    else:
        assert a.sweeps < 60
    _close(a, b)


@pytest.mark.parametrize("phi_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("active", [0, 4])
def test_quantized_infer_matches_jax(phi_dtype, active):
    """Both packages quantize φ once to the same stored values; θ̂ and
    logliks agree to accumulation order (quantized tolerances)."""
    D, L, K, W = 8, 6, 16, 64
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=4)
    phi_norm = _phi_norm(phi_wk, phi_k, K, W)
    jwt = j_active(jnp.asarray(phi_norm), active) if active else None
    wt = None if jwt is None else torch.from_numpy(np.array(jwt))
    kw = dict(alpha_m1=0.01, max_sweeps=20, check_every=10, rel_tol=0.0)
    a = ops.infer(wid, est, theta0, phi_norm, ev_counts=ev, word_topics=wt,
                  plan=InferPlan(phi_dtype=phi_dtype), device="cpu", **kw)
    b = _jax_infer(wid, est, ev, theta0, phi_norm, word_topics=jwt,
                   plan=JInferPlan(phi_dtype=phi_dtype), **kw)
    _close(a, b, theta_tol=(2e-5, 2e-6))


@pytest.mark.parametrize("phi_dtype", ["float32", "bfloat16", "int8"])
def test_quantize_phi_matches_jax(phi_dtype):
    """Values and scales equal bit for bit, zero rows included."""
    rng = np.random.default_rng(0)
    phi = rng.random((32, 16)).astype(np.float32) * 1e-2
    phi[5] = 0.0                                  # an all-zero row
    phi[7, 3] = -phi[7, 3]                        # symmetric range
    v, s = quantize_phi(torch.from_numpy(phi), phi_dtype)
    jv, js = j_quantize(jnp.asarray(phi), phi_dtype)
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    if phi_dtype == "int8":
        assert v.dtype == torch.int8
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert s[5] == 1.0
        deq = dequantize_phi(v, s).numpy()
        assert np.all(deq[5] == 0.0)
        np.testing.assert_array_equal(
            deq, np.asarray(jv, np.float32) * np.asarray(js)[:, None])
    else:
        assert s is None and js is None


def test_reference_chunk_matches_jax_portable():
    """One chunk of the plain version ≡ the JAX package's portable chunk."""
    D, L, K, W = 7, 5, 9, 40
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=11)
    phi_norm = _phi_norm(phi_wk, phi_k, K, W)
    t = torch.from_numpy
    a = theta_sweep_reference(t(wid), t(est), t(ev), t(theta0), t(phi_norm),
                              alpha_m1=0.01, num_sweeps=3)
    b = jops._infer_chunk_portable(
        jnp.asarray(wid), jnp.asarray(est), jnp.asarray(ev),
        jnp.asarray(theta0), jnp.asarray(phi_norm), None,
        alpha_m1=0.01, k_alpha=K * 0.01, num_sweeps=3)
    np.testing.assert_allclose(a[0].numpy(), np.asarray(b[0]),
                               rtol=2e-6, atol=1e-5)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-6)


def test_doc_padding_bitwise_invisible():
    """Zero-count documents appended to a batch change no bit of the real
    documents' θ̂ or partials (the per-document fixed point)."""
    D, L, K, W = 12, 6, 5, 96
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=4)
    phi_norm = torch.from_numpy(_phi_norm(phi_wk, phi_k, K, W))
    kw = dict(alpha_m1=0.01, num_sweeps=3)
    t = torch.from_numpy
    base = theta_sweep(t(wid), t(est), t(ev), t(theta0), phi_norm, **kw)
    pad = ((0, 4), (0, 0))
    padded = theta_sweep(t(np.pad(wid, pad)), t(np.pad(est, pad)),
                         t(np.pad(ev, pad)), t(np.pad(theta0, pad)),
                         phi_norm, **kw)
    for name, x, y in zip(("theta", "est_ll", "ev_ll"), base, padded):
        np.testing.assert_array_equal(x.numpy(), y.numpy()[:D], err_msg=name)


@pytest.mark.parametrize("phi_dtype", ["bfloat16", "int8"])
def test_quantized_token_padding_bitwise_invisible(phi_dtype):
    """Zero-count token columns stay bitwise-invisible under a quantized
    φ (the padded slots read the same stored values)."""
    wid, est, ev, phi_wk, phi_k, theta0 = _state(6, 5, 8, 64, seed=9)
    phi_norm = _phi_norm(phi_wk, phi_k, 8, 64)
    kw = dict(alpha_m1=0.01, max_sweeps=10, check_every=10, rel_tol=0.0,
              plan=InferPlan(phi_dtype=phi_dtype), device="cpu")
    base = ops.infer(wid, est, theta0, phi_norm, **kw)
    padded = ops.infer(np.pad(wid, ((0, 0), (0, 3))),
                       np.pad(est, ((0, 0), (0, 3))), theta0, phi_norm, **kw)
    np.testing.assert_array_equal(base.theta.numpy(), padded.theta.numpy())


def test_zero_count_docs_inert():
    """Empty documents keep θ̂ = 0 and contribute zero partials."""
    D, L, K, W = 6, 5, 4, 32
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=7)
    est[2] = 0.0
    ev[2] = 0.0
    phi_norm = _phi_norm(phi_wk, phi_k, K, W)
    r = ops.infer(wid, est, theta0, phi_norm, alpha_m1=0.01, ev_counts=ev,
                  max_sweeps=4, check_every=4, device="cpu")
    assert float(r.theta[2].abs().sum()) == 0.0
    assert float(r.ev_loglik_doc[2]) == 0.0


def test_max_sweeps_check_every_contract():
    wid, est, ev, phi_wk, phi_k, theta0 = _state(4, 4, 3, 16)
    phi_norm = _phi_norm(phi_wk, phi_k, 3, 16)
    with pytest.raises(ValueError, match="multiple of"):
        ops.infer(wid, est, theta0, phi_norm, alpha_m1=0.01, max_sweeps=7,
                  check_every=3, device="cpu")


def test_contracts_refused_eagerly():
    """Sharded plans, int8 φ without scales and mismatched shapes are
    refused before any compute."""
    wid, est, ev, phi_wk, phi_k, theta0 = _state(8, 4, 8, 64)
    phi_norm = _phi_norm(phi_wk, phi_k, 8, 64)
    with pytest.raises(ops.ContractError, match="sharded"):
        ops.infer(wid, est, theta0, phi_norm, alpha_m1=0.01,
                  plan=InferPlan(axis_name="model"), device="cpu")
    with pytest.raises(ops.ContractError, match="theta0"):
        ops.infer(wid, est, theta0[:3], phi_norm, alpha_m1=0.01,
                  device="cpu")
    q, _ = quantize_phi(torch.from_numpy(phi_norm), "int8")
    with pytest.raises(ValueError, match="scale"):
        theta_sweep(torch.from_numpy(wid), torch.from_numpy(est),
                    torch.from_numpy(ev), torch.from_numpy(theta0), q,
                    alpha_m1=0.01, num_sweeps=2)


@pytest.mark.parametrize("name,value", [("word_ids", 64), ("word_ids", -1),
                                        ("word_topics", 8),
                                        ("word_topics", -1)])
def test_index_ranges_refused(name, value):
    """A word id outside [0, W_s) or an active topic outside [0, K) is a
    ContractError before any compute, as it is on the card."""
    wid, est, ev, phi_wk, phi_k, theta0 = _state(8, 4, 8, 64)
    phi_norm = _phi_norm(phi_wk, phi_k, 8, 64)
    wt = serving_active_topics(torch.from_numpy(phi_norm), 3).numpy().copy()
    bad = {"word_ids": wid, "word_topics": wt}[name]
    bad[1, 2] = value
    with pytest.raises(ops.ContractError, match=name):
        ops.infer(wid, est, theta0, phi_norm, alpha_m1=0.01, word_topics=wt,
                  max_sweeps=2, check_every=2, device="cpu")


def test_predictive_perplexity_matches_jax():
    """eq. 21 end to end from the sufficient statistics, same θ̂₀."""
    from repro.core.perplexity import infer_heldout as j_heldout
    from repro.core.types import MinibatchData as JBatch

    D, L, K, W = 14, 8, 6, 100
    wid, est, ev, phi_wk, phi_k, theta0 = _state(D, L, K, W, seed=9)
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    jcfg = JLDAConfig(num_topics=K, vocab_size=W)
    t = torch.from_numpy
    ppl = predictive_perplexity(
        0, MinibatchData(t(wid), t(est)), MinibatchData(t(wid), t(ev)),
        t(phi_wk), t(phi_k), cfg, fit_sweeps=20, rel_tol=0.0,
        check_every=20, theta0=t(theta0), device="cpu")
    # the JAX entry point draws its own θ̂₀; hold the port against the
    # JAX dispatch with the port's θ̂₀ and against the JAX adapter's value
    jphi = jem.normalize_phi(jnp.asarray(phi_wk), jnp.asarray(phi_k), jcfg)
    ref = jops.infer(jnp.asarray(wid), jnp.asarray(est), jnp.asarray(theta0),
                     jphi, alpha_m1=0.01, ev_counts=jnp.asarray(ev),
                     max_sweeps=20, check_every=20, use_pallas=False)
    np.testing.assert_allclose(float(ppl),
                               float(ref.perplexity(float(ev.sum()))),
                               rtol=1e-5)
    jres = j_heldout(jax.random.PRNGKey(0), JBatch(jnp.asarray(wid),
                                                   jnp.asarray(est)),
                     JBatch(jnp.asarray(wid), jnp.asarray(ev)), jphi, jcfg,
                     fit_sweeps=20, rel_tol=0.0, check_every=20,
                     use_pallas=False)
    res = infer_heldout(0, MinibatchData(t(wid), t(est)),
                        MinibatchData(t(wid), t(ev)),
                        em.normalize_phi(t(phi_wk), t(phi_k), cfg), cfg,
                        fit_sweeps=20, rel_tol=0.0, check_every=20,
                        device="cpu")
    # different random θ̂₀ (torch vs jax bits), same fixed point to 1%
    np.testing.assert_allclose(float(res.perplexity(float(ev.sum()))),
                               float(jres.perplexity(float(ev.sum()))),
                               rtol=1e-2)


def test_doc_order_longest_first_stable():
    """CTAs take documents by fit tokens (nonzero estimation counts), most
    first, ties in index order; the order is a permutation."""
    est = torch.tensor([[1.0, 0.0, 2.0, 0.0],
                        [0.0, 0.0, 0.0, 0.0],
                        [3.0, 4.0, 5.0, 1.0],
                        [1.0, 1.0, 0.0, 0.0],
                        [0.0, 2.0, 0.0, 7.0]])
    order = doc_order(est)
    assert order.dtype == torch.int32
    assert order.tolist() == [2, 0, 3, 4, 1]
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.integers(0, 3, (300, 50)).astype(np.float32))
    fit = (big != 0).sum(1)
    o = doc_order(big).long()
    assert sorted(o.tolist()) == list(range(300))
    assert bool((fit[o][:-1] >= fit[o][1:]).all())
    ties = fit[o][:-1] == fit[o][1:]
    assert bool((o[:-1][ties] < o[1:][ties]).all())


@pytest.mark.parametrize("K,A,L,itemsize,ptr,kind,code,slots", [
    (10_000, 0, 160, 4, 0, "registers", 0, 2),    # f32 rows of 40 KB
    (10_000, 0, 160, 2, 0, "registers", 0, 5),    # bf16, 20 KB
    (10_000, 0, 160, 1, 0, "registers", 0, 8),    # int8, 10 KB
    (10_000, 16, 160, 4, 0, "registers", 0, 2),   # scheduled
    (10_001, 0, 160, 2, 0, "registers", 1, 5),    # rows not 16-byte aligned
    (10_000, 0, 160, 4, 4, "registers", 1, 2),    # φ's base not aligned
    (10_240, 1024, 16, 1, 0, "registers", 0, 8),
    (10_240, 1025, 16, 4, 0, "shared", 2, 0),     # A past the staging buffer
    (10_241, 0, 16, 4, 0, "shared", 2, 0),        # past the register lanes
    (10_000, 0, 2048, 4, 0, "shared", 2, 0),      # columns crowd the ring out
    (50_000, 0, 16, 4, 0, "scratch", 3, 0),       # bigmodel
])
def test_sweep_path_by_width_dtype_and_alignment(K, A, L, itemsize, ptr,
                                                 kind, code, slots):
    """The kernel path a launch takes, and its shared memory: a ring of at
    least two reductions' rows, the scheduled fit's state and the staged
    token columns within the two-CTAs-an-SM budget."""
    path = sweep_path(K, A, L, itemsize, ptr)
    assert (path.kind, path.code, path.slots) == (kind, code, slots)
    if kind == "registers":
        assert path.stride >= K * itemsize + 15 and path.stride % 16 == 0
        need = 8 * K + 16 * 1024 if A else 0
        assert path.meta_off % 16 == 0
        assert path.meta_off >= max(path.slots * path.stride, need)
        assert path.smem == path.meta_off + 16 * L <= RING_BUDGET + 16
    elif kind == "shared":
        assert path.smem == 3 * K * 4 <= SMEM_BUDGET
