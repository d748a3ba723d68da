"""The port's numerical sanitizer: every invariant passes clean and fires.

The port's copy of every case in ``tests/test_sanitizer.py``: a clean pass
on a real ``ops.sweep`` / ``ops.infer`` result with ``debug_checks=True``
(dense, scheduled, inference), and each invariant's injected violation —
NaN lane, negative statistic, broken simplex, θ̂ row mass, φ̂ totals out of
step or not conserved, mass leaked into padding, an inactive entry moved,
active-set mass lost, a bad inference result — raising ``SanitizerError``
with the JAX package's message.  ``checkify`` has no counterpart: the
port's checks run eagerly, so the JAX cases under ``jit`` become the same
faults through the eager sweep; the sharded case runs the two-phase engine
on a 2-rank gloo mesh.

Cross-package: the same seeded inputs, with the same fault planted, make
the JAX sanitizer (eager ``checkify`` on the CPU) and the port's fail on
the same first message, and pass on the same clean inputs — on one result
handed to both, and end to end through each package's ``ops.sweep`` /
``ops.infer``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import checkify

from repro.analysis import sanitizer as jsan
from repro.core.types import SweepResult as JSweepResult
from repro.core.types import InferResult as JInferResult
from repro.kernels import ops as jops
from repro_torch.analysis import sanitizer as san
from repro_torch.core import em
from repro_torch.core.types import (
    InferResult,
    LDAConfig,
    LocalState,
    MinibatchData,
    SweepPlan,
    SweepResult,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_mesh

KW = dict(alpha_m1=0.01, beta_m1=0.01)


def _state(D=8, L=10, K=8, W=40, seed=0):
    """Numpy inputs whose θ̂ and φ̂ are the folds of μ (the JAX test's
    ``em.fold_theta`` / ``em.fold_phi``), with padding slots."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    assert (cnt == 0).any()                        # padding slots exist
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = np.zeros((W, K), np.float32)
    np.add.at(phi, wid.reshape(-1), (cnt[..., None] * mu).reshape(-1, K))
    return wid, cnt, mu, theta, phi, phi.sum(0)


def _t(*xs):
    return [None if x is None else torch.as_tensor(np.array(x))
            for x in xs]


def _top3(phi):
    return np.argsort(-phi, axis=1, kind="stable")[:, :3].astype(np.int32)


def _clean_sweep(debug_checks=True, seed=0, **kw):
    inputs = _state(seed=seed)
    r = ops.sweep(*inputs, wb=40 * 0.01, **KW, debug_checks=debug_checks,
                  device="cpu", **kw)
    return inputs, r


def _invariants(r, inputs, **kw):
    wid, cnt, mu, theta, phi, ptot = _t(*inputs)
    san.sweep_invariants(r, counts=cnt, mu_before=mu, phi_wk_before=phi,
                         phi_k_before=ptot, **kw)


def _expect(match, fn):
    with pytest.raises(ops.SanitizerError, match=match):
        fn()


# ---------------------------------------------------------------------------
# Clean paths
# ---------------------------------------------------------------------------

def test_clean_dense_sweep_passes():
    _, r = _clean_sweep(compute_loglik=True)
    assert r.loglik is not None         # the sanitizer ran inside ops.sweep


def test_clean_scheduled_sweep_passes():
    inputs = _state(seed=1)
    ops.sweep(*inputs, wb=0.4, **KW, word_topics=_top3(inputs[4]),
              debug_checks=True, device="cpu")


def test_clean_infer_passes():
    wid, cnt, mu, theta, phi, ptot = _state(seed=2)
    phin = phi / np.maximum(phi.sum(0, keepdims=True), 1e-30)
    r = ops.infer(wid, cnt, theta, phin, alpha_m1=0.01, ev_counts=cnt,
                  max_sweeps=10, check_every=5, debug_checks=True,
                  device="cpu")
    assert r.sweeps == 10


# ---------------------------------------------------------------------------
# Fault injection — one test per invariant, matching the message
# ---------------------------------------------------------------------------

def test_fires_on_nan():
    inputs, r = _clean_sweep(debug_checks=False)
    mu = r.mu.clone()
    mu[0, 0, 0] = float("nan")
    _expect("non-finite values in mu",
            lambda: _invariants(r._replace(mu=mu), inputs))


def test_fires_on_negative_stat():
    inputs, r = _clean_sweep(debug_checks=False)
    theta = r.theta.clone()
    theta[0, 0] = -0.5
    _expect("negative values in theta",
            lambda: _invariants(r._replace(theta=theta), inputs))


def test_fires_on_broken_simplex():
    inputs, r = _clean_sweep(debug_checks=False)
    d, l = map(int, np.argwhere(inputs[1] > 0)[0])
    mu = r.mu.clone()
    mu[d, l] *= 1.5
    _expect("do not sum to 1",
            lambda: _invariants(r._replace(mu=mu), inputs))


def test_fires_on_theta_row_mass():
    inputs, r = _clean_sweep(debug_checks=False)
    _expect("theta row mass",
            lambda: _invariants(r._replace(theta=r.theta * 1.1), inputs))


def test_fires_on_phi_column_inconsistency():
    inputs, r = _clean_sweep(debug_checks=False)
    phi_k = r.phi_k.clone()
    phi_k[0] += 1.0
    _expect("deltas inconsistent",
            lambda: _invariants(r._replace(phi_k=phi_k), inputs))


def test_fires_on_total_mass_change():
    inputs, r = _clean_sweep(debug_checks=False)
    phi = r.phi_wk.clone()
    phi[:, 0] *= 1.2
    _expect("total phi mass not conserved", lambda: _invariants(
        r._replace(phi_wk=phi, phi_k=phi.sum(0)), inputs))


def test_fires_on_padding_leak():
    inputs, r = _clean_sweep(debug_checks=False)
    d, l = map(int, np.argwhere(inputs[1] == 0)[0])
    res = r.residual.clone()
    res[d, l, 0] = 1e-4
    _expect("padding", lambda: _invariants(r._replace(residual=res), inputs))


def _scheduled(seed):
    inputs = _state(seed=seed)
    wt = _top3(inputs[4])
    act = inputs[1] > 0
    r = ops.sweep(*inputs, wb=0.4, **KW, word_topics=wt, token_active=act,
                  device="cpu")
    return inputs, wt, act, r


def test_fires_on_inactive_entry_drift():
    inputs, wt, act, r = _scheduled(3)
    wid, cnt = inputs[0], inputs[1]
    # poke an entry OUTSIDE the word's active set on a counted token
    d, l = map(int, np.argwhere(cnt > 0)[0])
    k_off = next(k for k in range(r.mu.shape[-1])
                 if k not in set(wt[wid[d, l]].tolist()))
    mu = r.mu.clone()
    mu[d, l, k_off] += 0.01
    w, a, i = _t(wt, act, wid)
    _expect("did not keep mu_old", lambda: _invariants(
        r._replace(mu=mu), inputs, word_topics=w, token_active=a,
        word_ids=i))


def test_fires_on_active_mass_loss():
    inputs, wt, act, r = _scheduled(4)
    wid, cnt = inputs[0], inputs[1]
    d, l = map(int, np.argwhere(cnt > 0)[0])
    k_on = int(wt[wid[d, l]][0])
    mu = r.mu.clone()
    mu[d, l, k_on] *= 5.0
    w, a, i = _t(wt, act, wid)
    _expect("active-set mass not preserved", lambda: _invariants(
        r._replace(mu=mu), inputs, word_topics=w, token_active=a,
        word_ids=i))


def test_infer_fires_on_bad_theta_and_positive_loglik():
    wid, cnt, mu, theta, phi, ptot = _state(seed=5)
    phin = phi / np.maximum(phi.sum(0, keepdims=True), 1e-30)
    r = ops.infer(wid, cnt, theta, phin, alpha_m1=0.01, ev_counts=cnt,
                  max_sweeps=10, check_every=5, device="cpu")
    est = torch.as_tensor(cnt)
    _expect("theta row mass", lambda: san.infer_invariants(
        r._replace(theta=r.theta * 2.0), est_counts=est))
    _expect("positive estimation-split", lambda: san.infer_invariants(
        r._replace(est_loglik=torch.tensor(3.0)), est_counts=est))
    _expect("non-finite values in ev_loglik", lambda: san.infer_invariants(
        r._replace(ev_loglik=torch.tensor(float("nan"))), est_counts=est))


def test_each_check_alone_raises_at_once():
    """Without a queue, a check reads its flag and raises immediately."""
    _expect("non-finite values in x",
            lambda: san.check_finite(torch.tensor([1.0, float("inf")]), "x"))
    _expect("negative values in y",
            lambda: san.check_nonneg(torch.tensor([0.0, -1.0]), "y"))
    san.check_finite(torch.zeros(0), "empty")             # nothing to check


# ---------------------------------------------------------------------------
# The eager wiring: inflated inputs, config threading, the sharded engine
# ---------------------------------------------------------------------------

def test_checked_sweep_fires_on_inflated_theta():
    """The counterpart of the JAX case under checkify(jit): the GS sweep
    updates θ̂ incrementally (θ − c·μ_old + c·μ_new), so an inflated input
    row mass survives the sweep and trips the row-mass check."""
    wid, cnt, mu, theta, phi, ptot = _state(seed=6)
    kw = dict(wb=0.4, **KW, debug_checks=True, device="cpu")
    ops.sweep(wid, cnt, mu, theta, phi, ptot, **kw)
    _expect("sanitizer: ", lambda: ops.sweep(wid, cnt, mu, theta * 1.1, phi,
                                             ptot, **kw))


def test_cfg_debug_checks_threads_through_em():
    cfg = LDAConfig(num_topics=8, vocab_size=40, debug_checks=True)
    wid, cnt, mu, theta, phi, ptot = _t(*_state(K=8, W=40, seed=8))
    r = em.gs_sweep_with_residuals(
        MinibatchData(wid, cnt), LocalState(mu=mu, theta_dk=theta), phi,
        ptot, cfg, compute_loglik=True)
    assert bool(torch.isfinite(r.loglik))
    with pytest.raises(ops.SanitizerError, match="theta row mass"):
        em.gs_sweep_with_residuals(
            MinibatchData(wid, cnt), LocalState(mu=mu, theta_dk=theta * 1.1),
            phi, ptot, cfg, compute_loglik=True)


def _sharded_rank(mesh):
    """One rank of the 2-way topic-sharded two-phase sweep: its K/2 lanes,
    clean and then with every rank's θ̂ slice inflated."""
    m, mp = mesh.model.index, mesh.model.size
    wid, cnt, mu, theta, phi, ptot = _t(*_state(D=8, L=6, K=8, W=40))
    lanes = slice(m * 8 // mp, (m + 1) * 8 // mp)
    args = (wid, cnt, mu[..., lanes].contiguous(),
            theta[:, lanes].contiguous(), phi[:, lanes].contiguous(),
            ptot[lanes].contiguous())
    plan = SweepPlan(axis_name=mesh.model)
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=40 * 0.01, plan=plan,
              debug_checks=True, device="cpu")
    r = ops.sweep(*args, **kw)
    (mass,) = mesh.model.all_reduce(r.mu.sum(-1))
    out = {"clean": float((mass - 1).abs()[cnt > 0].max())}
    try:
        ops.sweep(args[0], args[1], args[2], args[3] * 1.1, *args[4:], **kw)
        out["fault"] = None
    except ops.SanitizerError as e:
        out["fault"] = str(e)
    return out


def test_sharded_sanitizer_via_gloo_mesh():
    """The invariants summed over the model axis hold through the
    two-phase engine at mp = 2, and a cross-shard fault fires on every
    rank with the same message."""
    outs = spawn_mesh(_sharded_rank, 1, 2, device="cpu", timeout=300)
    assert all(o["clean"] < 1e-5 for o in outs)
    assert {o["fault"] for o in outs} == {
        "sanitizer: theta row mass differs from the document token count"}


# ---------------------------------------------------------------------------
# Cross-package: one result, one fault, both sanitizers
# ---------------------------------------------------------------------------

def _jax_message(fn):
    try:
        fn()
    except checkify.JaxRuntimeError as e:
        return str(e).split(" (`check` failed)")[0]
    return None


def _port_message(fn):
    try:
        fn()
    except ops.SanitizerError as e:
        return str(e)
    return None


def _set(a, idx, v):
    a = np.array(a, copy=True)
    a[idx] = v
    return a


SWEEP_FAULTS = {
    "clean": lambda r, s: r,
    "nan_mu": lambda r, s: dict(r, mu=_set(r["mu"], (0, 0, 0), np.nan)),
    "neg_theta": lambda r, s: dict(r, theta=_set(r["theta"], (0, 0), -0.5)),
    "inf_residual": lambda r, s: dict(
        r, residual=_set(r["residual"], (1, 2, 3), np.inf)),
    "simplex": lambda r, s: dict(r, mu=_set(
        r["mu"], s["counted"], r["mu"][s["counted"]] * 1.5)),
    "theta_mass": lambda r, s: dict(r, theta=r["theta"] * 1.1),
    "phi_k": lambda r, s: dict(r, phi_k=_set(r["phi_k"], 0,
                                             r["phi_k"][0] + 1.0)),
    "total_mass": lambda r, s: dict(
        r, phi_wk=r["phi_wk"] * np.r_[1.2, np.ones(7)].astype(np.float32),
        phi_k=(r["phi_wk"] * np.r_[1.2, np.ones(7)].astype(
            np.float32)).sum(0)),
    "padding": lambda r, s: dict(r, residual=_set(
        r["residual"], s["padding"] + (0,), 1e-4)),
    "nan_loglik": lambda r, s: dict(r, loglik=np.float32(np.nan)),
}
SCHED_FAULTS = {
    "clean": lambda r, s: r,
    "inactive_drift": lambda r, s: dict(r, mu=_set(
        r["mu"], s["off"], r["mu"][s["off"]] + 0.01)),
    "active_loss": lambda r, s: dict(r, mu=_set(
        r["mu"], s["on"], r["mu"][s["on"]] * 5.0)),
    "nan_mu": lambda r, s: dict(r, mu=_set(r["mu"], (0, 0, 0), np.nan)),
}


def _sweep_pair(scheduled, fault):
    """The JAX result of one seeded sweep, the fault planted, held against
    both packages' sanitizers."""
    inputs = _state(seed=11)
    wid, cnt, mu, theta, phi, ptot = inputs
    kw = {}
    if scheduled:
        wt, act = _top3(phi), cnt > 0
        kw = dict(word_topics=wt, token_active=act)
    jr = jops.sweep(*map(jnp.asarray, inputs), wb=0.4, **KW,
                    compute_loglik=not scheduled, use_pallas=False,
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    r = {k: np.asarray(v) for k, v in jr._asdict().items() if v is not None}
    d, l = map(int, np.argwhere(cnt > 0)[0])
    spots = {"counted": (d, l), "padding": tuple(
        map(int, np.argwhere(cnt == 0)[0]))}
    if scheduled:
        on = set(kw["word_topics"][wid[d, l]].tolist())
        spots["off"] = (d, l, next(k for k in range(8) if k not in on))
        spots["on"] = (d, l, int(kw["word_topics"][wid[d, l]][0]))
    bad = (SCHED_FAULTS if scheduled else SWEEP_FAULTS)[fault](r, spots)
    loglik = bad.get("loglik")
    jres = JSweepResult(*(jnp.asarray(bad[k]) for k in
                          ("mu", "theta", "phi_wk", "phi_k", "residual")),
                        None if loglik is None else jnp.asarray(loglik))
    pres = SweepResult(*_t(*(bad[k] for k in ("mu", "theta", "phi_wk",
                                              "phi_k", "residual"))),
                       None if loglik is None else torch.tensor(loglik))
    jkw = dict(counts=jnp.asarray(cnt), mu_before=jnp.asarray(mu),
               phi_wk_before=jnp.asarray(phi), phi_k_before=jnp.asarray(ptot))
    pkw = dict(zip(("counts", "mu_before", "phi_wk_before", "phi_k_before"),
                   _t(cnt, mu, phi, ptot)))
    if scheduled:
        jkw.update(word_topics=jnp.asarray(kw["word_topics"]),
                   token_active=jnp.asarray(kw["token_active"]),
                   word_ids=jnp.asarray(wid))
        pkw.update(zip(("word_topics", "token_active", "word_ids"),
                       _t(kw["word_topics"], kw["token_active"], wid)))
    return (_jax_message(lambda: jsan.sweep_invariants(jres, **jkw)),
            _port_message(lambda: san.sweep_invariants(pres, **pkw)))


@pytest.mark.parametrize("fault", list(SWEEP_FAULTS))
def test_dense_faults_give_the_jax_message(fault):
    jmsg, pmsg = _sweep_pair(False, fault)
    assert pmsg == jmsg
    assert (jmsg is None) == (fault == "clean")


@pytest.mark.parametrize("fault", list(SCHED_FAULTS))
def test_scheduled_faults_give_the_jax_message(fault):
    jmsg, pmsg = _sweep_pair(True, fault)
    assert pmsg == jmsg
    assert (jmsg is None) == (fault == "clean")


INFER_FAULTS = {
    "clean": {},
    "theta_x2": {"theta": 2.0},
    "nan_theta": {"theta": np.nan},
    "positive_est": {"est_loglik": 3.0},
    "positive_ev": {"ev_loglik": 0.5},
    "nan_ev": {"ev_loglik": np.nan},
    "inf_ev_doc": {"ev_loglik_doc": np.inf},
}


@pytest.mark.parametrize("fault", list(INFER_FAULTS))
def test_infer_faults_give_the_jax_message(fault):
    wid, cnt, mu, theta, phi, ptot = _state(seed=12)
    phin = phi / np.maximum(phi.sum(0, keepdims=True), 1e-30)
    jr = jops.infer(*map(jnp.asarray, (wid, cnt, theta, phin)),
                    alpha_m1=0.01, ev_counts=jnp.asarray(cnt), max_sweeps=10,
                    check_every=5, use_pallas=False)
    r = {k: np.asarray(v) for k, v in jr._asdict().items()}
    for k, v in INFER_FAULTS[fault].items():
        r[k] = (r[k] * v if k == "theta" and v == 2.0
                else np.full_like(r[k], v))
    jres = JInferResult(**{k: jnp.asarray(v) for k, v in r.items()})
    pres = InferResult(**{k: (int(v) if k == "sweeps"
                              else torch.as_tensor(np.array(v)))
                           for k, v in r.items()})
    jmsg = _jax_message(lambda: jsan.infer_invariants(
        jres, est_counts=jnp.asarray(cnt)))
    pmsg = _port_message(lambda: san.infer_invariants(
        pres, est_counts=torch.as_tensor(cnt)))
    assert pmsg == jmsg
    assert (jmsg is None) == (fault == "clean")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_end_to_end_faults_give_the_jax_message():
    """Through each package's own ops with debug_checks=True, on the state
    and the faults ``chip_smoke.py``'s analysis phase plants on the card: a
    NaN φ row before ops.infer, a negative count before ops.sweep, a
    perturbed φ̂(k) handed to sweep_invariants — each raises the message
    that phase expects, in both packages."""
    want = _chip_smoke().SANITIZER_FAULTS
    wid, cnt, mu, theta, phi, ptot = _state(D=8, L=10, K=64, W=40, seed=5)
    phin = phi / np.maximum(phi.sum(0, keepdims=True), 1e-30)
    phin = _set(phin, int(wid[0, 0]), np.nan)
    ikw = dict(alpha_m1=0.01, max_sweeps=10, check_every=5)
    jmsg = _jax_message(lambda: jops.infer(
        *map(jnp.asarray, (wid, cnt, theta, phin)),
        ev_counts=jnp.asarray(cnt), use_pallas=False, debug_checks=True,
        **ikw))
    pmsg = _port_message(lambda: ops.infer(
        wid, cnt, theta, phin, ev_counts=cnt, debug_checks=True,
        device="cpu", **ikw))
    assert jmsg == pmsg == want["nan_phi_row"]
    bad = _set(cnt, (0, 0), -1.0)
    skw = dict(wb=40 * 0.01, **KW)
    jmsg = _jax_message(lambda: jops.sweep(
        *map(jnp.asarray, (wid, bad, mu, theta, phi, ptot)), **skw,
        use_pallas=False, debug_checks=True))
    pmsg = _port_message(lambda: ops.sweep(
        wid, bad, mu, theta, phi, ptot, **skw, debug_checks=True,
        device="cpu"))
    assert jmsg == pmsg == want["negative_count"]
    jr = jops.sweep(*map(jnp.asarray, (wid, cnt, mu, theta, phi, ptot)),
                    **skw, use_pallas=False)
    pr = ops.sweep(wid, cnt, mu, theta, phi, ptot, **skw, device="cpu")
    jmsg = _jax_message(lambda: jsan.sweep_invariants(
        jr._replace(phi_k=jr.phi_k + 1.0), counts=jnp.asarray(cnt),
        mu_before=jnp.asarray(mu), phi_wk_before=jnp.asarray(phi),
        phi_k_before=jnp.asarray(ptot)))
    c, m, p, k = _t(cnt, mu, phi, ptot)
    pmsg = _port_message(lambda: san.sweep_invariants(
        pr._replace(phi_k=pr.phi_k + 1.0), counts=c, mu_before=m,
        phi_wk_before=p, phi_k_before=k))
    assert jmsg == pmsg == want["perturbed_phi_k"]


def test_jax_and_port_pass_the_same_clean_sweep_end_to_end():
    inputs = _state(seed=14)
    jr = jops.sweep(*map(jnp.asarray, inputs), wb=0.4, **KW,
                    compute_loglik=True, use_pallas=False,
                    debug_checks=True)
    pr = ops.sweep(*inputs, wb=0.4, **KW, compute_loglik=True,
                   debug_checks=True, device="cpu")
    np.testing.assert_allclose(pr.mu.numpy(), np.asarray(jr.mu), rtol=1e-4,
                               atol=1e-6)
    assert jax.devices()[0].platform == "cpu"


LOCKSTEP = "sanitizer: phi_k deltas inconsistent with column sums of phi_wk"


def test_float32_totals_miss_the_phi_bound_at_scale():
    """A limit of the bound, not a fault: at a store's magnitude (here a
    word outside the batch with 3·10⁶ tokens a topic) a float32 φ̂(k)
    rounds by more than the φ̂ totals bound, so the same checked sweep
    raises the lockstep message, and only that, in both packages."""
    wid, cnt, mu, theta, phi, _ = _state(seed=15)
    phi = np.vstack([phi, np.full((1, phi.shape[1]), 3e6, np.float32)])
    ptot = phi.sum(0)
    skw = dict(wb=0.4, **KW)
    jmsg = _jax_message(lambda: jops.sweep(
        *map(jnp.asarray, (wid, cnt, mu, theta, phi, ptot)), **skw,
        use_pallas=False, debug_checks=True))
    with pytest.raises(ops.SanitizerError) as err:
        ops.sweep(wid, cnt, mu, theta, phi, ptot, **skw, debug_checks=True,
                  device="cpu")
    assert jmsg == str(err.value) == LOCKSTEP
    assert err.value.failed == [LOCKSTEP]


def test_checked_sweep_fires_on_a_faulty_kernel_total(monkeypatch):
    """The φ̂ totals invariant reads the kernels' own φ̂(k): a sweep whose
    running total drops half a token a topic raises, on inputs whose clean
    sweep passes."""
    inputs, _ = _clean_sweep()
    real = ops.gs_sweep

    def dropping(*args, **kw):
        out = list(real(*args, **kw))
        out[4] = out[4] - 0.5
        return tuple(out)

    monkeypatch.setattr(ops, "gs_sweep", dropping)
    _expect(LOCKSTEP, lambda: ops.sweep(*inputs, wb=0.4, **KW,
                                        debug_checks=True, device="cpu"))


def test_error_lists_every_failed_invariant():
    """``SanitizerError`` carries the first failed message and, in
    ``failed``, every failed one in the JAX package's order."""
    inputs, r = _clean_sweep(debug_checks=False)
    bad = r._replace(mu=_set_t(r.mu, (0, 0, 0), float("nan")),
                     phi_k=r.phi_k + 1.0)
    with pytest.raises(ops.SanitizerError) as err:
        _invariants(bad, inputs)
    assert err.value.failed[0] == str(err.value) == (
        "sanitizer: non-finite values in mu")
    assert LOCKSTEP in err.value.failed


def _set_t(t, idx, v):
    t = t.clone()
    t[idx] = v
    return t
