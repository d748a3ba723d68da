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

φ̂(k)'s float64 total: in every checked sweep mode (single device dense
and scheduled, two-phase and hooks on a 2-rank gloo mesh) the total the φ̂
checks read is the input φ̂(k) plus the fold's own float32 increments
(rebuilt here from the μ output, 1e-12 relative), the float32 outputs are
the same bits with checks and without, a total short of 0.5 token a topic
raises the lockstep message, and a float32 φ̂(k) short of 0.5 token a
topic, its total intact, raises the port's own float32 check.  Where the JAX
package's float32 total misses the bound at a store's magnitude, the
port's checked sweep and trainer step pass; rows of ~10⁶ tokens in the
batch still miss it in both packages (the open finding).
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


def _at_scale(seed=15):
    """``_state`` with a word outside the batch holding 3·10⁶ tokens a
    topic: φ̂(k) at a store's magnitude, the batch's own rows small."""
    wid, cnt, mu, theta, phi, _ = _state(seed=seed)
    phi = np.vstack([phi, np.full((1, phi.shape[1]), 3e6, np.float32)])
    return wid, cnt, mu, theta, phi, phi.sum(0)


def test_float32_totals_miss_the_phi_bound_at_scale():
    """At a store's magnitude (here a word outside the batch with 3·10⁶
    tokens a topic) a float32 φ̂(k) rounds by more than the φ̂ totals bound:
    the JAX package's checked sweep, which reads its float32 running total,
    raises the lockstep message.  The port's check reads the float64 total
    that its engine carries beside the float32 one: the same checked sweep
    raises nothing, and its float32 outputs are the unchecked run's bits."""
    wid, cnt, mu, theta, phi, ptot = _at_scale()
    skw = dict(wb=0.4, **KW)
    jmsg = _jax_message(lambda: jops.sweep(
        *map(jnp.asarray, (wid, cnt, mu, theta, phi, ptot)), **skw,
        use_pallas=False, debug_checks=True))
    assert jmsg == LOCKSTEP
    plain = ops.sweep(wid, cnt, mu, theta, phi, ptot, **skw, device="cpu")
    checked = ops.sweep(wid, cnt, mu, theta, phi, ptot, **skw,
                        debug_checks=True, device="cpu")
    assert torch.equal(checked.phi_k, plain.phi_k)
    # the port's float32 total misses the bound as the JAX package's does
    c, m, p, k = _t(cnt, mu, phi, ptot)
    _expect(LOCKSTEP, lambda: san.sweep_invariants(
        plain, counts=c, mu_before=m, phi_wk_before=p, phi_k_before=k))


def test_large_rows_still_miss_the_phi_bound():
    """The open finding the float64 total leaves: where the batch's own
    rows hold ~10⁶ tokens a topic, each Δ a float32 row takes rounds by up
    to a half-ulp (0.03 token), and the rows' column sums move apart from
    the exact total by more than the bound leaves a topic that barely
    moves: the checked sweep raises the lockstep message, as the JAX
    package's does."""
    wid, cnt, mu, theta, phi, _ = _state(seed=25)
    phi = phi + np.float32(1e6)
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


def test_chip_smoke_port_faults_give_their_messages(monkeypatch):
    """The two faults ``chip_smoke.py`` plants in the port's own engine on
    the card, here through the CPU engine on the same state: the kernel's
    float64 total short of 0.5 token a topic raises the lockstep message,
    its float32 φ̂(k) short of 0.5 token a topic the port's float32 check."""
    want = _chip_smoke().SANITIZER_FAULTS
    assert want["short_phi_k32"] == san.PHI_K_FLOAT32
    inputs = _state(D=8, L=10, K=64, W=40, seed=5)
    kw = dict(wb=40 * 0.01, **KW, debug_checks=True, device="cpu")
    real = ops.gs_sweep

    def short(*args, **kwargs):
        out = list(real(*args, **kwargs))
        out[4] = out[4] - 0.5
        return tuple(out)

    for name, engine in (("dropped_total64", _dropping(real)),
                         ("short_phi_k32", short)):
        monkeypatch.setattr(ops, "gs_sweep", engine)
        assert _port_message(lambda: ops.sweep(*inputs, **kw)) == want[name]


def test_chip_smoke_holds_a_raise_to_the_rows_rounding():
    """``chip_smoke.py``'s ``PhiGaps`` keeps the checked sweep that raised
    and lets the raise go on; its ``phi_gap`` record of a clean sweep over
    rows of ~10⁶ tokens (the open finding) has topics over the lockstep
    bound and none over it and the rows' rounding, and a total a topic
    carries 50 tokens off is counted over both."""
    cs = _chip_smoke()
    wid, cnt, mu, theta, phi, _ = _state(seed=25)
    phi = phi + np.float32(1e6)
    inputs = _t(wid, cnt, mu, theta, phi, phi.sum(0))
    gaps = cs.PhiGaps(torch)
    with gaps, pytest.raises(ops.SanitizerError):
        ops.sweep(*inputs, wb=0.4, **KW, debug_checks=True, device="cpu")
    result, kw = gaps.held
    assert san.sweep_invariants is gaps.real        # unwrapped again
    rec = gaps.take()
    assert gaps.held is None
    t64 = rec["float64_total"]
    assert t64["topics_over_bound"] >= 1
    assert t64["topics_over_bound_and_row_rounding"] == 0
    assert 0 < t64["topic_row_rounding_bound"] <= rec["row_rounding_bound_max"]
    off = dict(kw, phi_k_total=kw["phi_k_total"] + 50.0)
    assert cs.phi_gap(torch, result, off)["float64_total"][
        "topics_over_bound_and_row_rounding"] == phi.shape[1]


def _dropping(real, name="phi_k64"):
    """``real`` (a sweep engine taking ``phi_k64``) with 0.5 token a topic
    taken from the float64 total it hands back."""
    def engine(*args, **kw):
        out = real(*args, **kw)
        if kw.get(name) is not None:
            kw[name] -= 0.5
        return out
    return engine


@pytest.mark.parametrize("scheduled", [False, True])
def test_checked_sweep_fires_on_a_faulty_kernel_total(monkeypatch,
                                                      scheduled):
    """The φ̂ totals invariant reads the float64 total that the engine
    returns: a sweep whose total drops half a token a topic raises the
    lockstep message, on inputs whose clean checked sweep passes (the
    two-phase and hooks modes: ``test_sharded_faulty_total_fires``)."""
    inputs = _at_scale()
    kw = dict(wb=0.4, **KW, debug_checks=True, device="cpu")
    if scheduled:
        kw["word_topics"] = _top3(inputs[4])
    ops.sweep(*inputs, **kw)
    name = "scheduled_sweep" if scheduled else "gs_sweep"
    monkeypatch.setattr(ops, name, _dropping(getattr(ops, name)))
    _expect(LOCKSTEP, lambda: ops.sweep(*inputs, **kw))


@pytest.mark.parametrize("scheduled", [False, True])
def test_checked_sweep_fires_on_a_faulty_float32_total(monkeypatch,
                                                       scheduled):
    """The float32 φ̂(k) that the sweep returns and the E-step reads is held
    to the float64 total: an engine whose float32 φ̂(k) drops half a token
    a topic, its float64 total intact, raises the port's float32 check (and
    only that: the lockstep check reads the total), on inputs whose clean
    checked sweep passes."""
    inputs, _ = _clean_sweep()
    kw = dict(wb=0.4, **KW, debug_checks=True, device="cpu")
    if scheduled:
        kw["word_topics"] = _top3(inputs[4])
    ops.sweep(*inputs, **kw)
    name = "scheduled_sweep" if scheduled else "gs_sweep"
    real = getattr(ops, name)

    def short(*args, **kwargs):
        out = list(real(*args, **kwargs))
        out[4] = out[4] - 0.5
        return tuple(out)

    monkeypatch.setattr(ops, name, short)
    with pytest.raises(ops.SanitizerError) as err:
        ops.sweep(*inputs, **kw)
    assert err.value.failed == [san.PHI_K_FLOAT32] == [str(err.value)]


def test_float32_total_check_holds_at_scale():
    """At a store's magnitude (3·10⁶ tokens a topic) a clean sweep's float32
    φ̂(k) passes the float32 check against its float64 total, and a total
    moved just past the check's single-device bound (L column adds of a
    half-ulp each) fails it."""
    wid, cnt, mu, theta, phi, ptot = _t(*_at_scale(seed=26))
    r = ops.sweep(wid, cnt, mu, theta, phi, ptot, wb=0.4, **KW,
                  device="cpu")
    total = ptot.to(torch.float64)  # lint: host-f64
    for inc in _increments(r.mu, mu, cnt, False):
        total = total + inc.to(torch.float64)  # lint: host-f64
    kw = dict(counts=cnt, phi_wk=r.phi_wk, phi_wk_before=phi, word_ids=wid)
    san.check_phi_k_float32(r.phi_k, total, ptot, **kw)
    L = cnt.shape[1]
    far = (ptot.double().abs() + r.phi_k.double().abs()
           + 2 * cnt.sum(dtype=torch.float64)) * L * san.U32  # lint: host-f64
    _expect("float32 phi_k parts", lambda: san.check_phi_k_float32(
        r.phi_k, total + 1.01 * far, ptot, **kw))


def _increments(mu_out, mu_in, counts, scheduled):
    """Each column's float32 φ̂(k) increment of a plain column loop, rebuilt
    from its μ output with the loop's own arithmetic — dense Δ = x·μ_new −
    x·μ_old, scheduled x·(μ_new − μ_old) — summed over the documents."""
    out = []
    for l in range(mu_in.shape[1]):
        x, new, old = counts[:, l, None], mu_out[:, l], mu_in[:, l]
        delta = x * (new - old) if scheduled else x * new - x * old
        out.append(delta.sum(0))
    return out


def _expected_total(phi_k, increments):
    """The input φ̂(k) in float64, plus each float32 increment in float64,
    in order."""
    total = phi_k.to(torch.float64)  # lint: host-f64
    for inc in increments:
        total = total + inc.to(torch.float64)  # lint: host-f64
    return total


def _close64(a, b):
    return torch.allclose(a, b, rtol=1e-12, atol=0.0)


def _capture_total(monkeypatch):
    """``sanitizer.sweep_invariants`` wrapped to keep the float64 total
    ``ops.sweep`` hands it."""
    got = []
    real = san.sweep_invariants

    def keep(result, **kw):
        got.append(kw.get("phi_k_total"))
        return real(result, **kw)

    monkeypatch.setattr(san, "sweep_invariants", keep)
    return got


@pytest.mark.parametrize("kind", ["dense", "scheduled"])
def test_float64_total_is_the_sum_of_the_fold_increments(monkeypatch, kind):
    """The total a checked ``ops.sweep`` hands the φ̂ checks is the input
    φ̂(k) plus, in float64, the float32 increments the column loop added to
    φ̂(k) (rebuilt here from its μ), 1e-12 relative; the wrapper's
    ``phi_k64`` gives the same total."""
    from repro_torch.kernels import gs_sweep, scheduled_sweep

    wid, cnt, mu, theta, phi, ptot = _t(*_state(seed=21))
    sk = {}
    if kind == "scheduled":
        sk = dict(word_topics=torch.as_tensor(_top3(phi.numpy())),
                  token_active=cnt > 0)
    got = _capture_total(monkeypatch)
    r = ops.sweep(wid, cnt, mu, theta, phi, ptot, wb=0.4, **KW, **sk,
                  debug_checks=True, device="cpu")
    want = _expected_total(ptot, _increments(r.mu, mu, cnt,
                                             kind == "scheduled"))
    assert got[0].dtype == torch.float64 and _close64(got[0], want)
    seed = ptot.to(torch.float64)  # lint: host-f64
    if kind == "dense":
        gs_sweep.gs_sweep(wid, cnt, mu, theta, phi, ptot, wb=0.4, **KW,
                          phi_k64=seed)
    else:
        scheduled_sweep.scheduled_sweep(
            wid, cnt, mu, theta, phi, ptot, sk["word_topics"].int(),
            sk["token_active"], wb=0.4, **KW, phi_k64=seed)
    assert torch.equal(seed, got[0])


@pytest.mark.parametrize("kind", ["dense", "scheduled"])
def test_checked_outputs_are_bitwise_unchecked(kind):
    """Every float32 output of a checked sweep is the unchecked sweep's,
    bit for bit (the float64 total is carried beside, never instead)."""
    inputs = _at_scale(seed=22)
    sk = {"word_topics": _top3(inputs[4])} if kind == "scheduled" else {}
    kw = dict(wb=0.4, **KW, **sk, compute_loglik=True, device="cpu")
    a = ops.sweep(*inputs, **kw)
    b = ops.sweep(*inputs, debug_checks=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_checked_trainer_step_runs_whole_at_scale(tmp_path, monkeypatch):
    """A checked ``FOEMTrainer.step`` against a store whose φ̂(k) is at a
    store's magnitude (a word outside the corpus with 3·10⁶ tokens a topic)
    runs whole; read from the float32 φ̂(k), as before the float64 total,
    its first sweep raises the lockstep message."""
    from repro_torch.core import FOEMTrainer, store_from_arrays
    from repro_torch.data import synthetic_lda_corpus
    from repro_torch.sparse import MinibatchStream

    W, K = 60, 8
    corpus, _ = synthetic_lda_corpus(40, W, K, mean_doc_len=20, seed=3)
    rng = np.random.default_rng(3)
    rows = np.vstack([rng.gamma(1.0, 1.0, (W, K)),
                      np.full((1, K), 3e6)]).astype(np.float32)
    store = store_from_arrays(str(tmp_path / "s"), rows, live_vocab=W + 1)
    cfg = LDAConfig(num_topics=K, vocab_size=W + 1, max_sweeps=4,
                    active_topics=3, ppl_check_every=2, debug_checks=True)
    mb = next(iter(MinibatchStream(corpus, 20, seed=0)))
    m = FOEMTrainer(cfg, store, seed=0, prefetch_depth=0,
                    device="cpu").step(mb)
    assert m.sweeps >= 2 and np.isfinite(m.train_ppl)
    real = san.sweep_invariants
    monkeypatch.setattr(san, "sweep_invariants", lambda r, **kw: real(
        r, **dict(kw, phi_k_total=None)))
    store2 = store_from_arrays(str(tmp_path / "t"), rows, live_vocab=W + 1)
    _expect(LOCKSTEP, lambda: FOEMTrainer(
        cfg, store2, seed=0, prefetch_depth=0, device="cpu").step(mb))


# ---------------------------------------------------------------------------
# The float64 total through both sharded modes, on a 2-rank gloo mesh
# ---------------------------------------------------------------------------

def _rank_inputs(mesh, scheduled, at_scale=True):
    m, mp = mesh.model.index, mesh.model.size
    make = _at_scale if at_scale else _state
    wid, cnt, mu, theta, phi, ptot = _t(*make(seed=24))
    lanes = slice(m * 8 // mp, (m + 1) * 8 // mp)
    args = (wid, cnt, mu[..., lanes].contiguous(),
            theta[:, lanes].contiguous(), phi[:, lanes].contiguous(),
            ptot[lanes].contiguous())
    sk = {}
    if scheduled:       # the rank's own top-2 of its 4 lanes
        order = torch.argsort(-args[4], dim=1, stable=True)[:, :2]
        sk = dict(word_topics=order.int(), token_active=cnt > 0)
    return args, sk


def _totals_rank(mesh):
    """One rank: for each sharded mode and form, the checked sweep's float64
    total against the fold's own increments (two-phase: plus phase D's Δ
    summed in float64), its float32 outputs against the unchecked run, the
    message a total short of 0.5 token a topic raises, and the messages a
    float32 φ̂(k) short of 0.5 token a topic raises on ``_state``'s
    inputs."""
    from repro_torch.kernels import sharded_sweep

    out = {}
    for mode in ("two_phase", "hooks"):
        for scheduled in (False, True):
            key = f"{mode}{'_scheduled' if scheduled else ''}"
            args, sk = _rank_inputs(mesh, scheduled)
            wid, cnt, mu = args[:3]
            plan = SweepPlan(axis_name=mesh.model,
                             two_phase=mode == "two_phase")
            kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=0.4, plan=plan,
                      device="cpu", **sk)
            got = []
            real = san.sweep_invariants

            def keep(result, **skw):
                got.append(skw.get("phi_k_total"))
                return real(result, **skw)

            san.sweep_invariants = keep
            try:
                checked = ops.sweep(*args, **kw, debug_checks=True)
            finally:
                san.sweep_invariants = real
            plain = ops.sweep(*args, **kw)
            out[key + ":bitwise"] = all(
                (x is None and y is None) or torch.equal(x, y)
                for x, y in zip(plain, checked))
            if mode == "two_phase":
                s, pm = sharded_sweep.sharded_probe(
                    *args, sk.get("word_topics"), sk.get("token_active"),
                    alpha_m1=0.01, beta_m1=0.01, wb=0.4)
                s_glob, pm_glob = ((mesh.model.all_reduce(s, pm)) if scheduled
                                   else (mesh.model.all_reduce(s)[0], None))
                fold = sharded_sweep.sharded_fold(
                    *args, s_glob - s, pm_glob, sk.get("word_topics"),
                    sk.get("token_active"), alpha_m1=0.01, beta_m1=0.01,
                    wb=0.4)
                want = _expected_total(args[5], _increments(
                    fold[0], mu, cnt, scheduled))
                delta = (checked.mu - fold[0]) * cnt[..., None]
                want = want + delta.sum((0, 1), dtype=torch.float64)  # lint: host-f64
            else:
                want = _expected_total(args[5], _increments(
                    checked.mu, mu, cnt, scheduled))
            out[key + ":total"] = float(
                ((got[0] - want).abs() / want.abs()).max())
            name = ("sharded_fold" if mode == "two_phase" else
                    "scheduled_sweep_reference" if scheduled
                    else "gs_sweep_reference")
            real_engine = getattr(ops, name)
            setattr(ops, name, _dropping(real_engine))
            try:
                ops.sweep(*args, **kw, debug_checks=True)
                out[key + ":fault"] = None
            except ops.SanitizerError as e:
                out[key + ":fault"] = str(e)
            finally:
                setattr(ops, name, real_engine)
            # the float32 φ̂(k) that the mode returns (re-summed from the
            # rows) half a token short, its float64 total intact
            args, sk = _rank_inputs(mesh, scheduled, at_scale=False)
            kw = dict(kw, **sk)

            def short(result, **skw):
                return real(result._replace(phi_k=result.phi_k - 0.5), **skw)

            san.sweep_invariants = short
            try:
                ops.sweep(*args, **kw, debug_checks=True)
                out[key + ":fault32"] = None
            except ops.SanitizerError as e:
                out[key + ":fault32"] = e.failed
            finally:
                san.sweep_invariants = real
    return out


@pytest.fixture(scope="module")
def sharded_totals():
    return spawn_mesh(_totals_rank, 1, 2, device="cpu", timeout=300)


FORMS = ["two_phase", "two_phase_scheduled", "hooks", "hooks_scheduled"]


@pytest.mark.parametrize("form", FORMS)
def test_sharded_total_is_its_own_fold(sharded_totals, form):
    """Two-phase: phase C's fold increments plus phase D's correction Δ,
    summed in float64; hooks: the plain loop's increments — never the
    re-summed rows (1e-12 relative, every rank)."""
    assert all(r[form + ":total"] <= 1e-12 for r in sharded_totals)


@pytest.mark.parametrize("form", FORMS)
def test_sharded_checked_outputs_are_bitwise_unchecked(sharded_totals, form):
    assert all(r[form + ":bitwise"] for r in sharded_totals)


@pytest.mark.parametrize("form", FORMS)
def test_sharded_faulty_total_fires(sharded_totals, form):
    """A total short of 0.5 token a topic raises the lockstep message on
    every rank, in both modes."""
    assert [r[form + ":fault"] for r in sharded_totals] == [LOCKSTEP] * 2


@pytest.mark.parametrize("form", FORMS)
def test_sharded_faulty_float32_total_fires(sharded_totals, form):
    """A float32 φ̂(k) short of 0.5 token a topic, its float64 total intact,
    raises the port's float32 check, and only it, on every rank."""
    assert [r[form + ":fault32"] for r in sharded_totals] == [
        [san.PHI_K_FLOAT32]] * 2


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


@pytest.mark.parametrize("case", ["independent_draw_raises", "dense_passes",
                                  "scheduled_passes", "faults_still_raise"])
def test_sweep_inputs_need_their_own_mass(case):
    """The card test's inputs (``test_torch_cuda._sweep_inputs(7, 6, 64,
    20, 4)``) through the plain sweeps on the CPU: with φ̂ drawn apart from
    the counts, the exclusion step takes out mass φ̂ never held and the
    clean dense sweep raises "negative values in phi_wk" — a fault of the
    inputs, not of a kernel or the sanitizer; with φ̂ holding the
    minibatch's own mass (``consistent=True``) the checked dense and
    scheduled sweeps pass, and the card test's planted faults still
    raise."""
    import test_torch_cuda as tc

    cpu = torch.device("cpu")
    kw = dict(**tc.SWEEP_KW, debug_checks=True, device=cpu)
    if case == "independent_draw_raises":
        wid, cnt, mu, theta, phi, ptot, _, _ = tc._sweep_inputs(
            7, 6, 64, 20, 4, cpu)
        _expect("sanitizer: negative values in phi_wk", lambda: ops.sweep(
            wid, cnt, mu, theta, phi, ptot, compute_loglik=True, **kw))
        return
    wid, cnt, mu, theta, phi, ptot, wt, act = tc._sweep_inputs(
        7, 6, 64, 20, 4, cpu, consistent=True)
    assert float(phi.min()) >= 0.0
    if case == "dense_passes":
        r = ops.sweep(wid, cnt, mu, theta, phi, ptot, compute_loglik=True,
                      **kw)
        assert r.loglik is not None
        return
    r = ops.sweep(wid, cnt, mu, theta, phi, ptot, word_topics=wt,
                  token_active=act, **kw)
    if case == "scheduled_passes":
        return
    _expect("phi_k deltas inconsistent", lambda: san.sweep_invariants(
        r._replace(phi_k=r.phi_k + 1.0), counts=cnt, mu_before=mu,
        phi_wk_before=phi, phi_k_before=ptot, word_topics=wt,
        token_active=act, word_ids=wid))
    bad = cnt.clone()
    bad[0, 0] = -1.0
    _expect("negative values in", lambda: ops.sweep(
        wid, bad, mu, theta, phi, ptot, **kw))
