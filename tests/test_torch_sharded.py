"""The port's topic-sharded FOEM step vs the JAX package, on the CPU.

* The plain versions of the two kernels (``sharded_probe_reference``,
  ``sharded_fold_reference``, ``loglik_partials``) against the JAX
  package's ``ops._probe_portable``/``_fold_portable``/``_loglik_partials``
  on the same numpy inputs, dense and scheduled, with injected cross-shard
  remainders: rtol 2e-5 / atol 1e-5 scaled by the array's magnitude (the
  reference's kernel-vs-portable tolerance; float32 sums over K in another
  order).
* ``ops.sweep`` under a one-rank two-phase plan against the port's own
  unsharded fused sweep (the JAX package's
  ``test_two_phase_single_shard_degenerates_to_fused``, atol 2e-6).
* ``foem_step_sharded`` on 4 gloo ranks against the JAX package's
  ``foem_step_sharded(impl="portable")`` on 4 fake CPU devices, meshes
  (data, model) = (2, 2) and (1, 4), dense (warm-up sweeps only) and
  scheduled (A = 8, λ_w = 0.9, the stop rule), both from the JAX package's
  μ₀ (``fold_in(key, model index)`` draws, injected per rank): φ̂ slices,
  φ̂(k) and the perplexity within rtol 1e-4 (atol 1e-4 of the largest
  entry), equal sweep counts; ``heldout_perplexity_sharded`` within rtol
  1e-4 from the JAX θ̂₀.  The case is free of selection ties: K = 16
  lanes, residuals and φ̂ drawn continuous, so the top-(A/mp) of 4 or 8
  lanes per word is decided by gaps far above float32 rounding; the equal
  sweep counts and the 1e-4 agreement of φ̂ after 9 scheduled sweeps show
  that the active sets agreed.
* The port alone: a bitwise repeat of the step, mass conservation, φ̂(k)
  re-summed from the rows after a sweep, the dense Σ_k μ = 1 over the
  ranks, the in-sweep loglik against
  ``_local_training_ppl``, the ``PRE_PROBE`` drop and kill faults, its
  own seeded initial state, and the contracts.

Each mesh is spawned once for the module (``spawn_mesh``, gloo), while the
JAX run goes on in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem
from repro.kernels import ops as jops
from repro_torch.core import em, foem_sharded
from repro_torch.core.types import (
    GlobalStats,
    InferPlan,
    LDAConfig,
    LocalState,
    MinibatchData,
    SweepPlan,
)
from repro_torch.kernels import ops
from repro_torch.kernels.sharded_sweep import (
    loglik_partials,
    probe_path,
    sharded_fold,
    sharded_fold_reference,
    sharded_probe,
    sharded_probe_reference,
)
from repro_torch.launch.mesh import MeshAxis, RankError, make_host_mesh, spawn_mesh
from repro_torch.runtime import FaultPlan, FaultSpec, InjectedFault, PRE_PROBE

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = [(2, 2), (1, 4)]
D, L, K, W = 16, 6, 16, 40     # D documents over the data axis
MODES = {
    "dense": dict(active_topics=8, warmup_sweeps=3, max_sweeps=3),
    "scheduled": dict(active_topics=8, warmup_sweeps=2, max_sweeps=9,
                      active_words_frac=0.9),
}
FIT = dict(fit_sweeps=12, check_every=3)


#: The sharded engines, by ``cfg.sharded_impl``, and the suffix of their
#: results' keys (the two-phase engine's keys carry none).
IMPLS = {"two_phase": "", "hooks": "_hooks"}


def _cfg(mode, mp, impl="two_phase"):
    return LDAConfig(num_topics=K, vocab_size=W, topk_shards=mp,
                     ppl_check_every=3, sharded_impl=impl, **MODES[mode])


def _tag(shape, mode=""):
    return f"{shape[0]}x{shape[1]}{mode and '_' + mode}"


def _row_sum(phi):
    """Σ_w φ̂_w per topic, accumulated in float64 and rounded once: the
    φ̂(k) that phase D leaves."""
    return phi.sum(0, dtype=torch.float64).to(phi.dtype)


def _close(x, y, name, rtol=2e-5, atol=1e-5):
    y = np.asarray(y)
    scale = max(1.0, float(np.abs(y).max())) if y.size else 1.0
    np.testing.assert_allclose(np.asarray(x), y, rtol=rtol,
                               atol=atol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# shared inputs: numpy minibatch and stats, JAX's μ₀ / θ̂₀ per shard
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(11)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0                          # a padded tail column
    wid[:, -1] = 0
    est = np.floor(cnt * 0.8).astype(np.float32)
    ev = (cnt - est).astype(np.float32)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32) * 3.0
    z = dict(wid=wid, cnt=cnt, est=est, ev=ev, phi=phi, phi_k=phi.sum(0))
    for shape in MESHES:
        dp, mp = shape
        # _foem_local's draw: every data shard of model index m draws the
        # same U(0.5, 1.5) slice from fold_in(key, m), normalised over K
        for seed, name in ((0, "mu0"), (1, "theta0")):
            key = jax.random.PRNGKey(seed)
            g = [np.asarray(jax.random.uniform(
                jax.random.fold_in(key, m), (D // dp, L, K // mp),
                minval=0.5, maxval=1.5)) for m in range(mp)]
            tot = sum(x.sum(-1, keepdims=True) for x in g)
            for m in range(mp):
                mu = (g[m] / tot).astype(np.float32)
                if name == "mu0":
                    z[f"{_tag(shape)}_mu0_{m}"] = mu
                    continue
                for d in range(dp):
                    rows = est[d * D // dp:(d + 1) * D // dp]
                    z[f"{_tag(shape)}_theta0_{d}_{m}"] = np.asarray(
                        jem.fold_theta(jnp.asarray(mu), jnp.asarray(rows)))
    return z


_JAX_RUN = """
import itertools, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import GlobalStats, LDAConfig, MinibatchData
from repro.core import foem as jfoem
from repro.core.foem_sharded import (foem_step_sharded,
                                     heldout_perplexity_sharded)
from repro.parallel.compat import make_mesh

z = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
calls = []
orig = jfoem.scheduled_iem_sweep

def counted(*a, **k):
    out = orig(*a, **k)
    jax.debug.callback(lambda: calls.append(1))
    return out

jfoem.scheduled_iem_sweep = counted   # counts the scheduled sweeps run
out = {}
batch = MinibatchData(jnp.asarray(z["wid"]), jnp.asarray(z["cnt"]))
for dp, mp in spec["meshes"]:
    mesh = make_mesh((dp, mp), ("data", "model"))
    sh = GlobalStats(phi_wk=NamedSharding(mesh, P(None, "model")),
                     phi_k=NamedSharding(mesh, P("model")),
                     step=NamedSharding(mesh, P()))
    for (mode, kw), impl in itertools.product(spec["modes"].items(),
                                              spec["impls"]):
        tag = f"{dp}x{mp}_{mode}" + ("_hooks" if impl == "hooks" else "")
        cfg = LDAConfig(num_topics=spec["K"], vocab_size=spec["W"],
                        topk_shards=mp, ppl_check_every=3,
                        sharded_impl=impl, **kw)
        stats = jax.device_put(GlobalStats(
            jnp.asarray(z["phi"]), jnp.asarray(z["phi_k"]), jnp.int32(0)), sh)
        calls.clear()
        with mesh:
            st, ppl = jax.jit(lambda k, b, s: foem_step_sharded(
                k, b, s, cfg, mesh, impl="portable"))(
                jax.random.PRNGKey(0), batch, stats)
            jax.block_until_ready(st)
            assert len(calls) % 4 == 0, len(calls)
            out[tag + "_phi"] = np.asarray(st.phi_wk)
            out[tag + "_phik"] = np.asarray(st.phi_k)
            out[tag + "_ppl"] = float(ppl)
            out[tag + "_sweeps"] = max(1, kw["warmup_sweeps"]) + len(calls) // 4
            if mode == "scheduled" and impl == "two_phase":
                hp = heldout_perplexity_sharded(
                    jax.random.PRNGKey(1),
                    MinibatchData(batch.word_ids, jnp.asarray(z["est"])),
                    MinibatchData(batch.word_ids, jnp.asarray(z["ev"])),
                    st, cfg, mesh, impl="portable", **spec["fit"])
                out[f"{dp}x{mp}_heldout"] = float(hp)
np.savez(sys.argv[2], **out)
"""


# ---------------------------------------------------------------------------
# the per-rank job (runs in each spawned rank)
# ---------------------------------------------------------------------------

def _rank_job(mesh, path):
    z = dict(np.load(path))
    dp, mp = mesh.data.size, mesh.model.size
    d, m = mesh.data.index, mesh.model.index
    tag = f"{dp}x{mp}"
    rows = slice(d * D // dp, (d + 1) * D // dp)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    batch = MinibatchData(t(z["wid"][rows]), t(z["cnt"][rows]))
    whole = GlobalStats(t(z["phi"]), t(z["phi_k"]),
                        torch.tensor(0, dtype=torch.int32))
    stats0 = foem_sharded.shard_stats(whole, mp, m)
    mu0 = z[f"{tag}_mu0_{m}"]
    out = {"coords": (d, m)}
    for mode in MODES:
        for impl in IMPLS:
            cfg = _cfg(mode, mp, impl)
            st, ppl, sweeps = foem_sharded.foem_step_sharded(
                None, batch, stats0, cfg, mesh, mu0=mu0)
            out[mode + IMPLS[impl]] = dict(
                phi=st.phi_wk.numpy(), phik=st.phi_k.numpy(), ppl=ppl,
                sweeps=sweeps, step=int(st.step))
    cfg = _cfg("scheduled", mp)
    st, ppl, sweeps = foem_sharded.foem_step_sharded(
        None, batch, stats0, cfg, mesh, mu0=mu0)
    out["repeat_bitwise"] = (
        np.array_equal(st.phi_wk.numpy(), out["scheduled"]["phi"])
        and np.array_equal(st.phi_k.numpy(), out["scheduled"]["phik"])
        and ppl == out["scheduled"]["ppl"]
        and sweeps == out["scheduled"]["sweeps"])
    # the port's own seeded initial state
    gen = torch.Generator().manual_seed(5)
    draw = foem_sharded._draw_slice(gen, (D // dp, L, K // mp), mesh)
    (tot,) = mesh.model.all_reduce(draw.sum(-1))
    st_own, ppl_own, sw_own = foem_sharded.foem_step_sharded(
        torch.Generator().manual_seed(5), batch, stats0, cfg, mesh)
    out["own"] = dict(draw=draw.numpy(), draw_sum=tot.numpy(),
                      phik=st_own.phi_k.numpy(), ppl=ppl_own, sweeps=sw_own)
    # held-out perplexity of the scheduled step's model
    sched = GlobalStats(t(out["scheduled"]["phi"]),
                        t(out["scheduled"]["phik"]), st.step)
    out["heldout"] = foem_sharded.heldout_perplexity_sharded(
        None, MinibatchData(batch.word_ids, t(z["est"][rows])),
        MinibatchData(batch.word_ids, t(z["ev"][rows])), sched, cfg, mesh,
        theta0=z[f"{tag}_theta0_{d}_{m}"], **FIT)
    # one dense two-phase sweep over the mesh: Σ_k μ over the ranks, the
    # in-sweep loglik against the standalone pass
    mu0_t = t(mu0)
    phi_w = stats0.phi_wk + em.fold_phi(mu0_t, batch.counts, batch.word_ids,
                                        W)[0]
    ptot_w = stats0.phi_k + (mu0_t * batch.counts[..., None]).sum((0, 1))
    r = em.gs_sweep_with_residuals(
        batch, LocalState(mu0_t, em.fold_theta(mu0_t, batch.counts)), phi_w,
        ptot_w, cfg, compute_loglik=True,
        plan=SweepPlan(axis_name=mesh.model))
    (mu_sum,) = mesh.model.all_reduce(r.mu.sum(-1))
    ll, ntok = mesh.data.all_reduce(r.loglik.reshape(1),
                                    batch.counts.sum().reshape(1))
    out["mu_sum"] = mu_sum.numpy()
    out["phik_is_rows_sum"] = bool(torch.equal(r.phi_k, _row_sum(r.phi_wk)))
    out["sweep_ppl"] = float(torch.exp(-ll / ntok)[0])
    out["standalone_ppl"] = float(foem_sharded._local_training_ppl(
        batch, r.theta, r.phi_wk, r.phi_k, cfg, mesh))
    # PRE_PROBE faults: a drop returns the stats unchanged, a kill raises
    drop = FaultPlan([FaultSpec(point=PRE_PROBE, kind="drop", step=0,
                                shard=mp - 1)])
    st_d, ppl_d, sw_d = foem_sharded.foem_step_sharded(
        None, batch, stats0, cfg, mesh, mu0=mu0, faults=drop)
    out["drop"] = dict(same=st_d is stats0, nan=math.isnan(ppl_d),
                       sweeps=sw_d, log=drop.fired_log())
    kill = FaultPlan([FaultSpec(point=PRE_PROBE, kind="kill", step=0,
                                shard=1)])
    try:
        foem_sharded.foem_step_sharded(None, batch, stats0, cfg, mesh,
                                       mu0=mu0, faults=kill)
        out["kill"] = None
    except InjectedFault as e:
        out["kill"] = dict(shard=e.shard, step=e.step, log=kill.fired_log())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {...}, (2, 2): [rank results], (1, 4): [...]}"""
    tmp = tmp_path_factory.mktemp("sharded")
    path = str(tmp / "inputs.npz")
    np.savez(path, **_inputs())
    spec = dict(meshes=MESHES, modes=MODES, impls=list(IMPLS), K=K, W=W,
                fit=FIT)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_RUN), path,
         str(tmp / "jax.npz"), json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    try:
        out = {shape: spawn_mesh(_rank_job, *shape, device="cpu",
                                 args=(path,), timeout=300)
               for shape in MESHES}
        _, err = jax_proc.communicate(timeout=400)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, err
    out["jax"] = dict(np.load(str(tmp / "jax.npz")))
    return out


def _model_ranks(results):
    """The ranks of data index 0, in model order."""
    return sorted((r for r in results if r["coords"][0] == 0),
                  key=lambda r: r["coords"][1])


# ---------------------------------------------------------------------------
# (a) the plain versions of the kernels vs the JAX package
# ---------------------------------------------------------------------------

def _state(Dn, Ln, Kn, Wn, seed, A=0):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, Wn, (Dn, Ln)).astype(np.int32)   # duplicate words
    cnt = rng.integers(0, 5, (Dn, Ln)).astype(np.float32)  # zero counts
    mu = rng.dirichlet(np.ones(Kn), (Dn, Ln)).astype(np.float32) * 0.4
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = rng.gamma(1.0, 1.0, (Wn, Kn)).astype(np.float32) + np.asarray(
        jem.fold_phi(jnp.asarray(mu), jnp.asarray(cnt), jnp.asarray(wid),
                     Wn)[0])
    s = dict(wid=wid, cnt=cnt, mu=mu, theta=theta, phi=phi,
             ptot=phi.sum(0), rem=rng.gamma(1.0, 0.05, (Dn, Ln)).astype(
                 np.float32))
    if A:
        s["wt"] = np.stack([rng.choice(Kn, A, replace=False)
                            for _ in range(Wn)]).astype(np.int32)
        s["act"] = (rng.random((Dn, Ln)) > 0.3) & (cnt > 0)
        masks = np.zeros((Wn, Kn), np.float32)
        np.put_along_axis(masks, s["wt"], 1.0, axis=-1)
        s["masks"] = masks
        local_pm = (masks[wid] * s["act"][..., None] * mu).sum(-1)
        s["pm"] = (local_pm + rng.random((Dn, Ln)) * 0.5).astype(np.float32)
    return s


KW = dict(alpha_m1=0.01, beta_m1=0.01)


@pytest.mark.parametrize("A", [0, 3])
@pytest.mark.parametrize("Dn,Ln,Kn,Wn", [(8, 6, 8, 12), (11, 5, 7, 9)])
def test_probe_reference_matches_jax(A, Dn, Ln, Kn, Wn):
    s = _state(Dn, Ln, Kn, Wn, seed=Dn + A, A=A)
    kw = dict(KW, wb=Wn * 0.01)
    j = jnp.asarray
    want = jops._probe_portable(
        j(s["wid"]), j(s["cnt"]), j(s["mu"]), j(s["theta"]), j(s["phi"]),
        j(s["ptot"]), j(s["masks"]) if A else None,
        j(s["act"]) if A else None, **kw)
    t = torch.from_numpy
    got = sharded_probe(
        t(s["wid"]), t(s["cnt"]), t(s["mu"]), t(s["theta"]), t(s["phi"]),
        t(s["ptot"]), t(s["wt"]) if A else None, t(s["act"]) if A else None,
        **kw)
    _close(got[0].numpy(), want[0], "s")
    if A:
        _close(got[1].numpy(), want[1], "prev_mass")
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("A", [0, 3])
@pytest.mark.parametrize("Dn,Ln,Kn,Wn", [(8, 6, 8, 12), (11, 5, 7, 9)])
def test_fold_reference_matches_jax(A, Dn, Ln, Kn, Wn):
    s = _state(Dn, Ln, Kn, Wn, seed=Dn + A + 1, A=A)
    kw = dict(KW, wb=Wn * 0.01)
    j = jnp.asarray
    want = jops._fold_portable(
        j(s["wid"]), j(s["cnt"]), j(s["mu"]), j(s["theta"]), j(s["phi"]),
        j(s["ptot"]), j(s["rem"]), j(s["pm"]) if A else None,
        j(s["masks"]) if A else None, j(s["act"]) if A else None, **kw,
        unroll=4)
    want_u = jops._loglik_partials(j(s["wid"]), want[2], want[3], want[4],
                                   **kw)
    t = torch.from_numpy
    got = sharded_fold(
        t(s["wid"]), t(s["cnt"]), t(s["mu"]), t(s["theta"]), t(s["phi"]),
        t(s["ptot"]), t(s["rem"]), t(s["pm"]) if A else None,
        t(s["wt"]) if A else None, t(s["act"]) if A else None, **kw,
        emit_loglik=True)
    names = ("mu", "residual", "theta", "phi_wk", "phi_k", "live_mass")
    for name, a, b in zip(names, got, want):
        _close(a.numpy(), b, name)
    _close(got[6].numpy(), want_u, "loglik_u")
    # the plain version alone is also what the JAX package's loglik gives
    _close(loglik_partials(t(s["wid"]), got[2], got[3], got[4], **kw)
           .numpy(), want_u, "loglik_partials")


def test_fold_reference_with_zero_remainder_is_the_fused_sweep():
    """remainder 0 and the local prev mass: the fold is the unsharded
    sweep (what the card test holds the fold kernel to)."""
    s = _state(9, 7, 6, 8, seed=4, A=2)
    t = torch.from_numpy
    kw = dict(KW, wb=8 * 0.01)
    zero = torch.zeros((9, 7))
    for A in (0, 2):
        sk = (dict(word_topics=t(s["wt"]), token_active=t(s["act"]))
              if A else {})
        pm, = ([sharded_probe_reference(
            t(s["wid"]), t(s["cnt"]), t(s["mu"]), t(s["theta"]), t(s["phi"]),
            t(s["ptot"]), t(s["wt"]), t(s["act"]), **kw)[1]] if A else [None])
        got = sharded_fold_reference(
            t(s["wid"]), t(s["cnt"]), t(s["mu"]), t(s["theta"]), t(s["phi"]),
            t(s["ptot"]), zero, pm, sk.get("word_topics"),
            sk.get("token_active"), **kw)
        want = ops.sweep(s["wid"], s["cnt"], s["mu"], s["theta"], s["phi"],
                         s["ptot"], **kw, **sk, device="cpu")
        for name, a in zip(("mu", "residual", "theta", "phi_wk", "phi_k"),
                           got):
            _close(a.numpy(), getattr(want, name).numpy(), name, atol=2e-6)


@pytest.mark.parametrize("A", [0, 2])
def test_fold_reference_keeps_phi_k_on_the_rows_in_float64(A):
    """The fold adds the same Δ to φ̂(k) and to the φ̂ rows, so in float64
    φ̂(k) stays Σ_w φ̂_w per topic over many sweeps even at ~1e5 tokens a
    topic: a float32 run's drift between the two is rounding of the
    running φ̂(k) total, not a lost or doubled Δ."""
    s = _state(16, 8, 6, 10, seed=6, A=2)
    t = lambda x: torch.from_numpy(x).double()              # noqa: E731
    phi = t(s["phi"]) * 1e4
    ptot = phi.sum(0)
    mu, theta = t(s["mu"]), t(s["theta"])
    sk = (t(s["pm"]), torch.from_numpy(s["wt"]),
          torch.from_numpy(s["act"])) if A else ()
    for _ in range(8):
        mu, _, theta, phi, ptot, _, _ = sharded_fold_reference(
            torch.from_numpy(s["wid"]), t(s["cnt"]), mu, theta, phi, ptot,
            t(s["rem"]), *sk, **KW, wb=10 * 0.01)
    np.testing.assert_allclose(ptot.numpy(), phi.sum(0).numpy(),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# (b) one rank: the two-phase plan degenerates to the fused sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("A", [0, 3])
@pytest.mark.parametrize("loglik", [False, True])
def test_two_phase_single_rank_degenerates_to_fused(A, loglik):
    s = _state(8, 6, 8, 12, seed=3 + A, A=A)
    sk = dict(word_topics=s["wt"], token_active=s["act"]) if A else {}
    kw = dict(KW, wb=12 * 0.01, compute_loglik=loglik, device="cpu")
    args = (s["wid"], s["cnt"], s["mu"], s["theta"], s["phi"], s["ptot"])
    want = ops.sweep(*args, **kw, **sk)
    mesh = make_host_mesh(1, 1, device="cpu")
    got = ops.sweep(*args, **kw, **sk, plan=SweepPlan(axis_name=mesh.model))
    for name in ("mu", "theta", "phi_wk", "residual"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), atol=2e-6,
                                   err_msg=name)
    # phase D re-sums φ̂(k) from the rows; the fused sweep carries a running
    # total, a few float32 ulps away from its own rows' sum
    assert torch.equal(got.phi_k, _row_sum(got.phi_wk))
    np.testing.assert_allclose(got.phi_k.numpy(),
                               _row_sum(want.phi_wk).numpy(), atol=2e-6,
                               err_msg="phi_k")
    if loglik:
        np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                                   rtol=1e-5)
    else:
        assert got.loglik is None


# ---------------------------------------------------------------------------
# (b') the per-column hooks mode on one rank and with raw hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("A", [0, 3])
def test_identity_hooks_are_the_hook_free_sweep_bitwise(A):
    """Identity ``norm_psum`` (dense) / ``renorm_psum`` (scheduled), and a
    one-rank hooks plan, reproduce the hook-free plain sweep bitwise (the
    JAX package's ``test_sched_portable_renorm_hook_identity``); the plan
    leaves φ̂(k) the float64 sum of the rows, as phase D does."""
    s = _state(6, 5, 8, 48, seed=2, A=A)
    sk = dict(word_topics=s["wt"], token_active=s["act"]) if A else {}
    args = (s["wid"], s["cnt"], s["mu"], s["theta"], s["phi"], s["ptot"])
    kw = dict(KW, wb=48 * 0.01, device="cpu", **sk)
    plain = ops.sweep(*args, **kw)
    seen = []

    def identity(x):
        seen.append(tuple(x.shape))
        return x

    hook = {"renorm_psum" if A else "norm_psum": identity}
    hooked = ops.sweep(*args, **kw, **hook)
    one_rank = ops.sweep(*args, **kw, plan=SweepPlan(
        axis_name=MeshAxis("model", 1, 0), two_phase=False))
    # one (D, 1) call a column; two (mass, then new sum) when scheduled
    assert seen == [(6, 1)] * 5 * (2 if A else 1)
    for got in (hooked, one_rank):
        for name in ("mu", "theta", "phi_wk", "residual"):
            assert torch.equal(getattr(plain, name), getattr(got, name)), name
    assert torch.equal(hooked.phi_k, plain.phi_k)
    assert torch.equal(one_rank.phi_k, _row_sum(plain.phi_wk))


@pytest.mark.parametrize("mode", list(MODES))
def test_hooks_step_on_one_model_rank_is_the_unsharded_step(mode):
    """``foem_step_sharded(sharded_impl="hooks")`` on a mesh of one model
    rank is ``foem.foem_step`` from the same μ₀: the same column loops, the
    reductions the identity.  φ̂(k) differs only by the rounding of the
    loop's float32 running total, which the hooks plan replaces by the
    rows' float64 sum each sweep, and that rounding alone reaches the
    later sweeps' arithmetic: φ̂ and φ̂(k) within 1e-6 of the largest
    entry, equal sweeps, the perplexity (the stop rule's loglik, summed in
    another order too) within rtol 1e-6."""
    from repro_torch.core import foem

    z = _inputs()
    t = torch.from_numpy
    batch = MinibatchData(t(z["wid"]), t(z["cnt"]))
    stats = GlobalStats(t(z["phi"]), t(z["phi_k"]), torch.tensor(0))
    rng = np.random.default_rng(4)
    mu0 = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    cfg = _cfg(mode, 1, "hooks")
    st, ppl, sweeps = foem_sharded.foem_step_sharded(
        None, batch, stats, cfg, make_host_mesh(device="cpu"), mu0=mu0)
    want, _, diag = foem.foem_step(None, batch, stats, cfg, mu0=mu0,
                                   device="cpu")
    _close(st.phi_wk.numpy(), want.phi_wk.numpy(), "phi_wk", rtol=0,
           atol=1e-6)
    _close(st.phi_k.numpy(), want.phi_k.numpy(), "phi_k", rtol=0, atol=1e-6)
    assert torch.equal(st.phi_k, _row_sum(st.phi_wk))
    assert sweeps == diag.sweeps_run
    np.testing.assert_allclose(ppl, float(diag.final_train_ppl), rtol=1e-6)


def test_sharded_plan_rejects_raw_hooks():
    """Contract errors (the JAX package's
    ``test_sharded_plan_rejects_raw_hooks_and_kernel_hooks``): a sharded
    plan is exclusive with raw hooks, in either engine, and each raw hook
    belongs to its sweep's form.  The port has no forced-kernel option, so
    the JAX refusal of a hook on a kernel path has no counterpart."""
    s = _state(8, 4, 6, 32, seed=9, A=2)
    args = (s["wid"], s["cnt"], s["mu"], s["theta"], s["phi"], s["ptot"])
    kw = dict(KW, wb=32 * 0.01, device="cpu")
    axis = MeshAxis("model", 1, 0)
    for two_phase in (True, False):
        with pytest.raises(ValueError, match="not both"):
            ops.sweep(*args, **kw, norm_psum=lambda x: x,
                      plan=SweepPlan(axis_name=axis, two_phase=two_phase))
    with pytest.raises(ops.ContractError, match="takes renorm_psum"):
        ops.sweep(*args, **kw, word_topics=s["wt"], norm_psum=lambda x: x)
    with pytest.raises(ops.ContractError, match="takes norm_psum"):
        ops.sweep(*args, **kw, renorm_psum=lambda x: x)
    with pytest.raises(ops.ContractError, match="callable"):
        ops.sweep(*args, **kw, norm_psum=1.0)
    with pytest.raises(ops.ContractError, match="two_phase"):
        ops.sweep(*args, **kw, plan=SweepPlan(axis_name=axis, two_phase=0))


# ---------------------------------------------------------------------------
# (c) the sharded step on 4 gloo ranks vs the JAX package on 4 devices
# ---------------------------------------------------------------------------

def _check_step_matches_jax(runs, shape, mode, key):
    jx = runs["jax"]
    tag = _tag(shape, mode) + IMPLS["hooks" if key.endswith("_hooks")
                                    else "two_phase"]
    ranks = _model_ranks(runs[shape])
    phi = np.concatenate([r[key]["phi"] for r in ranks], 1)
    phik = np.concatenate([r[key]["phik"] for r in ranks])
    _close(phi, jx[tag + "_phi"], "phi_wk", rtol=1e-4, atol=1e-4)
    _close(phik, jx[tag + "_phik"], "phi_k", rtol=1e-4, atol=1e-4)
    if mode == "scheduled":        # the scheduled sweeps did run
        assert int(jx[tag + "_sweeps"]) > MODES[mode]["warmup_sweeps"]
    for r in runs[shape]:
        assert r[key]["sweeps"] == int(jx[tag + "_sweeps"])
        assert r[key]["step"] == 1
        np.testing.assert_allclose(r[key]["ppl"], float(jx[tag + "_ppl"]),
                                   rtol=1e-4)
        # data ranks of one model index hold the same slice, up to the
        # rounding of their own Δφ̂ in the data-axis fold (φ̂ + (Σ − own))
        twin = ranks[r["coords"][1]]
        _close(r[key]["phi"], twin[key]["phi"], "data twins", rtol=1e-6,
               atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_foem_step_sharded_matches_jax(runs, shape, mode):
    _check_step_matches_jax(runs, shape, mode, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_foem_step_sharded_hooks_matches_jax(runs, shape, mode):
    """``sharded_impl="hooks"`` — the per-column reductions on the plain
    column loops — against the JAX package's hooks step on the same mesh
    from the same μ₀: φ̂, φ̂(k) and the perplexity within rtol 1e-4, equal
    sweep counts."""
    _check_step_matches_jax(runs, shape, mode, mode + "_hooks")


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_heldout_perplexity_sharded_matches_jax(runs, shape):
    want = float(runs["jax"][_tag(shape) + "_heldout"])
    for r in runs[shape]:
        np.testing.assert_allclose(r["heldout"], want, rtol=1e-4)
        assert 1.0 < r["heldout"] < W


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_sharded_step_repeats_bitwise(runs, shape):
    assert all(r["repeat_bitwise"] for r in runs[shape])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_sharded_step_conserves_mass(runs, shape, mode):
    """Σ φ̂(k) over the model axis grows by the minibatch's tokens, and
    every φ̂ row stays non-negative."""
    ranks = _model_ranks(runs[shape])
    grown = sum(float(r[mode]["phik"].astype(np.float64).sum())
                for r in ranks)
    inputs = _inputs()
    np.testing.assert_allclose(
        grown - float(inputs["phi_k"].astype(np.float64).sum()),
        float(inputs["cnt"].sum()), rtol=1e-4)
    assert all((r[mode]["phi"] >= -1e-4).all() for r in ranks)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_two_phase_sweep_sums_phi_k_from_the_rows(runs, shape):
    """Phase D leaves φ̂(k) the float64 sum of the rank's corrected rows,
    rounded once, not the fold's float32 running total."""
    assert all(r["phik_is_rows_sum"] for r in runs[shape])


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_dense_two_phase_sweep_normalises_over_ranks(runs, shape):
    """After phase D, Σ_k μ over every rank's lanes is 1 for every token;
    the in-sweep loglik matches the standalone pass within the phase-D
    correction's effect (rtol 1e-2, the JAX package's bound)."""
    for r in runs[shape]:
        np.testing.assert_allclose(r["mu_sum"], 1.0, atol=1e-5)
        np.testing.assert_allclose(r["sweep_ppl"], r["standalone_ppl"],
                                   rtol=1e-2)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_pre_probe_drop_and_kill(runs, shape):
    mp = shape[1]
    for r in runs[shape]:
        drop = r["drop"]
        assert drop["same"] and drop["nan"] and drop["sweeps"] == 0
        assert drop["log"] == [("drop", PRE_PROBE, mp - 1, 0)]
        kill = r["kill"]
        assert kill is not None and (kill["shard"], kill["step"]) == (1, 0)
        assert kill["log"] == [("kill", PRE_PROBE, 1, 0)]


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_seeded_initial_state(runs, shape):
    """Without μ₀ a rank draws its slice from the generator folded with its
    model index: ranks of one model index draw the same values, the slices
    sum to 1 over all lanes, and the step runs and conserves mass."""
    by_model = {}
    for r in runs[shape]:
        own = r["own"]
        np.testing.assert_allclose(own["draw_sum"], 1.0, rtol=1e-6)
        by_model.setdefault(r["coords"][1], []).append(own["draw"])
        assert 2 <= own["sweeps"] <= MODES["scheduled"]["max_sweeps"]
        assert np.isfinite(own["ppl"]) and 1.0 < own["ppl"] < W
    for draws in by_model.values():
        for x in draws[1:]:
            np.testing.assert_array_equal(x, draws[0])
    firsts = [v[0] for v in by_model.values()]
    assert not np.array_equal(firsts[0], firsts[1])


# ---------------------------------------------------------------------------
# (d) the mesh and the contracts
# ---------------------------------------------------------------------------

def test_sharded_step_refuses_a_config_that_does_not_split():
    mesh = make_host_mesh(device="cpu")
    s = _state(4, 3, 6, 5, seed=1)
    stats = GlobalStats(torch.from_numpy(s["phi"]),
                        torch.from_numpy(s["ptot"]), torch.tensor(0))
    batch = MinibatchData(torch.from_numpy(s["wid"]),
                          torch.from_numpy(s["cnt"]))
    cfg = LDAConfig(num_topics=6, vocab_size=5, active_topics=2,
                    topk_shards=2)
    with pytest.raises(ValueError, match="topk_shards"):
        foem_sharded.foem_step_sharded(None, batch, stats, cfg, mesh)


class _Ptr:
    """A stand-in operand with a given base address."""

    def __init__(self, addr):
        self.addr = addr

    def data_ptr(self):
        return self.addr


@pytest.mark.parametrize("K,A,addrs,want", [
    (2500, 0, (0, 16, 32, 48), ("float4", 0)),   # stream_1k over 4 ranks
    (625, 0, (0, 16, 32, 48), ("scalar", 1)),    # K/mp % 4 != 0
    (2500, 0, (4, 16, 32, 48), ("scalar", 1)),   # an unaligned μ
    (2500, 0, (0, 16, 32, 8), ("scalar", 1)),    # an unaligned φ̂(k)
    (2500, 1, (4, 0, 0, 0), ("packed", 1)),      # 32 tokens a warp
    (2500, 3, (0, 0, 0, 0), ("packed", 4)),
    (2500, 4, (0, 0, 0, 0), ("packed", 4)),      # stream_1k's A/mp
    (2500, 8, (0, 0, 0, 0), ("packed", 8)),
    (2500, 9, (0, 0, 0, 0), ("packed", 16)),
    (2500, 33, (0, 0, 0, 0), ("packed", 32)),    # a warp a token, looping
])
def test_probe_path_by_width_alignment_and_active_lanes(K, A, addrs, want):
    assert tuple(probe_path(K, A, [_Ptr(a) for a in addrs])) == want


def test_shard_and_unshard_stats_round_trip():
    rng = np.random.default_rng(0)
    phi = torch.from_numpy(rng.random((5, 12)).astype(np.float32))
    whole = GlobalStats(phi, phi.sum(0), torch.tensor(3))
    parts = [foem_sharded.shard_stats(whole, 3, m) for m in range(3)]
    assert parts[1].phi_wk.shape == (5, 4)
    back = foem_sharded.unshard_stats(parts)
    assert torch.equal(back.phi_wk, phi) and torch.equal(back.phi_k,
                                                         phi.sum(0))
    with pytest.raises(ValueError, match="split"):
        foem_sharded.shard_stats(whole, 5, 0)


def _raise_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    (x,) = mesh.model.all_reduce(torch.ones(2))
    return float(x.sum())


def test_spawn_mesh_reraises_a_rank_exception():
    with pytest.raises(RankError, match="rank one fails on purpose"):
        spawn_mesh(_raise_on_rank_one, 1, 2, device="cpu", timeout=120)


def test_mesh_axis_of_one_rank_is_the_identity():
    axis = MeshAxis("model", 1, 0)
    x = torch.arange(3.0)
    assert axis.all_reduce(x)[0] is x
    mesh = make_host_mesh(device="cpu")
    assert (mesh.data.size, mesh.model.size, mesh.rank) == (1, 1, 0)
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2, 2, device="cpu")


def test_sharded_plans_refuse_hooks_strings_and_quantized_phi():
    """A sharded plan refuses raw hooks (in the hooks mode too), a string
    axis, and quantized φ for the sharded fit."""
    s = _state(4, 3, 4, 6, seed=0)
    args = (s["wid"], s["cnt"], s["mu"], s["theta"], s["phi"], s["ptot"])
    kw = dict(KW, wb=0.06, device="cpu")
    axis = MeshAxis("model", 1, 0)
    with pytest.raises(ops.ContractError, match="hooks, not both"):
        ops.sweep(*args, **kw, norm_psum=lambda x: x,
                  plan=SweepPlan(axis_name=axis, two_phase=False))
    with pytest.raises(ops.ContractError, match="mesh.model"):
        ops.sweep(*args, **kw, plan=SweepPlan(axis_name="model"))
    with pytest.raises(ops.ContractError, match="hooks, not both"):
        ops.sweep(*args, **kw, plan=SweepPlan(axis_name=axis),
                  renorm_psum=lambda x: x)
    phi_n = s["phi"] / s["ptot"]
    with pytest.raises(ops.ContractError, match="float32 phi"):
        ops.infer(s["wid"], s["cnt"], s["theta"], phi_n, alpha_m1=0.01,
                  plan=InferPlan(axis_name=axis, phi_dtype="int8"),
                  device="cpu")


def test_sharded_infer_on_one_rank_is_the_plain_fit():
    """A one-rank sharded InferPlan gives the unsharded plain fit."""
    s = _state(6, 5, 8, 10, seed=2)
    phi_n = s["phi"] / s["ptot"]
    kw = dict(alpha_m1=0.01, ev_counts=s["cnt"] * 0.5, max_sweeps=6,
              check_every=3, device="cpu")
    want = ops.infer(s["wid"], s["cnt"], s["theta"], phi_n, **kw)
    got = ops.infer(s["wid"], s["cnt"], s["theta"], phi_n, **kw,
                    plan=InferPlan(axis_name=MeshAxis("model", 1, 0)))
    np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.ev_loglik), float(want.ev_loglik),
                               rtol=1e-5)
    assert got.sweeps == want.sweeps == 6
