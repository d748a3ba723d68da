"""Port's training sweeps vs the JAX package, on the CPU.

The same seeded numpy inputs — with duplicate words inside a column, zero
counts and a padded tail column — go through the JAX package's plain path
(``ops.sweep(use_pallas=False)``: its Pallas sweeps cannot run on this jax)
and the port's ``ops.sweep(device="cpu")``, dense and scheduled, with and
without the stop-rule log-likelihood.  Tolerances are the reference's
kernel-vs-portable ones (``tests/test_gs_sweep.py``): rtol 2e-5 and atol
1e-5 scaled by the array's magnitude; logliks rtol 1e-5.  The port's own
copies of the reference's invariants run on the port alone: zero-count
slots inert, inactive entries untouched, mass conservation, the scheduler
refresh equivalence, the in-sweep loglik against ``training_perplexity``,
the global W reaching the sweep, and the eager contracts.  The dense CUDA
column loop's host-side choices are checked here too: its path by K and
alignment, its document groups, its column plan (tokens folding their rows
in the E-step, the shared words' segments) and a Python walk of the loop in
that plan against the plain sweep, and the stop rule's per-token partials.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem
from repro.core import scheduling as jsched
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import LocalState as JLocalState
from repro.core.types import MinibatchData as JMinibatchData
from repro.core.types import SchedulerState as JSchedulerState
from repro.kernels import ops as jops
from repro_torch.core import em, scheduling
from repro_torch.core.types import (
    LDAConfig,
    LocalState,
    MinibatchData,
    SchedulerState,
    SweepPlan,
    from_numpy,
)
from repro_torch.kernels import ops
from repro_torch.kernels.gs_sweep import (
    GROUP_DOCS,
    REG_MAX_K,
    SHARED,
    SOLO,
    column_plan,
    dense_path,
    doc_groups,
    gs_sweep,
    gs_sweep_reference,
    sweep_loglik,
    sweep_loglik_partials,
    token_loglik,
)
from repro_torch.kernels.scheduled_sweep import (
    scheduled_sweep,
    scheduled_sweep_reference,
)
from repro_torch.launch.mesh import MeshAxis
from repro_torch.runtime import FaultPlan, FaultSpec, InjectedFault, PRE_PROBE
from repro_torch.runtime.faults import active_plan


def _state(D, L, K, W, seed=0, A=0):
    """Seeded numpy minibatch state: W small enough that words repeat in a
    column, zero counts, a zero tail column; residual-ranked active sets
    (the JAX package's selection) and a λ_w-style token mask when A > 0."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = np.array(jem.fold_phi(jnp.asarray(mu), jnp.asarray(cnt),
                                  jnp.asarray(wid), W)[0])
    phi = phi + rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    ptot = phi.sum(0)
    out = dict(wid=wid, cnt=cnt, mu=mu, theta=theta, phi=phi, ptot=ptot)
    if A:
        r_wk = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
        out["r_wk"] = r_wk
        out["wt"] = np.array(jsched.select_active_topics(
            JSchedulerState(jnp.asarray(r_wk), jnp.asarray(r_wk.sum(-1))),
            A))
        out["act"] = (rng.random((D, L)) > 0.3) & (cnt > 0)
    return out


def _kw(W):
    return dict(alpha_m1=0.01, beta_m1=0.01, wb=W * 0.01)


def _args(s):
    return (s["wid"], s["cnt"], s["mu"], s["theta"], s["phi"], s["ptot"])


def _sched_kw(s):
    return dict(word_topics=s["wt"], token_active=s["act"]) if "wt" in s \
        else {}


def _close(x, y, name, rtol=2e-5, atol=1e-5):
    y = np.asarray(y)
    scale = max(1.0, float(np.abs(y).max())) if y.size else 1.0
    np.testing.assert_allclose(np.asarray(x), y, rtol=rtol,
                               atol=atol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# (a) ops.sweep vs the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,L,K,W,A", [
    (5, 6, 7, 9, 0),
    (16, 12, 32, 64, 0),
    (12, 9, 13, 6, 0),
    (8, 7, 16, 12, 4),
    (16, 12, 32, 64, 16),
    (9, 5, 11, 7, 1),
    (6, 4, 8, 5, 8),          # A = K
])
@pytest.mark.parametrize("loglik", [False, True])
def test_sweep_matches_jax(D, L, K, W, A, loglik):
    s = _state(D, L, K, W, seed=D * L + K + A, A=A)
    want = jops.sweep(*map(jnp.asarray, _args(s)), **_kw(W),
                      **{k: jnp.asarray(v) for k, v in _sched_kw(s).items()},
                      compute_loglik=loglik, use_pallas=False)
    got = ops.sweep(*_args(s), **_kw(W), **_sched_kw(s),
                    compute_loglik=loglik, device="cpu")
    for name in ("mu", "theta", "phi_wk", "phi_k", "residual"):
        _close(getattr(got, name).numpy(), getattr(want, name), name)
    if loglik:
        np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                                   rtol=1e-5)
    else:
        assert got.loglik is None


@pytest.mark.parametrize("A", [0, 3])
def test_wrappers_run_plain_version_on_cpu(A):
    """On CPU tensors the kernel wrappers are their plain versions."""
    s = _state(6, 5, 9, 7, seed=1, A=A)
    t = [torch.from_numpy(x) for x in _args(s)]
    if A:
        t += [torch.from_numpy(s["wt"]), torch.from_numpy(s["act"])]
        a = scheduled_sweep(*t, **_kw(7), emit_loglik=True)
        b = scheduled_sweep_reference(*t, **_kw(7), emit_loglik=True)
    else:
        a = gs_sweep(*t, **_kw(7), emit_loglik=True)
        b = gs_sweep_reference(*t, **_kw(7), emit_loglik=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrappers_refuse_other_devices():
    t = torch.zeros((1, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gs_sweep(t.int(), t, t[..., None], t, t, t[0], **_kw(2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        scheduled_sweep(t.int(), t, t[..., None], t, t, t[0], t.int(),
                        t.bool(), **_kw(2))


def test_fold_and_estep_match_jax():
    s = _state(8, 6, 10, 12, seed=4)
    cfg = JLDAConfig(num_topics=10, vocab_size=12)
    d_wk, d_k = jem.fold_phi(jnp.asarray(s["mu"]), jnp.asarray(s["cnt"]),
                             jnp.asarray(s["wid"]), 12)
    p_wk, p_k = em.fold_phi(torch.from_numpy(s["mu"]),
                            torch.from_numpy(s["cnt"]),
                            torch.from_numpy(s["wid"]), 12)
    _close(p_wk.numpy(), d_wk, "fold_phi")
    _close(p_k.numpy(), d_k, "fold_phi totals")
    rows = s["phi"][s["wid"]]
    ex = s["cnt"][..., None] * s["mu"]
    want = jem.estep(jnp.asarray(s["theta"])[:, None], jnp.asarray(rows),
                     jnp.asarray(s["ptot"]), cfg, exclude=jnp.asarray(ex))
    got = em.estep(torch.from_numpy(s["theta"])[:, None],
                   torch.from_numpy(rows), torch.from_numpy(s["ptot"]),
                   LDAConfig(num_topics=10, vocab_size=12),
                   exclude=torch.from_numpy(ex))
    _close(got.numpy(), want, "estep")


# ---------------------------------------------------------------------------
# (b) invariants, on the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("A", [0, 3])
def test_zero_count_slots_inert_and_mass_conserved(A):
    """Padding slots (count 0) move no statistic and carry zero residual;
    the token mass is conserved in θ̂, φ̂ and φ̂(k)."""
    D, L, K, W = 8, 5, 4, 32
    s = _state(D, L, K, W, seed=7, A=A)
    r = ops.sweep(*_args(s), **_kw(W), **_sched_kw(s), device="cpu")
    zero = s["cnt"] == 0
    assert np.all(r.residual.numpy()[zero] == 0.0)
    np.testing.assert_allclose(r.theta.sum(-1).numpy(), s["cnt"].sum(1),
                               rtol=1e-5)
    np.testing.assert_allclose(r.phi_k.sum().numpy(), s["ptot"].sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(r.phi_wk.sum(0).numpy(), r.phi_k.numpy(),
                               rtol=1e-5)
    # every μ row keeps unit mass (eq. 38 preserves it on the active set)
    np.testing.assert_allclose(r.mu.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_scheduled_inactive_entries_untouched():
    """Off-active-set μ entries and λ_w-skipped tokens keep μ_old exactly
    and carry zero residual (priority-queue semantics need exact zeros)."""
    D, L, K, W, A = 8, 5, 9, 6, 3
    s = _state(D, L, K, W, seed=7, A=A)
    r = ops.sweep(*_args(s), **_kw(W), **_sched_kw(s), device="cpu")
    on_active = np.zeros((D, L, K), bool)
    np.put_along_axis(on_active, s["wt"][s["wid"]], True, axis=-1)
    mu, res = r.mu.numpy(), r.residual.numpy()
    np.testing.assert_array_equal(mu[~on_active], s["mu"][~on_active])
    np.testing.assert_array_equal(mu[~s["act"]], s["mu"][~s["act"]])
    assert np.all(res[~on_active] == 0.0)
    assert np.all(res[~s["act"]] == 0.0)


def test_scheduler_update_from_sweep_equivalence():
    """One segment sum over the full-K residual ≡ the compact
    ``scatter_residuals`` + ``update_residuals`` refresh."""
    D, L, K, W, A = 6, 7, 8, 10, 3
    s = _state(D, L, K, W, seed=11, A=A)
    r = ops.sweep(*_args(s), **_kw(W), **_sched_kw(s), device="cpu")
    r_wk = torch.from_numpy(s["r_wk"])
    sched = SchedulerState(r_wk, r_wk.sum(-1))
    wid = torch.from_numpy(s["wid"])
    wt = torch.from_numpy(s["wt"])
    got = scheduling.scheduler_update_from_sweep(sched, r.residual, wid, wt)
    token_topics = wt[wid.long()].long()
    abs_delta = torch.gather(r.residual, -1, token_topics)
    r_new, touched = scheduling.scatter_residuals(abs_delta, wid,
                                                  token_topics, W, K)
    want = scheduling.update_residuals(sched, r_new, touched)
    np.testing.assert_allclose(got.r_wk.numpy(), want.r_wk.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.r_w.numpy(), want.r_w.numpy(), atol=1e-5)
    # and the port's refresh matches the JAX package's
    j = jsched.scheduler_update_from_sweep(
        JSchedulerState(jnp.asarray(s["r_wk"]), jnp.asarray(s["r_wk"].sum(-1))),
        jnp.asarray(r.residual.numpy()), jnp.asarray(s["wid"]),
        jnp.asarray(s["wt"]))
    _close(got.r_wk.numpy(), j.r_wk, "r_wk vs jax")


def test_residuals_from_sweep_match_full_sweep_residuals():
    D, L, K, W = 8, 6, 5, 9
    s = _state(D, L, K, W, seed=12)
    r = ops.sweep(*_args(s), **_kw(W), device="cpu")
    wid = torch.from_numpy(s["wid"])
    emitted = scheduling.residuals_from_sweep(r.residual, wid, W)
    measured = scheduling.full_sweep_residuals(
        r.mu, torch.from_numpy(s["mu"]), torch.from_numpy(s["cnt"]), wid, W)
    np.testing.assert_allclose(emitted.r_wk.numpy(), measured.r_wk.numpy(),
                               atol=1e-6)
    jr = jsched.residuals_from_sweep(jnp.asarray(r.residual.numpy()),
                                     jnp.asarray(s["wid"]), W)
    _close(emitted.r_wk.numpy(), jr.r_wk, "residuals_from_sweep vs jax")


@pytest.mark.parametrize("A", [0, 3])
def test_in_sweep_loglik_matches_training_perplexity(A):
    D, L, K, W = 9, 7, 8, 12
    s = _state(D, L, K, W, seed=13, A=A)
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    r = ops.sweep(*_args(s), **_kw(W), **_sched_kw(s), compute_loglik=True,
                  device="cpu")
    batch = MinibatchData(torch.from_numpy(s["wid"]),
                          torch.from_numpy(s["cnt"]))
    ppl_sweep = float(torch.exp(-r.loglik / batch.counts.sum()))
    ppl_ref = float(em.training_perplexity(batch, r.theta, r.phi_wk,
                                           r.phi_k, cfg))
    np.testing.assert_allclose(ppl_sweep, ppl_ref, rtol=1e-5)


def test_emit_loglik_preserves_sweep_outputs():
    s = _state(8, 6, 5, 7, seed=17)
    a = ops.sweep(*_args(s), **_kw(7), device="cpu")
    b = ops.sweep(*_args(s), **_kw(7), compute_loglik=True, device="cpu")
    for name in ("mu", "theta", "phi_wk", "phi_k", "residual"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_global_vocab_size_reaches_the_sweep():
    """The smoothing mass W·(β−1) takes the *global* W (the trainer's live
    vocabulary), not the W_s rows of the local view."""
    D, L, K, W_s = 6, 5, 4, 8
    s = _state(D, L, K, W_s, seed=1)
    cfg = LDAConfig(num_topics=K, vocab_size=W_s)
    batch = MinibatchData(torch.from_numpy(s["wid"]),
                          torch.from_numpy(s["cnt"]))
    local = LocalState(torch.from_numpy(s["mu"]),
                       torch.from_numpy(s["theta"]))
    phi, ptot = torch.from_numpy(s["phi"]), torch.from_numpy(s["ptot"])
    big = em.gs_sweep_with_residuals(batch, local, phi, ptot, cfg,
                                     vocab_size=5000)
    explicit = ops.sweep(*_args(s), **_kw(5000), device="cpu")
    default = em.gs_sweep_with_residuals(batch, local, phi, ptot, cfg)
    assert torch.equal(big.phi_wk, explicit.phi_wk)
    assert not torch.allclose(big.mu, default.mu)
    want = jops.sweep(*map(jnp.asarray, _args(s)), **_kw(5000),
                      use_pallas=False)
    _close(big.phi_wk.numpy(), want.phi_wk, "phi_wk, global W")


def test_blocked_iem_sweep_delta_contract():
    D, L, K, W = 6, 8, 5, 11
    s = _state(D, L, K, W, seed=2)
    cfg = LDAConfig(num_topics=K, vocab_size=W)
    batch = MinibatchData(torch.from_numpy(s["wid"]),
                          torch.from_numpy(s["cnt"]))
    local = LocalState(torch.from_numpy(s["mu"]),
                       torch.from_numpy(s["theta"]))
    loc, dwk, dk = em.blocked_iem_sweep(batch, local,
                                        torch.from_numpy(s["phi"]),
                                        torch.from_numpy(s["ptot"]), cfg)
    np.testing.assert_allclose(dwk.sum(0).numpy(), dk.numpy(), atol=1e-4)
    np.testing.assert_allclose(loc.theta_dk.sum(-1).numpy(),
                               s["cnt"].sum(1), rtol=1e-5)
    # coarse blocks: the blocked scan, held against the JAX package's
    coarse = em.blocked_iem_sweep(batch, local, torch.from_numpy(s["phi"]),
                                  torch.from_numpy(s["ptot"]),
                                  LDAConfig(num_topics=K, vocab_size=W,
                                            iem_blocks=2))
    want = jem.blocked_iem_sweep(
        JMinibatchData(jnp.asarray(s["wid"]), jnp.asarray(s["cnt"])),
        JLocalState(jnp.asarray(s["mu"]), jnp.asarray(s["theta"])),
        jnp.asarray(s["phi"]), jnp.asarray(s["ptot"]),
        JLDAConfig(num_topics=K, vocab_size=W, iem_blocks=2))
    _close(coarse[0].mu.numpy(), want[0].mu, "mu, 2 blocks")
    _close(coarse[0].theta_dk.numpy(), want[0].theta_dk, "theta, 2 blocks")
    _close(coarse[1].numpy(), want[1], "delta phi_wk, 2 blocks")
    _close(coarse[2].numpy(), want[2], "delta phi_k, 2 blocks")


@pytest.mark.parametrize("frac", [1.0, 0.6])
def test_scheduler_helpers_match_jax(frac):
    """init_scheduler, the λ_w threshold and the eq. 38 renorm."""
    W, K = 9, 6
    jcfg = JLDAConfig(num_topics=K, vocab_size=W)
    j0 = jsched.init_scheduler(W, jcfg)
    p0 = scheduling.init_scheduler(W, LDAConfig(num_topics=K, vocab_size=W))
    np.testing.assert_array_equal(p0.r_wk.numpy(), np.asarray(j0.r_wk))
    np.testing.assert_array_equal(p0.r_w.numpy(), np.asarray(j0.r_w))
    r = np.random.default_rng(4).gamma(1.0, 1.0, (W, K)).astype(np.float32)
    jt = jsched.select_active_words_threshold(
        JSchedulerState(jnp.asarray(r), jnp.asarray(r.sum(-1))), frac)
    pt = scheduling.select_active_words_threshold(
        SchedulerState(torch.from_numpy(r), torch.from_numpy(r.sum(-1))),
        frac)
    assert float(pt) == float(jt)
    a = np.random.default_rng(5).random((3, 4, 5)).astype(np.float32)
    b = np.random.default_rng(6).random((3, 4, 5)).astype(np.float32)
    _close(scheduling.sparse_estep_renorm(torch.from_numpy(a),
                                          torch.from_numpy(b)).numpy(),
           jsched.sparse_estep_renorm(jnp.asarray(a), jnp.asarray(b)),
           "eq. 38 renorm")


def test_from_numpy_carries_jax_scheduler_state():
    """A JAX SchedulerState carried into the port drives the same scheduled
    sweep selection."""
    s = _state(6, 5, 8, 9, seed=21, A=3)
    jstate = JSchedulerState(jnp.asarray(s["r_wk"]),
                             jnp.asarray(s["r_wk"].sum(-1)))
    st = from_numpy(jstate)
    assert isinstance(st, SchedulerState)
    np.testing.assert_array_equal(st.r_wk.numpy(), s["r_wk"])
    np.testing.assert_array_equal(
        scheduling.select_active_topics(st.r_wk, 3).numpy(), s["wt"])


# ---------------------------------------------------------------------------
# eager contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,value", [("word_ids", 9), ("word_ids", -1),
                                        ("word_topics", 8)])
def test_sweep_refuses_out_of_range_indices(name, value):
    s = _state(5, 4, 8, 9, seed=3, A=2)
    key = {"word_ids": "wid", "word_topics": "wt"}[name]
    s[key][2, 1] = value
    with pytest.raises(ops.ContractError, match=name):
        ops.sweep(*_args(s), **_kw(9), **_sched_kw(s), device="cpu")


def test_sweep_refuses_sharded_plans_hooks_and_bad_shapes():
    s = _state(4, 3, 5, 6, seed=0)
    with pytest.raises(ops.ContractError, match="sharded"):
        ops.sweep(*_args(s), **_kw(6), plan=SweepPlan(axis_name="model"),
                  device="cpu")
    with pytest.raises(ops.ContractError, match="hooks"):
        ops.sweep(*_args(s), **_kw(6), norm_psum=lambda x: x, device="cpu",
                  plan=SweepPlan(axis_name=MeshAxis("model", 1, 0)))
    with pytest.raises(ops.ContractError, match="theta"):
        ops.sweep(s["wid"], s["cnt"], s["mu"], s["theta"][:, :3], s["phi"],
                  s["ptot"], **_kw(6), device="cpu")
    with pytest.raises(ops.ContractError, match="float32"):
        ops.sweep(s["wid"], s["cnt"], s["mu"].astype(np.float64),
                  s["theta"], s["phi"], s["ptot"], **_kw(6), device="cpu")


def test_sweep_fires_pre_probe():
    s = _state(4, 3, 5, 6, seed=0)
    plan = FaultPlan([FaultSpec(point=PRE_PROBE, kind="kill")])
    with active_plan(plan), pytest.raises(InjectedFault):
        ops.sweep(*_args(s), **_kw(6), device="cpu")
    assert plan.fired_log()[0][:2] == ("kill", PRE_PROBE)


# ---------------------------------------------------------------------------
# (d) the dense CUDA column loop's host-side plan (csrc/gs_sweep.cu)
# ---------------------------------------------------------------------------

class _Ptr:
    """A stand-in operand with a given base address."""

    def __init__(self, addr):
        self.addr = addr

    def data_ptr(self):
        return self.addr


@pytest.mark.parametrize("K,addr,want", [
    (10_000, 0, ("registers", 0)),
    (10_000, 4, ("registers", 1)),          # unaligned μ: scalar lanes
    (10_001, 0, ("registers", 1)),          # K % 4 != 0
    (REG_MAX_K, 0, ("registers", 0)),
    (REG_MAX_K + 4, 0, ("two-pass", 2)),
    (50_000, 16, ("two-pass", 2)),
    (50_001, 0, ("two-pass", 3)),
])
def test_dense_path_by_width_and_alignment(K, addr, want):
    assert tuple(dense_path(K, [_Ptr(addr)])) == want


@pytest.mark.parametrize("D", [1, GROUP_DOCS - 1, GROUP_DOCS, 1024, 1025])
def test_doc_groups_cover_the_documents_in_fixed_groups(D):
    g = doc_groups(D)
    assert (g - 1) * GROUP_DOCS < D <= g * GROUP_DOCS


def _plan_oracle(wid, cnt):
    """Per token: 0 dead, SOLO when live and alone with its word in its
    column (dead tokens counted), else SHARED."""
    D, L = wid.shape
    out = np.zeros((D, L), np.uint8)
    for l in range(L):
        col = list(wid[:, l])
        for d in range(D):
            if cnt[d, l] != 0:
                out[d, l] = SOLO if col.count(wid[d, l]) == 1 else SHARED
    return out


@pytest.mark.parametrize("D,L,W,seed", [(7, 5, 4, 0), (30, 6, 40, 1),
                                        (64, 3, 200, 2), (1, 4, 3, 3)])
def test_column_plan_flags_and_segments(D, L, W, seed):
    """SOLO tokens are the live ones whose word no other token of the
    column has (a dead one included: it reads the row in the E-step); the
    fold's segments hold every SHARED token once, by word, in document
    order."""
    s = _state(D, L, 3, W, seed=seed)
    wid, cnt = s["wid"], s["cnt"]
    cnt[0, 0] = 0.0             # a dead token beside live ones of its word
    flags, (order, pos, end, word, count) = column_plan(
        torch.from_numpy(wid), torch.from_numpy(cnt), W)
    np.testing.assert_array_equal(flags.numpy(), _plan_oracle(wid, cnt))
    for l in range(L):
        seen = []
        for sg in range(int(count[l])):
            docs = order[l, int(pos[l, sg]):int(end[l, sg])].tolist()
            assert docs == sorted(docs)
            assert {int(wid[d, l]) for d in docs} == {int(word[l, sg])}
            seen += docs
        shared = np.flatnonzero(flags[:, l].numpy() == SHARED).tolist()
        assert sorted(seen) == shared
        if count[l] < D:
            assert int(pos[l, int(count[l])]) == -1


def _walk_dense_loop(wid, cnt, mu, theta, phi, ptot, *, alpha_m1, beta_m1,
                     wb):
    """The kernel's column loop in Python, in its plan: per column the
    Jacobi E-step; θ̂ += Δ of the live tokens; a SOLO token's Δ into its row
    at once; Σ_d Δ over each GROUP_DOCS group in document order; then
    φ̂(k) += the group sums in group order and each shared segment's Δ into
    its row in document order."""
    D, L = wid.shape
    flags, (order, pos, end, word, count) = column_plan(wid, cnt,
                                                        phi.shape[0])
    theta, phi, ptot = theta.clone(), phi.clone(), ptot.clone()
    mu_out = torch.empty_like(mu)
    idx = wid.long()
    for l in range(L):
        c = cnt[:, l, None]
        ex = c * mu[:, l]
        num = ((theta - ex).clamp_min(0) + alpha_m1) * (
            (phi[idx[:, l]] - ex).clamp_min(0) + beta_m1) / (ptot - ex + wb)
        new = num / num.sum(-1, keepdim=True).clamp_min(1e-30)
        dl = c * new - ex
        mu_out[:, l] = new
        live = flags[:, l] != 0
        theta[live] = theta[live] + dl[live]
        for d in torch.nonzero(flags[:, l] == SOLO).flatten().tolist():
            phi[idx[d, l]] = phi[idx[d, l]] + dl[d]
        groups = [dl[g * GROUP_DOCS:(g + 1) * GROUP_DOCS].sum(0)
                  for g in range(doc_groups(D))]
        ptot = ptot + torch.stack(groups).sum(0)
        for sg in range(int(count[l])):
            row = int(word[l, sg])
            for q in range(int(pos[l, sg]), int(end[l, sg])):
                phi[row] = phi[row] + dl[int(order[l, q])]
    return mu_out, theta, phi, ptot


@pytest.mark.parametrize("D,L,K,W,seed", [(9, 7, 6, 4, 0), (21, 5, 11, 9, 1),
                                          (40, 4, 8, 30, 2)])
def test_dense_loop_walk_in_its_plan_matches_plain(D, L, K, W, seed):
    """Folding rows in the E-step (SOLO) or by segment (SHARED) and φ̂(k)
    by document groups gives the plain sweep's statistics: every live Δ
    lands once in its row, θ̂ and φ̂(k)."""
    s = _state(D, L, K, W, seed=seed)
    t = [torch.from_numpy(x) for x in _args(s)]
    got = _walk_dense_loop(*t, **_kw(W))
    want = gs_sweep_reference(*t, **_kw(W))
    for name, a, b in zip(("mu", "theta", "phi_wk", "phi_k"), got,
                          (want[0], want[2], want[3], want[4])):
        _close(a.numpy(), b.numpy(), name)


def test_stop_rule_partials_sum_to_sweep_loglik():
    """The stop rule's per-token partials (the kernel's output; on the CPU
    its plain version) sum, column by column, to sweep_loglik, and a
    zero-count token gives 0."""
    D, L, K, W = 11, 6, 9, 7
    s = _state(D, L, K, W, seed=21)
    wid, cnt, _, theta, phi, ptot = [torch.from_numpy(x) for x in _args(s)]
    tok = sweep_loglik_partials(wid, cnt, theta, phi, ptot, **_kw(W))
    assert torch.equal(tok, token_loglik(wid, cnt, theta, phi, ptot,
                                         W * 0.01, alpha_m1=0.01,
                                         beta_m1=0.01))
    assert bool((tok[cnt == 0] == 0).all())
    _close(float(tok.sum()), float(sweep_loglik(
        wid, cnt, theta, phi, ptot, W * 0.01, alpha_m1=0.01, beta_m1=0.01)),
        "loglik", rtol=1e-6, atol=0.0)
