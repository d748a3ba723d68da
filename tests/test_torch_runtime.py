"""The port's fault-tolerant runtime vs the JAX package, on the CPU: the
cases of ``tests/test_fault_tolerance.py`` run on ``repro_torch``, plus the
cross-package cases.

* Seeded fault plans (the same specs from the same seed in both packages),
  ``ops.sweep`` firing the active plan.
* The trainer's restart, drop and kill cases, ``FOEMTrainer(device="cpu")``.
* Checkpoints: the atomic round trip, gc, the recovery scan, kills at both
  injected points; the leaf order equals ``jax.tree.flatten``'s; a
  checkpoint written by either package restores in the other, leaf for
  leaf bitwise; the chunked crc equals the whole-file crc.
* ``StragglerMonitor`` and ``BoundedStalenessMerger``: the JAX file's unit
  cases, and one seeded op sequence driven through both packages' objects
  gives identical outputs step for step.
* ``ElasticFOEMRuntime``: drop re-issue, bounded retry, kill → checkpoint →
  shrink → resume (and the same through a fresh runtime restored from the
  checkpoint), the delay fault's straggler; against the JAX runtime with
  its μ₀ injected through ``mu0_fn`` (the JAX runtime's
  ``jax.random.split`` chain and ``uniform_responsibilities`` repeated
  here): φ̂ and φ̂(k) within rtol 1e-4, the tolerance of
  ``tests/test_torch_training.py`` (float32 sums over K and a column's
  documents taken in another order, carried through up to 8 sweeps).
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.core.types import GlobalStats as JGlobalStats
from repro.core.types import LDAConfig as JLDAConfig
from repro.core.types import uniform_responsibilities as j_uniform
from repro.runtime import BoundedStalenessMerger as JMerger
from repro.runtime import FaultPlan as JFaultPlan
from repro.runtime import StragglerMonitor as JMonitor
from repro.runtime.elastic import ElasticFOEMRuntime as JRuntime
from repro.sparse import MinibatchStream as JStream
from repro_torch.checkpoint import (
    PartitionSpec,
    latest_step,
    reshard,
    restore_checkpoint,
    save_checkpoint,
    scan_checkpoints,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.checkpoint.ckpt import file_crc32
from repro_torch.core import FOEMTrainer, GlobalStats, LDAConfig, ParameterStore
from repro_torch.core import em
from repro_torch.core.foem_sharded import shard_stats
from repro_torch.data import synthetic_lda_corpus
from repro_torch.launch.mesh import Mesh, MeshAxis
from repro_torch.runtime import (
    BoundedStalenessMerger,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    StragglerMonitor,
    faults,
)
from repro_torch.runtime.elastic import ElasticFOEMRuntime
from repro_torch.sparse import MinibatchStream

RTOL = 1e-4
K, W = 6, 240


@pytest.fixture(scope="module")
def corpus():
    c, _ = synthetic_lda_corpus(96, W, K, mean_doc_len=50, seed=7)
    return c


def _cfg(**kw):
    return LDAConfig(num_topics=K, vocab_size=W, max_sweeps=8, **kw)


def _runtime(**kw):
    return ElasticFOEMRuntime(_cfg(), num_shards=2, seed=0, device="cpu",
                              **kw)


def _stream(corpus, epochs=1):
    return MinibatchStream(corpus, 24, seed=0, epochs=epochs)


# ---------------------------------------------------------------------------
# Seeded fault plans
# ---------------------------------------------------------------------------

def test_fault_plan_deterministic_from_seed():
    a = FaultPlan.from_seed(42, num_faults=6, max_step=10, num_shards=4)
    b = FaultPlan.from_seed(42, num_faults=6, max_step=10, num_shards=4)
    assert a.specs == b.specs
    assert FaultPlan.from_seed(43, num_faults=6, max_step=10,
                               num_shards=4).specs != a.specs
    # the plan IS its seed in both packages
    j = JFaultPlan.from_seed(42, num_faults=6, max_step=10, num_shards=4)
    assert [dataclasses.astuple(s) for s in a.specs] == \
        [dataclasses.astuple(s) for s in j.specs]


def test_fault_plan_fire_semantics():
    naps = []
    plan = FaultPlan(
        [
            FaultSpec(point=faults.PRE_PROBE, kind="drop", step=2),
            FaultSpec(point=faults.PRE_PROBE, kind="delay",
                      step=faults.ANY_STEP, seconds=0.5),
            FaultSpec(point=faults.POST_FOLD, kind="kill", step=3, shard=1),
        ],
        sleep=naps.append,
    )
    assert not plan.fire(faults.PRE_PROBE, step=0)      # delay only
    assert plan.fire(faults.PRE_PROBE, step=2)          # drop fires
    assert not plan.fire(faults.PRE_PROBE, step=2)      # one-shot: consumed
    assert naps == [0.5, 0.5, 0.5]                      # ANY_STEP persists
    assert not plan.fire(faults.POST_FOLD, step=3, shard=0)   # wrong shard
    with pytest.raises(InjectedFault) as ei:
        plan.fire(faults.POST_FOLD, step=3, shard=1)
    assert ei.value.shard == 1 and ei.value.step == 3
    kinds = [k for k, *_ in plan.fired_log()]
    assert kinds == ["delay", "drop", "delay", "delay", "kill"]
    plan.reset()
    assert plan.fired_log() == [] and plan.fire(faults.PRE_PROBE, step=2)


def test_fault_plan_validates_points_and_kinds():
    with pytest.raises(ValueError):
        FaultSpec(point="mid-sweep", kind="kill")
    with pytest.raises(ValueError):
        FaultSpec(point=faults.PRE_PROBE, kind="explode")
    with pytest.raises(ValueError):
        FaultSpec(point=faults.PRE_PROBE, kind="delay", seconds=0.0)
    with pytest.raises(ValueError):
        FaultPlan().fire("nonsense")


def test_ops_sweep_fires_active_plan_eagerly():
    from repro_torch.kernels import ops as kops

    cfg = _cfg()
    rng = np.random.default_rng(0)
    D, L = 4, 8
    wid = torch.from_numpy(rng.integers(0, W, (D, L)).astype(np.int32))
    cnt = torch.from_numpy(rng.integers(0, 5, (D, L)).astype(np.float32))
    mu = torch.from_numpy(
        rng.dirichlet(np.ones(K), (D, L)).astype(np.float32))
    theta = em.fold_theta(mu, cnt)
    phi, ptot = em.fold_phi(mu, cnt, wid, W)
    kw = dict(alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1,
              wb=cfg.W * cfg.beta_m1, device="cpu")
    plan = FaultPlan([FaultSpec(point=faults.PRE_PROBE, kind="kill")])
    with faults.active_plan(plan):
        with pytest.raises(InjectedFault):
            kops.sweep(wid, cnt, mu, theta, phi, ptot, **kw)
    kops.sweep(wid, cnt, mu, theta, phi, ptot, **kw)   # no plan: clean


# ---------------------------------------------------------------------------
# Trainer: restart + injected faults
# ---------------------------------------------------------------------------

def _store(path):
    return ParameterStore(str(path), num_topics=K, vocab_capacity=W,
                          buffer_rows=32)


def test_trainer_restart_resumes_cursor(tmp_path, corpus):
    cfg = _cfg(active_topics=3)
    store = _store(tmp_path)
    tr = FOEMTrainer(cfg, store, checkpoint_every=1, device="cpu")
    tr.fit_stream(iter(MinibatchStream(corpus, 32, seed=0, epochs=2)),
                  max_steps=3)
    mass = float(store.phi_k.sum())
    del tr, store                                  # crash
    store2 = _store(tmp_path)
    tr2 = FOEMTrainer(cfg, store2, checkpoint_every=1, device="cpu")
    assert tr2.resume_step() == 3
    assert float(store2.phi_k.sum()) == pytest.approx(mass, rel=1e-6)
    tr2.fit_stream(iter(MinibatchStream(corpus, 32, seed=99, epochs=2)),
                   max_steps=2)
    assert store2.step == 5


def test_trainer_drop_fault_skips_writeback(tmp_path, corpus):
    plan = FaultPlan([FaultSpec(point=faults.POST_FOLD, kind="drop", step=1)])
    store = _store(tmp_path)
    tr = FOEMTrainer(_cfg(), store, faults=plan, prefetch_depth=0,
                     device="cpu")
    ms = tr.fit_stream(iter(MinibatchStream(corpus, 32, seed=0, epochs=1)),
                       max_steps=3)
    assert tr.dropped_steps == [2]                 # step index post-advance
    dropped = ms[1]
    assert dropped.sweeps == 0 and np.isnan(dropped.train_ppl)
    assert plan.fired_log() == [("drop", faults.POST_FOLD, None, 1)]
    assert ms[0].sweeps > 0 and ms[2].sweeps > 0


def test_trainer_kill_fault_raises_and_resumes(tmp_path, corpus):
    plan = FaultPlan([FaultSpec(point=faults.PRE_PROBE, kind="kill", step=2)])
    store = _store(tmp_path)
    tr = FOEMTrainer(_cfg(), store, faults=plan, checkpoint_every=1,
                     prefetch_depth=0, device="cpu")
    stream = iter(MinibatchStream(corpus, 32, seed=0, epochs=2))
    with pytest.raises(InjectedFault):
        tr.fit_stream(stream, max_steps=5)
    assert store.step == 2                         # two clean steps landed
    assert _store(tmp_path).step == 2              # reopens at the cursor


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_atomic_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor(4, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 3, tree)
    save_checkpoint(str(tmp_path), 7, {"a": tree["a"] + 1, "b": tree["b"]})
    assert latest_step(str(tmp_path)) == 7
    step, out = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    np.testing.assert_allclose(out["a"], np.arange(6.0).reshape(2, 3) + 1)
    step3, out3 = restore_checkpoint(str(tmp_path), tree, step=3)
    assert step3 == 3 and out3["b"]["c"].dtype == np.int32
    np.testing.assert_allclose(out3["a"], np.arange(6.0).reshape(2, 3))


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in range(6):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(dirs) == 2 and "step_00000005" in dirs


def test_checkpoint_scan_repairs_torn_state(tmp_path):
    tree = {"x": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    with open(tmp_path / "step_00000002" / "0.npy", "r+b") as f:
        f.truncate(8)
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert scan_checkpoints(str(tmp_path)) == [1]
    assert latest_step(str(tmp_path)) == 1          # pointer repaired
    assert not os.path.exists(tmp_path / "step_00000003.tmp")
    step, out = restore_checkpoint(str(tmp_path), tree)
    assert step == 1
    np.testing.assert_allclose(out["x"], np.arange(4.0))


def test_checkpoint_kill_mid_save_never_torn(tmp_path):
    tree = {"x": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, tree)
    for point in (faults.MID_FLUSH, faults.PRE_PUBLISH):
        plan = FaultPlan([FaultSpec(point=point, kind="kill")])
        with pytest.raises(InjectedFault):
            save_checkpoint(str(tmp_path), 2, {"x": tree["x"] + 1},
                            faults=plan)
        valid = scan_checkpoints(str(tmp_path))
        step, out = restore_checkpoint(str(tmp_path), tree)
        assert step == valid[-1]
        np.testing.assert_allclose(np.asarray(out["x"]),
                                   np.arange(4.0) + (step - 1))


def test_checkpoint_restore_refuses_other_leaf_count(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"x": 0, "y": 0})


def _mixed_trees():
    """The same tree in both packages: nested dicts (keys out of order),
    lists, tuples with None, a named tuple, int32 / float32 / int64 leaves."""
    rng = np.random.default_rng(3)
    phi = rng.random((5, 4)).astype(np.float32)
    ptot = rng.random(4).astype(np.float32)
    ids = rng.integers(0, 9, 7).astype(np.int64)
    j = {"stats": JGlobalStats(jnp.asarray(phi), jnp.asarray(ptot),
                               jnp.int32(3)),
         "cursor": jnp.int32(9), "extra": [np.asarray(ids), (None, 2.5)],
         "b": {"z": jnp.float32(1.0), "a": jnp.arange(3, dtype=jnp.int32)}}
    t = {"stats": GlobalStats(torch.from_numpy(phi), torch.from_numpy(ptot),
                              torch.tensor(3, dtype=torch.int32)),
         "cursor": torch.tensor(9, dtype=torch.int32),
         "extra": [torch.from_numpy(ids), (None, 2.5)],
         "b": {"z": torch.tensor(1.0), "a": torch.arange(3,
                                                         dtype=torch.int32)}}
    return j, t


def test_tree_flatten_follows_jax_leaf_order():
    j, t = _mixed_trees()
    jl, _ = jax.tree.flatten(j)
    tl, _ = tree_flatten(t)
    assert len(jl) == len(tl) == 8
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tree_unflatten(t, list(range(8)))
    assert back["b"] == {"a": 0, "z": 1} and back["cursor"] == 2
    assert back["extra"] == [3, (None, 4)]
    assert back["stats"] == GlobalStats(5, 6, 7)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_package_bitwise(tmp_path, writer):
    """Written by one package, restored by the other: every leaf equal
    bitwise, with its dtype, and the manifests' crcs equal."""
    j, t = _mixed_trees()
    (j_save if writer == "jax" else save_checkpoint)(
        str(tmp_path / writer), 4, j if writer == "jax" else t)
    other = tmp_path / "other"
    (save_checkpoint if writer == "jax" else j_save)(
        str(other), 4, t if writer == "jax" else j)
    if writer == "jax":
        step, out = restore_checkpoint(str(tmp_path / writer), t)
        leaves = tree_flatten(out)[0]
    else:
        step, out = j_restore(str(tmp_path / writer), j)
        leaves = jax.tree.leaves(out)
    assert step == 4
    for got, want in zip(leaves, jax.tree.leaves(j)):
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for i in range(8):
        a = (tmp_path / writer / "step_00000004" / f"{i}.npy").read_bytes()
        b = (other / "step_00000004" / f"{i}.npy").read_bytes()
        assert a == b, f"leaf {i}: the .npy files differ"


def test_chunked_crc_equals_whole_file_crc(tmp_path, monkeypatch):
    from repro_torch.checkpoint import ckpt

    monkeypatch.setattr(ckpt, "_CRC_CHUNK", 1000)  # many chunks
    arr = np.random.default_rng(0).random((300, 7)).astype(np.float32)
    p = str(tmp_path / "a.npy")
    crc = ckpt._save_npy_synced(p, arr)
    with open(p, "rb") as f:
        assert crc == zlib.crc32(f.read()) == file_crc32(p)


def _mesh(data, model, d, m):
    return Mesh(MeshAxis("data", data, d), MeshAxis("model", model, m),
                torch.device("cpu"))


def test_reshard_takes_the_shard_stats_lanes():
    """``reshard`` of a (None, "model") spec gives each rank the lanes
    ``shard_stats`` gives it; a "data" split of the rows and a whole leaf
    too; a dimension that does not split raises."""
    rng = np.random.default_rng(1)
    full = GlobalStats(torch.from_numpy(rng.random((6, 8)).astype(np.float32)),
                       torch.from_numpy(rng.random(8).astype(np.float32)),
                       torch.tensor(2, dtype=torch.int32))
    spec = GlobalStats(PartitionSpec(None, "model"), PartitionSpec("model"),
                       PartitionSpec())
    for m in range(2):
        got = reshard(full, spec, _mesh(2, 2, 1, m))
        want = shard_stats(full, 2, m)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    rows = reshard({"x": full.phi_wk}, {"x": PartitionSpec("data", "model")},
                   _mesh(3, 2, 2, 1))["x"]
    assert torch.equal(rows, full.phi_wk[4:6, 4:8])
    with pytest.raises(ValueError, match="split"):
        reshard({"x": full.phi_k}, {"x": PartitionSpec("model")},
                _mesh(1, 3, 0, 0))


# ---------------------------------------------------------------------------
# Straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_slow_shard():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=2)
    for _ in range(4):
        for shard in range(8):
            mon.record(shard, 1.0 if shard != 5 else 4.0)
    assert mon.stragglers() == [5]
    assert mon.should_reissue(5) and not mon.should_reissue(2)


def test_straggler_monitor_single_shard_never_straggles():
    mon = StragglerMonitor(threshold=1.1, warmup_steps=1)
    for _ in range(10):
        mon.record(0, 5.0)
    assert mon.stragglers() == []


def test_straggler_monitor_floor_suppresses_jitter():
    mon = StragglerMonitor(threshold=1.5, warmup_steps=1, floor_seconds=0.05)
    for _ in range(5):
        mon.record(0, 0.001)
        mon.record(1, 0.004)
    assert mon.stragglers() == []
    mon2 = StragglerMonitor(threshold=1.5, warmup_steps=1, floor_seconds=0.05)
    for _ in range(5):
        mon2.record(0, 1.0)
        mon2.record(1, 4.0)
    assert mon2.stragglers() == [1]


def test_straggler_monitor_rejects_degenerate_threshold():
    with pytest.raises(ValueError):
        StragglerMonitor(threshold=1.0)


def test_straggler_monitor_forget():
    mon = StragglerMonitor(threshold=1.5, warmup_steps=1, floor_seconds=0.0)
    for _ in range(3):
        mon.record(0, 1.0)
        mon.record(1, 9.0)
    assert mon.stragglers() == [1]
    mon.forget(1)
    assert mon.stragglers() == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_matches_jax_step_for_step(seed):
    """One seeded sequence of records and forgets through both packages'
    monitors: EWMAs, medians and straggler lists identical at every step."""
    rng = np.random.default_rng(seed)
    kw = dict(threshold=1.5, warmup_steps=2, floor_seconds=0.02)
    ours, theirs = StragglerMonitor(**kw), JMonitor(**kw)
    for _ in range(200):
        shard = int(rng.integers(0, 6))
        if rng.random() < 0.05:
            ours.forget(shard)
            theirs.forget(shard)
        else:
            dt = float(rng.gamma(2.0, 0.05)) * (4.0 if shard == 3 else 1.0)
            ours.record(shard, dt)
            theirs.record(shard, dt)
        assert ours.median_latency() == theirs.median_latency()
        assert ours.stragglers() == theirs.stragglers()
        assert {k: (s.ewma, s.n) for k, s in ours.stats.items()} == \
            {k: (s.ewma, s.n) for k, s in theirs.stats.items()}


# ---------------------------------------------------------------------------
# Bounded-staleness merger
# ---------------------------------------------------------------------------

def test_bounded_staleness_merge_order_invariance_bitwise():
    """Release order is canonical (round, then shard) regardless of arrival
    interleaving, so the float32 eq. 33 fold is BITWISE identical."""
    rng = np.random.default_rng(0)
    Wd, Kd = 7, 3
    ids = [np.sort(rng.choice(Wd, 4, replace=False)) for _ in range(6)]
    deltas = [
        (torch.from_numpy(i),
         torch.from_numpy(rng.random((4, Kd)).astype(np.float32)),
         torch.from_numpy(rng.random(Kd).astype(np.float32)))
        for i in ids
    ]

    def fold_all(arrivals):
        m = BoundedStalenessMerger(max_staleness=1, expected_shards=3)
        phi = torch.zeros((Wd, Kd))
        ptot = torch.zeros(Kd)
        for rnd in range(3):
            for shard, r, d in arrivals[rnd]:
                m.submit(shard, r, d)
            for _, _, (i, dr, dk) in m.drain(rnd):
                phi, _ = em.fold_phi_delta(phi, ptot, i, dr)
                ptot = ptot + dk
        for _, _, (i, dr, dk) in m.flush():
            phi, _ = em.fold_phi_delta(phi, ptot, i, dr)
            ptot = ptot + dk
        return phi.numpy(), ptot.numpy()

    A = {0: [(0, 0, deltas[0]), (1, 0, deltas[1]), (2, 0, deltas[2])],
         1: [(0, 1, deltas[3]), (1, 1, deltas[4]), (2, 1, deltas[5])],
         2: []}
    B = {0: [(2, 0, deltas[2]), (0, 0, deltas[0])],
         1: [(1, 0, deltas[1]), (2, 1, deltas[5]), (0, 1, deltas[3])],
         2: [(1, 1, deltas[4])]}
    phi_a, ptot_a = fold_all(A)
    phi_b, ptot_b = fold_all(B)
    np.testing.assert_array_equal(phi_a, phi_b)     # bitwise
    np.testing.assert_array_equal(ptot_a, ptot_b)


def test_bounded_staleness_preserves_shard_attribution():
    m = BoundedStalenessMerger(max_staleness=0, expected_shards=2)
    m.submit(1, 0, "b")
    m.submit(0, 0, "a")
    assert m.drain(0) == [(0, 0, "a"), (1, 0, "b")]


def test_bounded_staleness_holds_within_bound():
    m = BoundedStalenessMerger(max_staleness=2, expected_shards=3)
    m.submit(0, 0, "a")
    assert m.drain(0) == [] and m.drain(1) == []
    assert m.drain(2) == [(0, 0, "a")]
    assert m.num_pending == 0


def test_bounded_staleness_drops_late_submit_and_reissues():
    m = BoundedStalenessMerger(max_staleness=0, expected_shards=2)
    m.submit(0, 0, "a")
    m.submit(1, 0, "b")
    assert len(m.drain(0)) == 2
    assert not m.submit(1, 0, "late")
    assert m.dropped == [(1, 0)]
    assert list(m.reissue()) == [(1, 0)]
    assert list(m.reissue()) == []
    m.submit(0, 1, "c")
    assert not m.submit(1, 0, "later still")
    assert list(m.reissue()) == [(1, 0)]


def test_bounded_staleness_strict_round_order():
    m = BoundedStalenessMerger(max_staleness=1, expected_shards=2)
    m.submit(0, 1, "r1-a")
    m.submit(1, 1, "r1-b")
    assert m.drain(0) == []
    m.submit(0, 0, "r0-a")
    m.submit(1, 0, "r0-b")
    assert [r for _, r, _ in m.drain(1)] == [0, 0, 1, 1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merger_matches_jax_step_for_step(seed):
    """One seeded sequence of submits (late ones included), drains,
    reissues and flushes through both packages' mergers: every return value
    and the pending/dropped state identical at every step."""
    rng = np.random.default_rng(seed)
    kw = dict(max_staleness=int(rng.integers(0, 3)), expected_shards=3)
    ours, theirs = BoundedStalenessMerger(**kw), JMerger(**kw)
    now = 0
    for i in range(120):
        op = rng.random()
        if op < 0.6:
            shard, rnd = int(rng.integers(0, 3)), now - int(rng.integers(0, 3))
            assert ours.submit(shard, rnd, i) == theirs.submit(shard, rnd, i)
        elif op < 0.85:
            now += int(rng.integers(0, 2))
            assert ours.drain(now) == theirs.drain(now)
        elif op < 0.97:
            assert list(ours.reissue()) == list(theirs.reissue())
        else:
            assert ours.flush() == theirs.flush()
        assert ours.pending == theirs.pending
        assert ours.dropped == theirs.dropped
        assert ours.num_pending == theirs.num_pending


# ---------------------------------------------------------------------------
# Elastic runtime
# ---------------------------------------------------------------------------

def _tokens(corpus):
    return sum(float(mb.counts.sum()) for mb in _stream(corpus))


def test_elastic_runtime_drop_reissue_matches_clean_run(corpus):
    clean = _runtime()
    clean.run(_stream(corpus))
    plan = FaultPlan([FaultSpec(point=faults.POST_FOLD, kind="drop",
                                step=0, shard=1)])
    faulty = _runtime(faults=plan)
    reports = faulty.run(_stream(corpus))
    assert plan.fired_log() == [("drop", faults.POST_FOLD, 1, 0)]
    assert reports[0].requeued == 1
    assert faulty.lost == []
    assert float(faulty.phi_k.sum()) == pytest.approx(
        float(clean.phi_k.sum()), rel=1e-5)
    assert float(clean.phi_k.sum()) == pytest.approx(_tokens(corpus),
                                                     rel=1e-5)
    # the float64 φ̂(k) is the rows' change, summed in float64
    assert float(clean.phi_k.sum()) == pytest.approx(
        float(clean.phi_wk.sum(dtype=torch.float64)), abs=1e-3)


def test_elastic_runtime_bounded_retry_gives_up(corpus):
    plan = FaultPlan([FaultSpec(point=faults.PRE_PROBE, kind="drop")])
    rt = _runtime(faults=plan, max_retries=1)
    rt.run(_stream(corpus), max_rounds=6)
    assert sorted(rt.lost) == [1, 2, 3, 4]
    assert all(k == "drop" for k, *_ in plan.fired_log())
    assert float(rt.phi_k.sum()) == 0.0


def test_elastic_runtime_kill_shrink_resume(corpus, tmp_path):
    plan = FaultPlan([FaultSpec(point=faults.PRE_PROBE, kind="kill",
                                step=1, shard=1)])
    rt = _runtime(faults=plan)
    stream = iter(_stream(corpus))
    with pytest.raises(InjectedFault) as ei:
        rt.run(stream)
    assert ei.value.shard == 1
    save_checkpoint(str(tmp_path), rt.round, rt.checkpoint_tree())
    rt.remove_shard(1)
    assert rt.num_shards == 1 and rt.merger.expected_shards == 1
    rt.run(stream)
    assert rt.cursor == 4 and rt.lost == []
    clean = _runtime()
    clean.run(_stream(corpus))
    assert float(rt.phi_k.sum()) == pytest.approx(
        float(clean.phi_k.sum()), rel=1e-5)

    # the same from the checkpoint alone, as after a crash: a fresh
    # runtime restores it (through the recovery scan) and replays the
    # stream from its start, taking back the killed round's minibatches
    fresh = ElasticFOEMRuntime(_cfg(), num_shards=1, seed=0, device="cpu")
    step, tree = restore_checkpoint(str(tmp_path), fresh.checkpoint_tree())
    assert step == 1
    assert tree["retry"].tolist() == [[3, 1], [4, 1]]
    fresh.load_checkpoint_tree(tree)
    assert fresh.round == 1 and fresh.cursor == 4
    reports = fresh.run(_stream(corpus))
    assert [r.shards_run for r in reports] == [[0], [0]]
    assert fresh.cursor == 4 and fresh.lost == []
    assert float(fresh.phi_k.sum()) == pytest.approx(_tokens(corpus),
                                                     rel=1e-5)


def test_elastic_checkpoint_resume_needs_the_replayed_stream(corpus,
                                                             tmp_path):
    """A restored checkpoint that owes minibatches refuses a stream that
    does not replay them, instead of resuming without them; the lost
    minibatches survive the round trip."""
    plan = FaultPlan([FaultSpec(point=faults.PRE_PROBE, kind="kill",
                                step=1, shard=1)])
    rt = _runtime(faults=plan)
    with pytest.raises(InjectedFault):
        rt.run(_stream(corpus))
    rt.lost.append(9)
    save_checkpoint(str(tmp_path), rt.round, rt.checkpoint_tree())
    fresh = _runtime()
    fresh.load_checkpoint_tree(
        restore_checkpoint(str(tmp_path), fresh.checkpoint_tree())[1])
    assert fresh.lost == [9]
    with pytest.raises(ValueError, match=r"owes minibatches \[3, 4\]"):
        fresh.run(list(_stream(corpus))[4:])


def test_elastic_runtime_delay_fault_flags_straggler(corpus):
    naps = []
    plan = FaultPlan(
        [FaultSpec(point=faults.PRE_PROBE, kind="delay", shard=1,
                   seconds=0.2)],
        sleep=naps.append,
    )

    def clock():
        return sum(naps) + 0.01 * len(naps)

    mon = StragglerMonitor(threshold=1.5, warmup_steps=1, floor_seconds=0.0)
    rt = ElasticFOEMRuntime(_cfg(), num_shards=2, seed=0, faults=plan,
                            monitor=mon, clock=clock, device="cpu")
    rt.run(_stream(corpus))
    assert naps == [0.2, 0.2]
    assert mon.stats[1].ewma > mon.stats[0].ewma


def _jax_mu0_fn(seed):
    """The JAX runtime's μ₀ draws, in its order: ``key, sub =
    split(key)`` once per inner loop, ``uniform_responsibilities(sub,
    (D, L, K))``."""
    state = {"key": jax.random.PRNGKey(seed)}

    def mu0(mb):
        state["key"], sub = jax.random.split(state["key"])
        shape = tuple(mb.local_word_ids.shape) + (K,)
        return np.array(j_uniform(sub, shape))

    return mu0


@pytest.mark.parametrize("drop", [False, True])
def test_elastic_runtime_matches_jax_with_its_mu0(corpus, drop):
    """The port's runtime with the JAX runtime's μ₀ injected ends where the
    JAX runtime ends: φ̂ and φ̂(k) within rtol 1e-4, the same reports."""
    from repro.data import synthetic_lda_corpus as j_corpus

    jc, _ = j_corpus(96, W, K, mean_doc_len=50, seed=7)
    jcfg = JLDAConfig(num_topics=K, vocab_size=W, max_sweeps=8)

    def plans(cls, spec_cls):
        if not drop:
            return None
        return cls([spec_cls(point=faults.POST_FOLD, kind="drop", step=0,
                             shard=1)])

    from repro.runtime import FaultSpec as JFaultSpec

    theirs = JRuntime(jcfg, num_shards=2, seed=0,
                      faults=plans(JFaultPlan, JFaultSpec))
    j_reports = theirs.run(JStream(jc, 24, seed=0, epochs=1))
    ours = _runtime(faults=plans(FaultPlan, FaultSpec),
                    mu0_fn=_jax_mu0_fn(0))
    reports = ours.run(_stream(corpus))
    assert [(r.round_idx, r.shards_run, r.folded, r.requeued, r.lost)
            for r in reports] == \
        [(r.round_idx, r.shards_run, r.folded, r.requeued, r.lost)
         for r in j_reports]
    for a, b in zip(reports, j_reports):
        assert a.train_ppl == pytest.approx(b.train_ppl, rel=RTOL)
    want = np.asarray(theirs.phi_wk)
    np.testing.assert_allclose(ours.phi_wk.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))
    np.testing.assert_allclose(ours.phi_k.numpy(), np.asarray(theirs.phi_k),
                               rtol=RTOL)
    assert (ours.round, ours.cursor, ours.lost) == \
        (theirs.round, theirs.cursor, theirs.lost)


def test_elastic_runtime_checkpoint_tree_crosses_packages(corpus, tmp_path):
    """The JAX runtime's checkpoint tree restores into the port's runtime
    (and back) bitwise: φ̂, round, cursor; φ̂(k) equal after its float64
    round trip.  The port's tree adds the ``retry`` and ``lost`` leaves,
    so each side restores the other's through a ``like`` of its leaves."""
    from repro.data import synthetic_lda_corpus as j_corpus

    jc, _ = j_corpus(96, W, K, mean_doc_len=50, seed=7)
    theirs = JRuntime(JLDAConfig(num_topics=K, vocab_size=W, max_sweeps=8),
                      num_shards=2, seed=0)
    theirs.run(JStream(jc, 24, seed=0, epochs=1), max_rounds=1)
    j_save(str(tmp_path / "j"), theirs.round, theirs.checkpoint_tree())
    ours = _runtime()
    like = {k: v for k, v in ours.checkpoint_tree().items()
            if k in ("phi_wk", "phi_k", "round", "cursor")}
    step, tree = restore_checkpoint(str(tmp_path / "j"), like)
    ours.load_checkpoint_tree(tree)
    assert step == 1 and (ours.round, ours.cursor) == (1, 2)
    np.testing.assert_array_equal(ours.phi_wk.numpy(),
                                  np.asarray(theirs.phi_wk))
    np.testing.assert_array_equal(ours.phi_k.numpy().astype(np.float32),
                                  np.asarray(theirs.phi_k))
    save_checkpoint(str(tmp_path / "t"), ours.round, ours.checkpoint_tree())
    back = JRuntime(JLDAConfig(num_topics=K, vocab_size=W), num_shards=2)
    _, jtree = j_restore(str(tmp_path / "t"),
                         dict(back.checkpoint_tree(), retry=0, lost=0))
    back.load_checkpoint_tree(jtree)
    np.testing.assert_array_equal(np.asarray(back.phi_wk),
                                  np.asarray(theirs.phi_wk))
    assert (back.round, back.cursor) == (1, 2)
