"""Chaos suite of the port, on the CPU: the cases of ``tests/test_chaos.py``
run on ``repro_torch``.

* **Crash consistency** — a sacrificial ``python -c`` subprocess in which
  ``import jax`` and ``import repro`` fail SIGKILLs itself (``hard=True``
  kill specs) inside ``ParameterStore.flush`` / ``save_checkpoint``; the
  test then opens the survivors and asserts recovery lands on a consistent
  version.
* **Elastic resume** — a seeded shard kill mid-stream on a (data = 2,
  model = 2) mesh of four gloo ranks (``spawn_mesh``): rank 0 checkpoints
  the gathered stats after every step; after the kill a (1, 2) mesh of two
  ranks restores the checkpoint resharded (``restore_resharded``), resumes
  from the data cursor, and the held-out perplexity matches the unfaulted
  run within 5% (stochastic-approximation tolerance: the resumed steps
  draw other μ₀ slices), every token folded exactly once (mass within
  1e-3 relative).
"""
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (
    PartitionSpec,
    restore_checkpoint,
    restore_resharded,
    save_checkpoint,
)
from repro_torch.core import GlobalStats, LDAConfig, MinibatchData
from repro_torch.core.foem_sharded import foem_step_sharded, shard_stats
from repro_torch.core.perplexity import (
    predictive_perplexity,
    split_heldout_counts,
)
from repro_torch.data import synthetic_lda_corpus
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.runtime import FaultPlan, InjectedFault, faults
from repro_torch.sparse import MinibatchStream

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NO_JAX = ("import sys\nsys.modules['jax'] = None\n"
          "sys.modules['jaxlib'] = None\nsys.modules['repro'] = None\n")


def _run(body: str, expect_signal: int = 0) -> str:
    r = subprocess.run(
        [sys.executable, "-c", NO_JAX + textwrap.dedent(body)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    if expect_signal:
        assert r.returncode == -expect_signal, (
            f"expected death by signal {expect_signal}, got "
            f"{r.returncode}\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
        )
    else:
        assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


# ---------------------------------------------------------------------------
# ParameterStore: SIGKILL at the injected flush points
# ---------------------------------------------------------------------------

_STORE_SETUP = """
import numpy as np
from repro_torch.core.streaming import ParameterStore
from repro_torch.runtime import faults
d = {path!r}
plan = faults.FaultPlan([faults.FaultSpec(
    point={point!r}, kind="kill", step=5, hard=True)])
s = ParameterStore(d, num_topics=4, vocab_capacity=64, buffer_rows=16,
                   faults=plan)
s.write_rows(np.arange(3), np.full((3, 4), 2.0, np.float32))
s.phi_k = np.full(4, 6.0); s.step = 1
s.flush()                                # version 1 lands cleanly
s.write_rows(np.arange(3), np.full((3, 4), 9.0, np.float32))
s.phi_k = np.full(4, 27.0); s.step = 5
s.flush()                                # SIGKILL fires inside this one
raise SystemExit("fault did not fire")
"""


@pytest.mark.parametrize("point,expect_new", [
    ("mid-flush", False),     # killed before the WAL commit → old version
    ("pre-publish", True),    # killed after apply, before manifest → new
])
def test_store_sigkill_recovers_consistent_version(tmp_path, point,
                                                   expect_new):
    from repro_torch.core.streaming import ParameterStore

    _run(_STORE_SETUP.format(path=str(tmp_path), point=point),
         expect_signal=signal.SIGKILL)
    s = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=64,
                       buffer_rows=16)
    if expect_new:
        assert s.step == 5 and s.recovered_from_wal
        np.testing.assert_allclose(s.fetch_rows(np.arange(3)), 9.0)
        np.testing.assert_allclose(s.phi_k, 27.0)
    else:
        assert s.step == 1 and not s.recovered_from_wal
        np.testing.assert_allclose(s.fetch_rows(np.arange(3)), 2.0)
        np.testing.assert_allclose(s.phi_k, 6.0)
    assert not os.path.exists(tmp_path / "store.wal")
    assert not os.path.exists(tmp_path / "store.wal.tmp")


def test_store_torn_manifest_repaired_by_wal(tmp_path):
    """External truncation of the manifest is survivable while the WAL
    exists (the pre-publish crash window); without one it raises."""
    from repro_torch.core.streaming import ParameterStore, StoreCorruptionError

    _run(_STORE_SETUP.format(path=str(tmp_path), point="pre-publish"),
         expect_signal=signal.SIGKILL)
    with open(tmp_path / "store.json", "r+") as f:
        f.truncate(10)
    s = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=64,
                       buffer_rows=16)
    assert s.step == 5 and s.recovered_from_wal
    with open(tmp_path / "store.json", "r+") as f:
        f.truncate(10)
    with pytest.raises(StoreCorruptionError):
        ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=64,
                       buffer_rows=16)


def test_checkpoint_sigkill_mid_save(tmp_path):
    """SIGKILL inside save_checkpoint leaves the previous checkpoint
    restorable (mid-flush: before the commit rename)."""
    tree = {"x": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, tree)
    _run(f"""
    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.runtime import faults
    plan = faults.FaultPlan([faults.FaultSpec(
        point=faults.MID_FLUSH, kind="kill", hard=True)])
    save_checkpoint({str(tmp_path)!r}, 2, {{"x": torch.arange(4.0) + 1}},
                    faults=plan)
    raise SystemExit("fault did not fire")
    """, expect_signal=signal.SIGKILL)
    assert os.path.isdir(tmp_path / "step_00000002.tmp")   # the torn shadow
    step, out = restore_checkpoint(str(tmp_path), tree)
    assert step == 1
    np.testing.assert_allclose(np.asarray(out["x"]), np.arange(4.0))
    assert not os.path.exists(tmp_path / "step_00000002.tmp")


# ---------------------------------------------------------------------------
# e2e: seeded shard kill → reshard onto survivors → resume from cursor
# ---------------------------------------------------------------------------

SEED = 1234
CFG = dict(num_topics=8, vocab_size=300, max_sweeps=12, iem_blocks=2,
           active_topics=4, topk_shards=2, ppl_check_every=4)


def _data():
    corpus, _ = synthetic_lda_corpus(160, 300, 8, mean_doc_len=50, seed=3)
    mbs = list(MinibatchStream(corpus, 32, seed=0, epochs=1))
    held = mbs.pop()                      # last minibatch = held-out docs
    return mbs, held


def _plan():
    return FaultPlan.from_seed(SEED, num_faults=1, max_step=3, num_shards=2,
                               points=(faults.PRE_PROBE,), kinds=("kill",))


def _spec_tree():
    return {"stats": GlobalStats(PartitionSpec(None, "model"),
                                 PartitionSpec("model"), PartitionSpec()),
            "cursor": PartitionSpec()}


def _rows(mb, mesh):
    dp, d = mesh.data.size, mesh.data.index
    n = mb.word_ids.shape[0]
    sl = slice(d * n // dp, (d + 1) * n // dp)
    return MinibatchData(torch.from_numpy(mb.word_ids[sl]),
                         torch.from_numpy(mb.counts[sl]))


def _gather(stats, mesh):
    """The whole stats from the ranks' model slices (every other lane
    zero, so the sum over the model axis is exact)."""
    K, mp, m = CFG["num_topics"], mesh.model.size, mesh.model.index
    lo, hi = m * K // mp, (m + 1) * K // mp
    wk = torch.zeros((stats.phi_wk.shape[0], K))
    k = torch.zeros(K)
    wk[:, lo:hi] = stats.phi_wk
    k[lo:hi] = stats.phi_k
    wk, k = mesh.model.all_reduce(wk, k)
    return GlobalStats(wk, k, stats.step)


def _steps(stats, mesh, cfg, todo, start, plan=None, on_step=None):
    for i, mb in enumerate(todo, start=start):
        gen = torch.Generator().manual_seed(7000 + i)
        stats, _, _ = foem_step_sharded(gen, _rows(mb, mesh), stats, cfg,
                                        mesh, faults=plan)
        if on_step is not None:
            on_step(i + 1, stats)
    return stats


def _save_on_rank0(mesh, ckpt, cursor, stats):
    full = _gather(stats, mesh)
    if mesh.rank == 0:
        save_checkpoint(ckpt, cursor, {
            "stats": full, "cursor": torch.tensor(cursor, dtype=torch.int32)})
    dist.barrier()


def _faulted_rank(mesh, ckpt):
    """On the (2, 2) mesh: the unfaulted run, then the faulted run, which
    checkpoints after every step until the seeded kill fires."""
    cfg = LDAConfig(**CFG)
    mbs, _ = _data()
    zero = shard_stats(GlobalStats.zeros(cfg), mesh.model.size,
                       mesh.model.index)
    clean = _gather(_steps(zero, mesh, cfg, mbs, 0), mesh)
    plan = _plan()
    _save_on_rank0(mesh, ckpt, 0, zero)
    try:
        _steps(zero, mesh, cfg, mbs, 0, plan=plan,
               on_step=lambda c, st: _save_on_rank0(mesh, ckpt, c, st))
        killed = None
    except InjectedFault as e:
        killed = (e.shard, e.step)
    return {"clean_phi_wk": clean.phi_wk.numpy(),
            "clean_phi_k": clean.phi_k.numpy(), "killed": killed,
            "fired": plan.fired_log()}


def _resume_rank(mesh, ckpt):
    """On the surviving (1, 2) mesh: restore resharded, resume from the
    cursor."""
    cfg = LDAConfig(**CFG)
    mbs, _ = _data()
    like = {"stats": GlobalStats.zeros(cfg),
            "cursor": torch.tensor(0, dtype=torch.int32)}
    step, tree = restore_resharded(ckpt, like, _spec_tree(), mesh)
    cursor = int(tree["cursor"])
    stats = tree["stats"]
    lanes = (stats.phi_wk.shape, stats.phi_k.shape)
    resumed = _gather(_steps(stats, mesh, cfg, mbs[cursor:], cursor), mesh)
    return {"step": step, "cursor": cursor, "lanes": lanes,
            "phi_wk": resumed.phi_wk.numpy(),
            "phi_k": resumed.phi_k.numpy(), "steps": int(resumed.step)}


def test_elastic_resume_e2e(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    spec = _plan().specs[0]
    assert _plan().specs == [spec]            # the plan IS its seed
    first = spawn_mesh(_faulted_rank, 2, 2, device="cpu", args=(ckpt,),
                       timeout=300)
    for r in first:
        assert r["killed"] == (spec.shard, spec.step), (
            "fault must fire exactly where the seed put it", r["killed"])
        assert r["fired"] == [("kill", faults.PRE_PROBE, spec.shard,
                               spec.step)]
    second = spawn_mesh(_resume_rank, 1, 2, device="cpu", args=(ckpt,),
                        timeout=300)
    res = second[0]
    # kill at step s → s clean steps were checkpointed
    assert res["step"] == res["cursor"] == spec.step
    assert res["lanes"] == ((300, 4), (4,))    # K/mp lanes on each rank
    np.testing.assert_array_equal(res["phi_wk"], second[1]["phi_wk"])

    cfg = LDAConfig(**CFG)
    mbs, held = _data()
    tokens = sum(float(mb.counts.sum()) for mb in mbs)
    mass = float(res["phi_k"].sum())
    assert abs(mass - tokens) / tokens < 1e-3, (mass, tokens)
    assert res["steps"] == len(mbs)

    est_c, ev_c = split_heldout_counts(held.counts.astype(np.int64),
                                       np.random.default_rng(11))
    hw = torch.from_numpy(held.word_ids)
    est = MinibatchData(hw, torch.from_numpy(est_c.astype(np.float32)))
    ev = MinibatchData(hw, torch.from_numpy(ev_c.astype(np.float32)))

    def heldout(phi_wk, phi_k):
        return float(predictive_perplexity(
            99, est, ev, torch.from_numpy(phi_wk), torch.from_numpy(phi_k),
            cfg, fit_sweeps=32, active_topics=cfg.active_topics,
            device="cpu"))

    ppl_clean = heldout(first[0]["clean_phi_wk"], first[0]["clean_phi_k"])
    ppl_resumed = heldout(res["phi_wk"], res["phi_k"])
    rel = abs(ppl_resumed - ppl_clean) / ppl_clean
    assert rel < 0.05, (ppl_clean, ppl_resumed, rel)
