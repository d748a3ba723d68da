"""The port's LDA cells, roofline terms and dry run vs the JAX package, on
the CPU.

* ``build_lda_cell``'s meta-device stand-ins have the shapes and dtypes of
  the JAX cell's ``abstract_args`` (``jax.eval_shape`` stand-ins, nothing
  compiled) for every ``LDA_SHAPES`` regime, dense and sharded; a sharded
  rank's stand-ins are its slices; building allocates nothing.
* ``lda_model_flops`` and ``model_flops_for`` equal the JAX functions on
  every LDA shape and every shape of the four ported dense archs.
* ``dryrun.run_lda_cell`` on a tiny shape writes a complete record with
  finite values, and a cell larger than a given memory is recorded
  ``"fits": false`` without a run.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import foem_lda as jfoem_lda
from repro.configs.registry import get_arch as jget_arch
from repro.launch import roofline as jrl
from repro.launch.specs import build_lda_cell as jbuild_lda_cell
from repro.parallel.compat import make_mesh
from repro_torch.configs import LDA_SHAPES, LDAShapeConfig
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.mesh import Mesh, MeshAxis

SHAPES = [s.name for s in LDA_SHAPES]
TINY = LDAShapeConfig("tiny", minibatch_docs=16, bucket_len=8,
                      num_topics=16, vocab_size=64)


def _sig(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _mesh(model, index=0):
    """A (1, model) mesh description at model coordinate ``index``."""
    return Mesh(MeshAxis("data", 1, 0), MeshAxis("model", model, index),
                torch.device("cpu"))


@pytest.mark.parametrize("impl", ["dense", "sharded"])
@pytest.mark.parametrize("name", SHAPES)
def test_cell_stand_ins_match_the_jax_cell(name, impl):
    jmesh = make_mesh((1, 1), ("data", "model"))
    want = jbuild_lda_cell(name, jmesh,
                           impl="pjit" if impl == "dense" else "sharded")
    cell = specs.build_lda_cell(name, _mesh(1), impl=impl)
    key, batch, stats = cell.abstract_args
    got = [key, *batch, *stats]
    assert all(t.device.type == "meta" for t in got)
    assert [_sig(t) for t in got] == [
        (tuple(s.shape), str(s.dtype))
        for s in jax.tree.leaves(want.abstract_args)]
    assert cell.donate_argnums == want.donate_argnums == (2,)
    assert cell.kind == want.kind == "lda"
    # the sharded cell splits the active sets over the model axis
    assert cell.cfg.topk_shards == (1 if impl == "sharded" else 0)


def test_sharded_cell_says_which_arguments_are_a_ranks_slice():
    shp = LDA_SHAPES[0]                        # stream_1k over 4 ranks
    K, W = shp.num_topics, shp.vocab_size
    for m in range(4):
        cell = specs.build_lda_cell(shp.name, _mesh(4, m), impl="sharded")
        assert cell.cfg.topk_shards == 4
        _, batch, stats = cell.rank_args()
        assert _sig(stats.phi_wk) == ((W, K // 4), "float32")
        assert _sig(stats.phi_k) == ((K // 4,), "float32")
        assert _sig(batch.word_ids) == ((1024, 128), "int32")
        assert cell.slice_specs[2].phi_wk == (None, "model")
    stats = (W * K + K) * 4                    # φ̂ and φ̂(k), float32
    whole = stats + 2 * 1024 * 128 * 4 + 8 + 4  # + word ids, counts, key, step
    assert cell.arg_bytes() == whole
    assert cell.arg_bytes(per_device=True) == whole - stats * 3 // 4
    dense = specs.build_lda_cell(shp.name)
    assert dense.rank_args()[2].phi_wk.shape == (W, K)
    with pytest.raises(ValueError, match="shards topics"):
        specs.build_lda_cell(shp.name, _mesh(4), impl="sharded",
                             shard_topics=False)
    with pytest.raises(ValueError, match="mesh"):
        specs.build_lda_cell(shp.name, impl="sharded")


def test_materialized_cell_is_the_stand_ins_with_values():
    cell = specs.build_lda_cell(TINY, _mesh(2, 1), impl="sharded",
                                active_topics=4)
    key, batch, stats = cell.materialize("cpu", seed=3)
    k, b, s = cell.rank_args()
    assert [_sig(t) for t in (key, *batch, *stats)] == [
        _sig(t) for t in (k, *b, *s)]
    assert key.tolist() == [0, 3]
    assert float(stats.phi_wk.abs().sum()) == 0.0
    wid, cnt = specs.cell_minibatch(TINY, 3)
    np.testing.assert_array_equal(batch.word_ids.numpy(), wid)
    assert (wid < TINY.vocab_size).all() and cnt.sum() > 0
    again, _ = specs.cell_minibatch(TINY, 3)
    np.testing.assert_array_equal(again, wid)
    assert specs.seed_key(2 ** 40 + 7) == (256, 7)


@pytest.mark.parametrize("sweeps", [1, 12, 32])
@pytest.mark.parametrize("name", SHAPES)
def test_lda_model_flops_match_jax(name, sweeps):
    shp = LDA_SHAPES[SHAPES.index(name)]
    jshp = next(s for s in jfoem_lda.LDA_SHAPES if s.name == name)
    for active in (16, 4):
        assert roofline.lda_model_flops(shp, sweeps, active) == \
            jrl.lda_model_flops(jshp, sweeps, active)
    assert roofline.lda_model_flops(shp) == jrl.lda_model_flops(jshp)


@pytest.mark.parametrize("arch", ["granite-20b", "granite-8b",
                                  "h2o-danube-3-4b", "internlm2-20b"])
def test_model_flops_for_matches_jax_on_the_dense_archs(arch):
    assert arch in list_archs()
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shapes, jshapes = cfg.shapes(), jcfg.shapes()
    assert [s.name for s in shapes] == [s.name for s in jshapes]
    for s, js in zip(shapes, jshapes):
        assert roofline.model_flops_for(cfg, s) == \
            jrl.model_flops_for(jcfg, js) > 0


def test_roofline_terms_against_the_h100_peaks():
    r = roofline.roofline(67e12, 3.35e12 / 2, step_time_s=2.0)
    assert (r.compute_s, r.memory_s) == (1.0, 0.5)
    assert r.dominant == "compute" and r.bound_fraction == 0.5
    d = roofline.roofline(1.0, 3.35e12).as_dict()
    assert d["dominant"] == "memory" and d["bound_fraction"] is None
    nbytes = roofline.lda_step_bytes(TINY, 2)
    assert nbytes == 2 * 3 * 16 * 8 * 16 * 4 + 2 * (64 * 16 + 16) * 4


KEYS = {"arch", "shape", "kind", "impl", "ranks", "seed", "device", "dims",
        "argument_bytes", "argument_bytes_per_rank", "working_set_bytes",
        "predicted_bytes_on_card", "free_bytes", "fits", "ran", "build_s",
        "peak_allocated_bytes", "step_s", "step_s_by_rank", "sweeps",
        "train_ppl", "tokens", "phi_k_mass", "launches", "roofline"}
#: What a host run does not measure: the card's peak, the share of the
#: card's roofline (the host's seconds are not set against it), and the
#: kernels' build (a host run has none).
NOT_ON_HOST = {"peak_allocated_bytes", "bound_fraction", "step_time_s",
               "build_s"}


def _numbers(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _numbers(v, path)
    else:
        yield path, tree


@pytest.mark.parametrize("impl", ["dense", "sharded"])
def test_dryrun_writes_a_complete_record_on_the_cpu(tmp_path, impl):
    rec = dryrun.run_lda_cell(TINY, impl=impl, ranks=2, active_topics=4,
                              device="cpu", out_dir=str(tmp_path),
                              verbose=False)
    on_disk = json.loads(
        (tmp_path / f"foem-lda_tiny_{impl}.json").read_text())
    assert on_disk == rec and set(rec) == KEYS
    assert rec["fits"] and rec["ran"] and rec["device"] == "cpu"
    for key, v in _numbers(rec):
        if key in NOT_ON_HOST:
            assert v is None, key
        elif not isinstance(v, str):
            assert v is not None and math.isfinite(v), key
    assert 1 <= rec["sweeps"] <= 32 and 1.0 < rec["train_ppl"] < 64
    np.testing.assert_allclose(rec["phi_k_mass"], rec["tokens"], rtol=1e-5)
    work = rec["working_set_bytes"]
    mu = 16 * 8 * 16 * 4 // rec["ranks"]
    assert work["mu"] == work["mu_new"] == work["residual"] == mu
    assert rec["roofline"]["flops"] == roofline.lda_model_flops(
        TINY, rec["sweeps"], 4)
    assert rec["roofline"]["dominant"] == "memory"


def test_dryrun_records_a_cell_too_large_without_running(tmp_path,
                                                        monkeypatch):
    def must_not_run(*args):
        raise AssertionError("a cell predicted not to fit ran")

    monkeypatch.setattr(dryrun, "_run_step", must_not_run)
    rec = dryrun.run_lda_cell(TINY, device="cpu", free_bytes=0,
                              out_dir=None, verbose=False, active_topics=4)
    need = rec["predicted_bytes_on_card"]
    assert need == (rec["argument_bytes"]
                    + sum(rec["working_set_bytes"].values()))
    rec = dryrun.run_lda_cell(TINY, device="cpu", free_bytes=need - 1,
                              out_dir=str(tmp_path), verbose=False,
                              active_topics=4)
    assert not rec["fits"] and not rec["ran"]
    assert rec["free_bytes"] == need - 1
    assert rec["step_s"] is None and rec["roofline"] is None
    assert json.loads((tmp_path / "foem-lda_tiny_dense.json").read_text()) \
        == rec
    # bigmodel's φ̂ alone (5·10⁵ × 5·10⁴ float32 = 100 GB) exceeds one card
    big = specs.build_lda_cell("bigmodel")
    assert big.arg_bytes() > 100e9 > 80e9


def test_dryrun_cli_runs_a_named_cell(tmp_path, capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--device", "cpu"])
    recs = dryrun.main(["--lda", "stream_1k", "--device", "cpu",
                        "--free-bytes", "1000", "--out", str(tmp_path)])
    assert [r["shape"] for r in recs] == ["stream_1k"]
    assert not recs[0]["fits"]
    assert capsys.readouterr().out.startswith("dryrun {")
    assert (tmp_path / "foem-lda_stream_1k_dense.json").exists()
