"""The port's LM cells (``launch.specs.build_lm_cell``, ``input_specs``)
and the LM half of its dry run vs the JAX package, on the CPU.

* ``input_specs`` has the JAX stand-ins' shapes and dtypes on every
  runnable (arch, shape) cell.
* The train (``micro_batches`` 1 and 2), prefill and decode cells of the
  reduced dense (h2o-danube, its 32-key window), MoE (qwen2-moe, EP on a
  1 × 1 mesh in both packages) and SSM (mamba2) configs on a tiny
  ``ShapeConfig`` (B 2, S 16): the port cell's ``fn`` against the JAX
  cell's, jitted on a 1-device host mesh, from the JAX ``init_params``
  weights carried across by ``convert.params_from_jax`` and one numpy
  batch.  The optimizer's count is 2000 (the warm-up's end, lr 3e-4: at
  count 0 the learning rate is 0 and the parameters would not move).
  Float32 throughout; loss, new parameters and moments at rtol 1e-4 /
  atol 1e-6 (the gradient leaves' tolerance of ``test_torch_lm_train.py``:
  sums in other orders), logits and caches at 1e-4.  A parameter whose
  AdamW step is ill-conditioned (√v̂ within 10× of eps: its gradient is
  ~1e-7) is held within the update's bound, lr (``_params_close``).
* ``dryrun.run_cell`` on a tiny reduced cell writes a complete record,
  and jamba's full-size ``train_4k`` cell is recorded ``"fits": false``
  with its per-device bytes on both production meshes, without a run.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import specs as jspecs
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.optim.adamw import OptState as JOptState
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import cache_from_jax, params_from_jax

CELLS = [(a, s.name) for a in sorted(ARCHS) for s in ARCHS[a].shapes()]
ARCHS_UNDER_TEST = ["h2o-danube-3-4b", "qwen2-moe-a2.7b", "mamba2-370m"]
KINDS = [("train", 1), ("train", 2), ("prefill", 1), ("decode", 1)]
B, S = 2, 16
COUNT = 2000
RTOL, ATOL = 1e-4, 1e-6
OUT_TOL = 1e-4
ILL_ROOT = 1e-7


def _sig(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def test_every_runnable_cell_is_listed():
    assert len(CELLS) == 33
    assert len(list(dryrun.iter_all_cells())) == 33 + 3


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    got = specs.input_specs(arch, shape)
    want = jspecs.input_specs(arch, shape)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert _sig(t) == (tuple(want[k].shape), str(want[k].dtype)), k


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), path + (k,)))
        return out
    return {path: tree}


def _close(got, want, rtol, atol, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), what
    for k in w:
        np.testing.assert_allclose(
            np.asarray(g[k].detach().float() if torch.is_tensor(g[k])
                       else g[k], np.float32),
            np.asarray(w[k], np.float32), rtol=rtol, atol=atol,
            err_msg=f"{what} {k}")


def _params_close(got, want, nu):
    """New parameters at RTOL/ATOL, except where AdamW's step is
    ill-conditioned: 0 < √v̂ < ILL_ROOT = 10·eps (a gradient of ~1e-7,
    where m̂/(√v̂ + eps) moves by ~0.1·eps·δg/(√v̂ + eps)²: a float32
    difference δg of the packages' gradient sums steers it apart).  There
    the update is bounded by lr · (|m̂|/(√v̂ + eps) + wd·|p|) < lr, and the
    two parameters must agree within lr; fewer than 1 in 100 elements
    are such (0.06–0.5% at these cells: the MoE's rarely routed experts
    have the most)."""
    c2 = 1.0 - 0.95 ** (COUNT + 1)
    g, w, v = _flat(got), _flat(want), _flat(nu)
    ill = 0
    for k in w:
        a = g[k].detach().float().numpy()
        b = np.asarray(w[k], np.float32)
        root = np.sqrt(np.asarray(v[k], np.float64) / c2)
        bad = (root > 0) & (root < ILL_ROOT)   # a zero gradient is exact
        ill += int(bad.sum())
        np.testing.assert_allclose(a[~bad], b[~bad], rtol=RTOL, atol=ATOL,
                                   err_msg=f"params {k}")
        assert np.all(np.abs(a[bad] - b[bad]) <= specs.LM_PEAK_LR), k
    assert ill < sum(np.size(x) for x in w.values()) // 100, ill


def _jax_cell(monkeypatch, cfg, shape):
    monkeypatch.setattr(jspecs, "get_arch", lambda name: cfg)
    monkeypatch.setattr(jspecs, "get_shape", lambda c, name: shape)
    mesh = jhost_mesh(1, 1)
    return jspecs.build_lm_cell(cfg.name, shape.name, mesh), mesh


@pytest.mark.parametrize("kind,mb", KINDS, ids=[f"{k}-mb{m}"
                                                 for k, m in KINDS])
@pytest.mark.parametrize("name", ARCHS_UNDER_TEST)
def test_cell_fn_matches_the_jax_cell(monkeypatch, name, kind, mb):
    cfg_t = dataclasses.replace(ARCHS[name].reduced(), micro_batches=mb)
    cfg_j = dataclasses.replace(JAX_ARCHS[name].reduced(), micro_batches=mb)
    shp_t = ShapeConfig(f"tiny_{kind}", seq_len=S, global_batch=B, kind=kind)
    shp_j = JShape(f"tiny_{kind}", seq_len=S, global_batch=B, kind=kind)
    jcell, jmesh = _jax_cell(monkeypatch, cfg_j, shp_j)
    cell = specs.build_lm_cell(cfg_t, shp_t, make_host_mesh(device="cpu"))
    assert cell.kind == jcell.kind == kind
    assert cell.donate_argnums == jcell.donate_argnums
    # the stand-ins: the JAX abstract arguments' shapes and dtypes, path
    # for path (a JAX SSMCache's fields are the port's dict keys)
    assert len(cell.abstract_args) == len(jcell.abstract_args)
    for got, want in zip(cell.abstract_args, jcell.abstract_args):
        assert {k: _sig(t) for k, t in _flat(got).items()} == {
            k: (tuple(s.shape), str(s.dtype))
            for k, s in _flat(want).items()}

    pj = jax.device_get(
        jax.jit(lambda: __import__("repro.models.lm", fromlist=["LM"])
                .LM(cfg_j).init_params(jax.random.PRNGKey(0)))())
    pt = params_from_jax(pj, device="cpu")
    rng = np.random.default_rng(1)
    Sx = S if kind != "decode" else 1
    tokens = rng.integers(0, cfg_t.vocab_size, (B, Sx), dtype=np.int32)
    bj = {"tokens": jnp.asarray(tokens)}
    bt = {"tokens": torch.from_numpy(tokens)}
    if kind == "train":
        labels = rng.integers(0, cfg_t.vocab_size, (B, Sx), dtype=np.int32)
        bj["labels"], bt["labels"] = jnp.asarray(labels), torch.from_numpy(
            labels)
    with jmesh:
        if kind == "train":
            zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                 pj)
            oj = JOptState(mu=zeros, nu=zeros, count=jnp.int32(COUNT))
            lj, npj, noj = jax.jit(jcell.fn)(pj, oj, bj)
            from repro_torch.optim import adamw_init
            ot = adamw_init(pt)._replace(
                count=torch.tensor(COUNT, dtype=torch.int32))
            lt, npt, not_ = cell.fn(pt, ot, bt)
            np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
            _close({"mu": not_.mu, "nu": not_.nu},
                   {"mu": jax.device_get(noj.mu),
                    "nu": jax.device_get(noj.nu)}, RTOL, ATOL, "moments")
            _params_close(npt, jax.device_get(npj), jax.device_get(noj.nu))
            assert int(not_.count) == int(noj.count) == COUNT + 1
            return
        if kind == "prefill":
            logits_j, cj = jax.jit(jcell.fn)(pj, bj)
            logits_t, ct = cell.fn(pt, bt)
        else:
            model = __import__("repro.models.lm", fromlist=["LM"]).LM(cfg_j)
            cj0 = model.init_cache(B, S)
            pos = S - 1
            logits_j, cj = jax.jit(jcell.fn)(pj, cj0, bj, jnp.int32(pos))
            from repro_torch.models.lm import LM
            ct0 = LM(cfg_t, device="cpu").init_cache(B, S)
            logits_t, ct = cell.fn(pt, ct0, bt,
                                   torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    _close(ct, cache_from_jax(jax.device_get(cj), device="cpu"), OUT_TOL,
           OUT_TOL, "caches")


def test_train_cell_accumulates_float32_sums(monkeypatch):
    """``grad_fn`` with 2 microbatches is the float32 mean of the two
    microbatches' gradients, and its loss their mean."""
    cfg = dataclasses.replace(ARCHS["h2o-danube-3-4b"].reduced(),
                              micro_batches=2)
    shp = ShapeConfig("tiny", seq_len=S, global_batch=B, kind="train")
    cell = specs.build_lm_cell(cfg, shp, make_host_mesh(device="cpu"))
    params, opt, batch = cell.materialize("cpu", seed=4)
    loss, grads = cell.grad_fn(params, batch)
    one = specs.build_lm_cell(dataclasses.replace(cfg, micro_batches=1),
                              dataclasses.replace(shp, global_batch=1),
                              make_host_mesh(device="cpu"))
    parts = [one.grad_fn(params, {k: v[i:i + 1] for k, v in batch.items()})
             for i in range(2)]
    np.testing.assert_allclose(float(loss),
                               (float(parts[0][0]) + float(parts[1][0])) / 2,
                               rtol=1e-6)
    g, a, b = _flat(grads), _flat(parts[0][1]), _flat(parts[1][1])
    for k in g:
        assert g[k].dtype == torch.float32
        torch.testing.assert_close(g[k], (a[k].float() + b[k].float()) / 2,
                                   rtol=0, atol=0)
    assert int(opt.count) == 0 and not any(
        p.requires_grad for p in _flat(params).values())


LM_KEYS = {"arch", "shape", "kind", "mesh", "seed", "device", "dims",
           "argument_bytes", "argument_bytes_per_device",
           "working_set_bytes", "predicted_bytes_on_card", "free_bytes",
           "fits", "ran", "build_s", "peak_allocated_bytes", "step_s",
           "first_step_s", "launches", "launches_all", "finite",
           "roofline"}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_writes_a_complete_lm_record_on_the_cpu(tmp_path, kind):
    cfg = ARCHS["h2o-danube-3-4b"].reduced()
    shp = ShapeConfig(f"tiny_{kind}", seq_len=64, global_batch=2, kind=kind)
    rec = dryrun.run_cell(cfg, shp, device="cpu", out_dir=str(tmp_path),
                          verbose=False, both_meshes=True, opt_count=COUNT,
                          overrides={"micro_batches": 2})
    on_disk = json.loads(
        (tmp_path / f"h2o-danube-3-4b_tiny_{kind}_16x16.json").read_text())
    assert on_disk == rec and LM_KEYS <= set(rec)
    assert rec["fits"] and rec["ran"] and rec["finite"]
    assert rec["device"] == "cpu" and rec["peak_allocated_bytes"] is None
    assert set(rec["argument_bytes_per_device"]) == {"16x16", "2x16x16"}
    assert rec["predicted_bytes_on_card"] == rec["argument_bytes"] + sum(
        rec["working_set_bytes"].values())
    assert rec["launches"] == {"flash_attention": 0,
                               "flash_attention_backward": 0}
    assert math.isfinite(rec["step_s"])
    roof = rec["roofline"]
    assert roof["step_time_s"] is None and roof["flops"] > 0
    if kind == "train":
        assert rec["opt_count"] == COUNT + dryrun.LM_STEPS
        assert len(rec["losses"]) == dryrun.LM_STEPS
        assert math.isfinite(rec["loss"]) and rec["loss"] == rec["losses"][0]
        assert rec["leaves_changed"] == rec["leaves"] > rec["matrices"]
        assert rec["matrices_changed"] == rec["matrices"] > 0
        assert rec["working_set_bytes"]["gradient_sums"] > 0
    else:
        # pos 63 in a 32-slot ring: the step writes slot 31 alone
        assert rec["written_slots"] == [63 % cfg.sliding_window]
        assert rec["logits_shape"] == [2, 1, cfg.vocab_size]


def test_full_size_cell_is_sized_and_not_run(tmp_path, monkeypatch):
    def must_not_run(*args, **kwargs):
        raise AssertionError("a cell predicted not to fit ran")

    monkeypatch.setattr(dryrun, "_run_lm_step", must_not_run)
    monkeypatch.setattr(specs.LMCell, "materialize", must_not_run)
    recs = dryrun.main(["--arch", "jamba-1.5-large-398b", "--shape",
                        "train_4k", "--device", "cpu", "--both-meshes",
                        "--free-bytes", str(80 * 10 ** 9), "--out",
                        str(tmp_path)])
    (rec,) = recs
    assert not rec["fits"] and not rec["ran"] and rec["step_s"] is None
    per = rec["argument_bytes_per_device"]
    assert set(per) == {"16x16", "2x16x16"}
    # params + float32 moments ≈ 398B · (2 + 8) bytes, over 256 devices
    assert rec["argument_bytes"] > 3.9e12
    assert 0 < per["2x16x16"] <= per["16x16"] < rec["argument_bytes"] / 100
    assert rec["predicted_bytes_on_card"] > rec["argument_bytes"]
    assert (tmp_path / "jamba-1.5-large-398b_train_4k_16x16.json").exists()
