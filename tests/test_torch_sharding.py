"""The port's sharding rules (``repro_torch.parallel.sharding``) and
``LM.abstract_params`` vs the JAX package's, on the CPU.

* ``param_pspecs``, ``zero1_pspecs`` and ``cache_pspecs`` of every arch at
  full size equal ``tuple(P)`` of the JAX functions leaf for leaf (the JAX
  tree paths against the port's dict keys), on the device-free production
  meshes (16, 16) and (2, 16, 16) — ``compat.abstract_mesh`` on the JAX
  side, ``launch.mesh.make_production_mesh`` here — and with the levers
  ``fsdp``, ``tp_size == 1`` and ``moe_impl == "ep"`` on granite-8b and
  qwen2-moe;
* ``batch_pspecs`` equal on every runnable (arch, shape), ``lda_pspecs`` in
  both modes;
* ``LM.abstract_params()`` has the JAX ``abstract_params()``'s keys, shapes
  and dtypes for every arch, and ``init_params``'s on each reduced config,
  with every leaf on the meta device (nothing allocated);
* ``shard_shape`` / ``block_index``: the blocks of a tensor under a spec
  tile it, for tuple entries too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models.lm import LM as JLM
from repro.parallel import sharding as jshard
from repro.parallel.compat import abstract_mesh
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import (AbstractMesh, Mesh, MeshAxis,
                                     make_production_mesh)
from repro_torch.models.lm import LM
from repro_torch.parallel import sharding

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LEVERS = [("granite-8b", {"fsdp": True}), ("granite-8b", {"tp_size": 1}),
          ("granite-8b", {"moe_impl": "ep"}),
          ("qwen2-moe-a2.7b", {"fsdp": True}),
          ("qwen2-moe-a2.7b", {"tp_size": 1}),
          ("qwen2-moe-a2.7b", {"moe_impl": "ep"}),
          ("qwen2-moe-a2.7b", {"zero1": True})]
CASES = [(a, {}) for a in sorted(JAX_ARCHS)] + LEVERS


def _key(k):
    return getattr(k, "key", getattr(k, "name", str(k)))


def _jax_specs(tree):
    """{path: tuple(P)} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (k,)))
        return out
    return {path: tree}


def _models(name, overrides):
    cfg_j = dataclasses.replace(JAX_ARCHS[name], **overrides)
    cfg_t = dataclasses.replace(ARCHS[name], **overrides)
    return JLM(cfg_j), LM(cfg_t, device="meta")


def _meshes(mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = make_production_mesh(multi_pod=len(shape) == 3)
    assert mesh.shape == dict(zip(names, shape))
    return abstract_mesh(shape, names), mesh


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name,overrides", CASES,
                         ids=[f"{a}-{','.join(o) or 'base'}"
                              for a, o in CASES])
def test_param_and_zero1_specs_match_jax(name, overrides, mesh_name):
    jm, tm = _models(name, overrides)
    jmesh, mesh = _meshes(mesh_name)
    want = _jax_specs(jshard.param_pspecs(jm, jmesh))
    got = _port_specs(sharding.param_pspecs(tm, mesh))
    assert got == want
    want = _jax_specs(jshard.zero1_pspecs(jm, jmesh))
    got = _port_specs(sharding.zero1_pspecs(tm, mesh))
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_cache_and_batch_specs_match_jax(name, mesh_name):
    jm, tm = _models(name, {})
    jmesh, mesh = _meshes(mesh_name)
    for shape in ARCHS[name].shapes():
        jshape = next(s for s in JAX_ARCHS[name].shapes()
                      if s.name == shape.name)
        assert sharding.batch_pspecs(tm.cfg, shape, mesh) == {
            k: tuple(v) for k, v in
            jshard.batch_pspecs(jm.cfg, jshape, jmesh).items()}
        if shape.kind == "decode":
            want = _jax_specs(jshard.cache_pspecs(jm, jshape, jmesh))
            got = _port_specs(sharding.cache_pspecs(tm, shape, mesh))
            assert got == want, shape.name


@pytest.mark.parametrize("shard_topics", [False, True])
def test_lda_specs_match_jax(shard_topics):
    jmesh, mesh = _meshes("16x16")
    want = jshard.lda_pspecs(jmesh, shard_topics=shard_topics)
    got = sharding.lda_pspecs(mesh, shard_topics=shard_topics)
    assert tuple(got) == tuple(tuple(s) for s in want)


def _sigs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_sigs(v, path + (k,)))
        return out
    return {path: (tuple(tree.shape),
                   str(tree.dtype).replace("torch.", ""))}


def _jax_sigs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(_key(k) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _devices(tree):
    if isinstance(tree, dict):
        return {d for v in tree.values() for d in _devices(v)}
    return {tree.device.type}


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_abstract_params_match_jax_and_allocate_nothing(name):
    model = LM(ARCHS[name], device="cpu")
    got = model.abstract_params()
    assert _devices(got) == {"meta"}
    assert _sigs(got) == _jax_sigs(JLM(JAX_ARCHS[name]).abstract_params())
    cache = model.abstract_cache(2, 64)
    assert _devices(cache) == {"meta"}
    assert _sigs(cache) == _jax_sigs(
        JLM(JAX_ARCHS[name]).abstract_cache(2, 64))
    if torch.cuda.is_available():
        before = torch.cuda.memory_allocated()
        LM(ARCHS[name]).abstract_params()
        assert torch.cuda.memory_allocated() == before


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_abstract_params_are_init_params_of_the_reduced_config(name):
    model = LM(ARCHS[name].reduced(), device="cpu")
    real = model.init_params(torch.Generator().manual_seed(0))
    assert _sigs(model.abstract_params()) == _sigs(real)
    assert _devices(real) == {"cpu"}


def _rank_mesh(data, model, d, m):
    return Mesh(MeshAxis("data", data, d), MeshAxis("model", model, m),
                torch.device("cpu"))


@pytest.mark.parametrize("spec", [(None, "model"), ("data", None),
                                  (("data", "model"), None),
                                  ("model", "data"), ()])
def test_rank_blocks_tile_the_tensor(spec):
    t = torch.arange(8 * 12).reshape(8, 12)
    seen = torch.zeros_like(t)
    for d in range(2):
        for m in range(4):
            mesh = _rank_mesh(2, 4, d, m)
            blk = t[sharding.block_index(t, spec, mesh)]
            assert tuple(blk.shape) == sharding.shard_shape(
                tuple(t.shape), spec, mesh)
            seen[sharding.block_index(t, spec, mesh)] += 1
    # every element is in exactly one block per position of the unused axes
    used = {a for e in spec for a in sharding._names(e)}
    copies = (1 if "data" in used else 2) * (1 if "model" in used else 4)
    assert torch.equal(seen, torch.full_like(t, copies))
    # (data, model) on one dimension: rank d·4 + m owns the (d·4 + m)-th row
    if spec == (("data", "model"), None):
        blk = t[sharding.block_index(t, spec, _rank_mesh(2, 4, 1, 2))]
        assert torch.equal(blk, t[6:7])


def test_shard_shape_on_the_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert isinstance(one, AbstractMesh) and one.size == 256
    assert two.size == 512 and two.axis_names == ("pod", "data", "model")
    assert sharding.shard_shape((256, 4096), (("pod", "data"), None),
                                two) == (8, 4096)
    assert sharding.shard_shape((49152, 4096), ("model", None),
                                one) == (3072, 4096)
    assert sharding.dp_axes(two) == ("pod", "data")
    t = torch.empty((32, 100), dtype=torch.bfloat16, device="meta")
    assert sharding.shard_bytes(t, ("data", "model"), one) == 2 * 7 * 2
    assert np.prod(sharding.shard_shape((5,), (), one)) == 5
