"""The port's expert-parallel MoE (``repro_torch.parallel.moe_ep``) on gloo
ranks on the CPU, against the JAX package's ``moe_apply_ep`` (``shard_map``
over 4 fake CPU devices, in a subprocess so that the device-count flag
never reaches the rest of the suite, as ``tests/test_distributed.py``
does) and against the port's own TP form.

One layer (D 16, F 32, 8 experts padded to 16, top-2, one shared expert of
32) with the JAX ``moe_init`` weights, on 2 × 32 tokens skewed towards a
few experts (a common direction added to every token) so that the config's
capacity factor 2.0 drops pairs; at 8.0 nothing drops (as
``tests/test_distributed.py:47``).  Float32: the EP and TP forms and the
two packages agree within ``ATOL`` = 2e-4 (that test's tolerance); at 2.0
the same pairs must drop in both packages, or the tokens that lost a pair
would differ by O(1).  Gradients of Σ y·w through the EP form (the port's
all-to-all, reassembly and replicated-input sums) equal the TP form's.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh, MeshAxis, spawn_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ATOL = 2e-4
D, F, E, K, SHARED_FF = 16, 32, 8, 2, 32
B, S = 2, 32
CF = {"dropless": 8.0, "drops": 2.0}


def _jax_side(path):
    """The weights, the tokens, and the JAX package's TP and EP outputs on
    a (1, 4) mesh of fake CPU devices, written to ``path`` (npz)."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, numpy as np, jax.numpy as jnp
        from repro.models import moe as moe_lib
        from repro.parallel.compat import make_mesh
        from repro.parallel.moe_ep import moe_apply_ep
        mesh = make_mesh((1, 4), ("data", "model"))
        rng = np.random.default_rng(0)
        p = moe_lib.moe_init(jax.random.PRNGKey(0), {D}, {F}, {E}, 1,
                             {SHARED_FF}, jnp.float32)
        skew = rng.normal(size=({D},)).astype(np.float32) * 2
        x = (rng.normal(size=({B}, {S}, {D})).astype(np.float32) + skew)
        out = {{"x": x, "tp": np.asarray(moe_lib.moe_apply(
            p, jnp.asarray(x), experts_per_token={K}))}}
        for name, cf in {CF!r}.items():
            with mesh:
                out[name] = np.asarray(jax.jit(lambda p, x: moe_apply_ep(
                    p, x, experts_per_token={K}, mesh=mesh,
                    dp_spec=("data",), capacity_factor=cf))(p, jnp.asarray(x)))
        flat = jax.tree_util.tree_flatten_with_path(jax.device_get(p))[0]
        for path, leaf in flat:
            out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        np.savez({str(path)!r}, **out)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(path))


def _params(arrays):
    p = {}
    for key, a in arrays.items():
        if key.startswith("p/"):
            node, parts = p, key[2:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(a.copy())
    return p


def _leaves(p):
    return [p["router"], p["w_gate"], p["w_up"], p["w_down"],
            *p["shared"].values()]


def _rank_body(mesh, arrays):
    """Every check's values on one rank of the mesh."""
    from repro_torch.models import moe
    from repro_torch.parallel import moe_apply_ep
    from repro_torch.parallel.moe_ep import (
        capacity, dispatch_slots, token_shard,
    )

    p, x = _params(arrays), torch.from_numpy(arrays["x"])
    out = {"tp": moe.moe_apply(p, x, experts_per_token=K)}
    b0, Bl, s0, Sl = token_shard(mesh, B, S)
    xt = x[b0:b0 + Bl, s0:s0 + Sl].reshape(-1, D)
    for name, cf in CF.items():
        out[name] = moe_apply_ep(p, x, experts_per_token=K, mesh=mesh,
                                 capacity_factor=cf)
        _, topi = moe.route(p["router"], xt, K)
        order, _ = moe.sort_pairs(topi)
        C = capacity(cf, Bl * Sl, K, E)
        _, _, keep = dispatch_slots(topi, order, p["w_gate"].shape[0], C)
        out[f"{name}_dropped"] = int((~keep).sum())
    # gradients of Σ y·w through both forms, every rank the same w
    w = torch.randn((B, S, D), generator=torch.Generator().manual_seed(1))
    for form in ("tp", "ep"):
        q = {n: (t.clone().requires_grad_() if n != "shared" else
                 {m: u.clone().requires_grad_() for m, u in t.items()})
             for n, t in p.items()}
        xg = x.clone().requires_grad_()
        y = (moe_apply_ep(q, xg, experts_per_token=K, mesh=mesh,
                          capacity_factor=CF["dropless"]) if form == "ep"
             else moe.moe_apply(q, xg, experts_per_token=K))
        (y * w).sum().backward()
        out[f"grads_{form}"] = [xg.grad] + [t.grad for t in _leaves(q)]
    # the tiled all-to-all moves (ep, …) blocks, any type exactly
    blocks = (torch.arange(mesh.model.size * 3, dtype=torch.float32)
              .view(mesh.model.size, 3) + 16 * mesh.model.index)
    out["a2a"] = mesh.model.all_to_all(blocks.to(torch.bfloat16)).float()
    return _numpy(out)


def _numpy(tree):
    """Tensors to numpy (results travel by value, not by shared memory)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy() if torch.is_tensor(tree) else tree


def _lm_body(mesh):
    """The reduced qwen2-moe LM with the mesh (its MoE layers through EP in
    prefill and training; its config's capacity factor 2.0 is dropless
    here: C = T_loc at 4 logical experts, top-2) against the same LM
    without one."""
    import dataclasses

    from repro_torch.checkpoint.ckpt import tree_flatten
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build, moe
    from repro_torch.models.lm import tree_map

    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    assert cfg.moe_impl == "ep" and cfg.moe_capacity_factor == 2.0
    assert cfg.num_experts / cfg.experts_per_token == 2.0
    calls = {"tp": 0}
    real = moe.moe_apply

    def counting(*a, **kw):
        calls["tp"] += 1
        return real(*a, **kw)

    moe.moe_apply = counting
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": tok[:, :16], "labels": tok[:, 1:]}
    out = {}
    for name, m in (("ep", mesh), ("tp", None)):
        model = build(dataclasses.replace(cfg), device="cpu", mesh=m)
        p = model.init_params(torch.Generator().manual_seed(0))
        before = calls["tp"]
        with torch.no_grad():
            out[f"logits_{name}"] = model.prefill(p, batch)[0]
        out[f"tp_calls_{name}"] = calls["tp"] - before
        tree_map(lambda t: t.requires_grad_(), p)
        loss = model.loss_fn(p, batch)
        loss.backward()
        out[f"loss_{name}"] = loss.detach()
        out[f"grads_{name}"] = [t.grad for t in tree_flatten(p)[0]]
    moe.moe_apply = real
    return _numpy(out)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    arrays = _jax_side(tmp_path_factory.mktemp("ep") / "jax.npz")
    ranks = spawn_mesh(_rank_body, 1, 4, device="cpu", args=(arrays,),
                       timeout=120)
    return arrays, ranks


def test_ep_dropless_matches_jax(sides):
    arrays, ranks = sides
    assert ranks[0]["dropless_dropped"] == 0
    np.testing.assert_allclose(ranks[0]["dropless"],
                               arrays["dropless"], atol=ATOL)
    np.testing.assert_allclose(arrays["dropless"], arrays["tp"], atol=ATOL)


def test_ep_with_drops_matches_jax(sides):
    """At the config's capacity factor 2.0 pairs drop on some rank, and the
    port's output equals the JAX package's on every token: the same pairs
    dropped (a token that lost a pair in one package only would differ by
    that expert's whole contribution)."""
    arrays, ranks = sides
    dropped = sum(r["drops_dropped"] for r in ranks)
    assert dropped > 0
    np.testing.assert_allclose(ranks[0]["drops"], arrays["drops"],
                               atol=ATOL)
    lost = np.abs(arrays["drops"] - arrays["tp"]).max(-1) > ATOL
    assert lost.any()          # the drops show against the dropless form


def test_ep_dropless_matches_the_tp_form(sides):
    _, ranks = sides
    np.testing.assert_allclose(ranks[0]["dropless"],
                               ranks[0]["tp"], atol=ATOL)


def test_ep_ranks_return_the_same_global_output(sides):
    _, ranks = sides
    for r in ranks[1:]:
        for name in CF:
            np.testing.assert_array_equal(r[name], ranks[0][name])


def test_ep_gradients_match_the_tp_form(sides):
    """Every rank ends with the whole gradient of x and of every leaf."""
    _, ranks = sides
    for r in ranks:
        for a, b in zip(r["grads_ep"], r["grads_tp"]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5)
    # the padded experts' gradients are zero in both forms
    assert not ranks[0]["grads_ep"][2][E:].any()


def test_all_to_all_moves_blocks_exactly(sides):
    """Rank m receives block m of every rank, in the senders' order."""
    _, ranks = sides
    for m, r in enumerate(ranks):
        want = torch.stack([torch.arange(3, dtype=torch.float32) + 3 * m
                            + 16 * j for j in range(4)])
        np.testing.assert_array_equal(r["a2a"], want.numpy())


def test_ep_on_a_data_and_model_mesh(sides):
    """A (2, 2) mesh: tokens over both axes, experts over the model axis;
    dropless output and gradients equal the TP form's."""
    arrays, _ = sides
    ranks = spawn_mesh(_rank_body, 2, 2, device="cpu", args=(arrays,),
                       timeout=120)
    for r in ranks:
        np.testing.assert_allclose(r["dropless"], r["tp"],
                                   atol=ATOL)
        for a, b in zip(r["grads_ep"], r["grads_tp"]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5)


def test_lm_with_a_mesh_routes_moe_through_ep():
    """``LM(cfg, mesh=…)`` with ``moe_impl == "ep"``: prefill takes no TP
    MoE call, and its logits, the loss and every gradient leaf equal the
    LM's without a mesh on every rank."""
    ranks = spawn_mesh(_lm_body, 1, 4, device="cpu", timeout=120)
    for r in ranks:
        assert r["tp_calls_ep"] == 0 and r["tp_calls_tp"] > 0
        np.testing.assert_allclose(r["logits_ep"],
                                   r["logits_tp"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["loss_ep"], r["loss_tp"], rtol=1e-5)
        for a, b in zip(r["grads_ep"], r["grads_tp"]):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-6)


def test_ep_refuses_shapes_the_mesh_does_not_split():
    from repro_torch.models import moe
    from repro_torch.parallel import moe_apply_ep

    mesh = Mesh(MeshAxis("data", 1, 0), MeshAxis("model", 4, 0),
                torch.device("cpu"))
    p = moe.moe_init(torch.Generator().manual_seed(0), D, F, E, 0, 0,
                     torch.float32)
    with pytest.raises(ValueError, match="S % 4 == 0"):
        moe_apply_ep(p, torch.zeros((2, 6, D)), experts_per_token=K,
                     mesh=mesh)
    with pytest.raises(ValueError, match="leading axis"):
        MeshAxis("model", 4, 0).all_to_all(torch.zeros((6, 2)))
