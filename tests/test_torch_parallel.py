"""The port's collectives, int8 compression and GPipe pipeline
(``repro_torch.parallel``) on 4 gloo ranks on the CPU, against the plain
all-reduce and gather, the sequential stages and the JAX package.

* Every collective over a 4-rank axis against ``MeshAxis.all_reduce`` or
  the plain gather (atol 1e-5: gloo's sum and the reduce-scatter's local
  sum add the same four float32 terms in other orders; the ring order and
  the all-to-all's blocks exactly).
* ``compress``/``decompress`` bit for bit the JAX package's on seeded
  inputs with a carried residual, a tail not a multiple of 256 included.
* ``compressed_psum`` over the 4 ranks for two steps, the error-feedback
  state carried: the sums within 1e-6 (absolute, and relative: the four
  terms of a sum up to ~20 added in gloo's order and in XLA's differ by an
  ulp) of JAX's ``compressed_psum`` under
  ``shard_map`` over 4 fake CPU devices (a subprocess, so that the
  device-count flag never reaches the rest of the suite), the states
  within 1e-6 or two ulps of the gradient's largest element (XLA's jitted
  quantisation differs from the eager one, which ``compress`` matches
  bitwise, by an ulp of x + e, and the residual carries it), and the
  sums within 2% of the exact sum (int8 at max|·|/127 a 256-tile: ~0.3%
  of an element's scale).
* The pipeline: S = 4 stages of ``tanh(x @ w)`` over M = 8 microbatches
  against the sequential stages and JAX's ``make_pipelined_apply`` (1e-5),
  and its gradients of Σ out·v — each stage's weights, and the input's on
  every rank — against the sequential form's.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS = 4
N = 1000                 # gradient elements a rank: 3 tiles and a tail of 232
STAGES, MICRO, DP, BP = 4, 8, 32, 16
ATOL = 1e-5
PIPE_TOL = 1e-5


def _jax_side(path):
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, numpy as np, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.parallel.compat import make_mesh, shard_map
        from repro.parallel.compression import EFState, compressed_psum
        from repro.parallel.pipeline import make_pipelined_apply
        rng = np.random.default_rng(0)
        out = {{}}
        mesh = make_mesh(({RANKS},), ("d",))
        def f(x, e):
            s, st = compressed_psum(x[0], "d", EFState(e[0]))
            return s[None], st.error[None]
        fm = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("d"), P("d")),
                               out_specs=(P("d"), P("d"))))
        e = np.zeros(({RANKS}, {N}), np.float32)
        for step in range(2):
            g = (rng.normal(size=({RANKS}, {N})) * (1 + 3 * step)).astype(
                np.float32)
            s, e = fm(g, e)
            out[f"g{{step}}"], out[f"sum{{step}}"] = g, np.asarray(s)
            out[f"err{{step}}"] = e = np.asarray(e)
        pmesh = make_mesh(({STAGES},), ("stage",))
        w = (rng.normal(size=({STAGES}, {DP}, {DP})) / np.sqrt({DP})).astype(
            np.float32)
        x = rng.normal(size=({BP}, {DP})).astype(np.float32)
        run = make_pipelined_apply(lambda p, h: jnp.tanh(h @ p), pmesh,
                                   num_stages={STAGES},
                                   num_microbatches={MICRO})
        out["w"], out["x"] = w, x
        out["pipe"] = np.asarray(jax.jit(run)(w, x))
        np.savez({str(path)!r}, **out)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(path))


def _rank_body(mesh, arrays):
    """Every check's values on one rank of a (1, 4) mesh; the model axis
    is the collectives' axis and the pipeline's stage axis."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import compression as Z
    from repro_torch.parallel import make_pipelined_apply

    axis, r = mesh.model, mesh.model.index
    out = {}
    gen = torch.Generator().manual_seed(100 + r)
    x = torch.randn((8, 6), generator=gen)
    (out["psum"],) = axis.all_reduce(x)
    out["x"] = x
    out["rs_ag"] = C.psum_scatter_then_gather(x, axis)
    out["rs"] = C.reduce_scatter(x, axis)
    out["ag"] = C.all_gather(x, axis)
    seen = []
    out["chunked"] = C.chunked_psum(x, axis, 4, between=seen.append)
    out["chunked_seen"] = list(seen)
    seen.clear()
    out["chunked_whole"] = C.chunked_psum(x, axis, 3, between=seen.append)
    out["chunked_whole_seen"] = list(seen)
    out["ring"] = C.ring_all_gather(x, axis, RANKS)
    for sa, ca in ((0, 0), (1, 0), (0, 1)):
        y = torch.randn((8, 12, 2), generator=gen)
        out[f"a2a_in_{sa}{ca}"] = y
        out[f"a2a_{sa}{ca}"] = C.all_to_all_tokens(
            y, axis, RANKS, split_axis=sa, concat_axis=ca)
    # a permute that leaves rank 0 without a source
    out["perm"] = C.ppermute(x, axis, [(0, 1), (1, 2), (2, 3)])

    state = Z.ef_init(torch.zeros(N))
    for step in range(2):
        g = torch.from_numpy(arrays[f"g{step}"][r].copy())
        out[f"sum{step}"], state = Z.compressed_psum(g, axis, state)
        out[f"err{step}"] = state.error

    w = torch.from_numpy(arrays["w"])
    xp = torch.from_numpy(arrays["x"])
    w_local = w[r:r + 1].clone().requires_grad_()
    xg = xp.clone().requires_grad_()
    run = make_pipelined_apply(lambda p, h: torch.tanh(h @ p), axis,
                               num_stages=STAGES, num_microbatches=MICRO)
    y = run(w_local, xg)
    v = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    (y * v).sum().backward()
    out["pipe"], out["pipe_v"] = y.detach(), v
    out["pipe_dw"], out["pipe_dx"] = w_local.grad[0], xg.grad
    return {k: (t.detach().numpy() if torch.is_tensor(t) else t)
            for k, t in out.items()}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    arrays = _jax_side(tmp_path_factory.mktemp("par") / "jax.npz")
    ranks = spawn_mesh(_rank_body, 1, RANKS, device="cpu", args=(arrays,),
                       timeout=120)
    return arrays, ranks


def test_reduce_scatter_then_gather_is_the_all_reduce(sides):
    _, ranks = sides
    xs = [r["x"] for r in ranks]
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["rs_ag"], r["psum"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["rs"], r["psum"][2 * i:2 * i + 2],
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(r["ag"], np.concatenate(xs, 0))
        np.testing.assert_allclose(r["psum"], np.sum(xs, 0), atol=ATOL)


def test_chunked_psum_calls_between_each_chunk(sides):
    _, ranks = sides
    for r in ranks:
        np.testing.assert_allclose(r["chunked"], r["psum"], atol=ATOL,
                                   rtol=0)
        assert r["chunked_seen"] == [0, 1, 2, 3]
        np.testing.assert_array_equal(r["chunked_whole"], r["psum"])
        assert r["chunked_whole_seen"] == []


def test_ring_all_gather_is_in_rank_order(sides):
    _, ranks = sides
    want = np.stack([r["x"] for r in ranks], 0)
    for r in ranks:
        np.testing.assert_array_equal(r["ring"], want)


@pytest.mark.parametrize("sa,ca", [(0, 0), (1, 0), (0, 1)])
def test_all_to_all_tokens_moves_the_blocks(sides, sa, ca):
    _, ranks = sides
    ins = [r[f"a2a_in_{sa}{ca}"] for r in ranks]
    for i, r in enumerate(ranks):
        want = np.concatenate([np.split(y, RANKS, axis=sa)[i] for y in ins],
                              axis=ca)
        np.testing.assert_array_equal(r[f"a2a_{sa}{ca}"], want)


def test_ppermute_sends_along_the_pairs(sides):
    _, ranks = sides
    np.testing.assert_array_equal(ranks[0]["perm"],
                                  np.zeros_like(ranks[0]["x"]))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(ranks[i]["perm"], ranks[i - 1]["x"])


def test_compress_is_bitwise_jax():
    import jax.numpy as jnp

    from repro.parallel import compression as jz
    from repro_torch.parallel import compression as z

    rng = np.random.default_rng(3)
    for shape in [(3, 1000), (256,), (7,), (2, 5, 300)]:
        x = (rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3)).astype(
            np.float32)
        err = (rng.normal(size=shape) * 1e-3).astype(np.float32)
        x[..., 0] = 0.0
        jc, js = jz.compress(jnp.asarray(x), jz.EFState(jnp.asarray(err)))
        tc, ts = z.compress(torch.from_numpy(x),
                            z.EFState(torch.from_numpy(err)))
        np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
        np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
        np.testing.assert_array_equal(ts.error.numpy(), np.asarray(js.error))
        np.testing.assert_array_equal(
            z.decompress(tc, shape).numpy(),
            np.asarray(jz.decompress(jc, shape)))
        assert tc.q.dtype == torch.int8 and tc.q.shape[1] == z.TILE
    zero = z.compress(torch.zeros(300), z.ef_init(torch.zeros(300)))[0]
    assert torch.all(zero.scale == 1e-12) and not zero.q.any()


def test_compressed_psum_matches_jax_over_two_steps(sides):
    arrays, ranks = sides
    for step in range(2):
        exact = arrays[f"g{step}"].astype(np.float64).sum(0)
        for i, r in enumerate(ranks):
            np.testing.assert_allclose(r[f"sum{step}"],
                                       arrays[f"sum{step}"][i], atol=1e-6,
                                       rtol=1e-6)
            # the residual x + e − q·scale is a float32 difference at x's
            # magnitude: two of its ulps
            ulp = np.spacing(np.abs(arrays[f"g{step}"][i]).max())
            np.testing.assert_allclose(r[f"err{step}"],
                                       arrays[f"err{step}"][i],
                                       atol=max(1e-6, 2 * ulp), rtol=0)
        rel = (np.linalg.norm(ranks[0][f"sum{step}"] - exact)
               / np.linalg.norm(exact))
        assert rel < 0.02, rel


def test_pipeline_matches_the_stages_and_jax(sides):
    arrays, ranks = sides
    w = torch.from_numpy(arrays["w"]).requires_grad_()
    x = torch.from_numpy(arrays["x"]).requires_grad_()
    h = x
    for s in range(STAGES):
        h = torch.tanh(h @ w[s])
    v = torch.from_numpy(ranks[0]["pipe_v"])
    (h * v).sum().backward()
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["pipe"], h.detach().numpy(),
                                   atol=PIPE_TOL, rtol=0)
        np.testing.assert_allclose(r["pipe"], arrays["pipe"],
                                   atol=PIPE_TOL, rtol=0)
        np.testing.assert_array_equal(r["pipe_v"], v.numpy())
        np.testing.assert_allclose(r["pipe_dw"], w.grad[i].numpy(),
                                   atol=PIPE_TOL, rtol=0)
        np.testing.assert_allclose(r["pipe_dx"], x.grad.numpy(),
                                   atol=PIPE_TOL, rtol=0)
