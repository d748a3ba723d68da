"""The port's hybrid stack (jamba-1.5-large-398b: attention::Mamba2 1:7,
MoE on every second layer) against the JAX package's, on the CPU.

The reduced config (float32, one super-block of 8 sublayers — attention at
j = 4, Mamba2 elsewhere; MoE on odd j, an MLP on even j —, d_model 128, 4
heads over 2 KV heads, head dim 32, vocab 512; 4 experts padded to 16,
top-2; 8 SSM heads of 32, state 16, chunk 16) is built in both packages;
the JAX ``LM.init_params(PRNGKey)`` weights are carried across by
``convert.params_from_jax`` and the JAX caches by ``cache_from_jax``, and
numpy-seeded tokens go through both.  A block's caches mix K/V (j = 4) and
SSM state and conv tail (the other seven): the trees' structure matches the
JAX package's, and decode writes both kinds in place.  The config's
``moe_impl="ep"`` takes the TP form without a mesh, as in the JAX package.

Tolerances as ``tests/test_torch_lm.py`` and ``tests/test_torch_lm_train.py``
hold the MoE and SSM archs (float32 sums in another order): ``ATOL`` /
``RTOL`` 1e-4 on logits and caches, ``GRAD_RTOL``/``GRAD_ATOL`` on the loss
and gradients.  A float32 routing near-tie (a token's k-th and (k+1)-th
probabilities within ``NEAR_TIE``) may pick another expert in the other
package and move that token by O(1): the serving tests assert none is that
close, the training tests that they stay rare (one decision in ``RARE``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import build as jax_build
from repro.models.ssm import SSMCache
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro_torch.configs.registry import ARCHS
from repro_torch.data.synthetic import synthetic_token_stream
from repro_torch.launch import serve, train
from repro_torch.launch.serve import place_prefill
from repro_torch.models import build, cache_from_jax, moe, params_from_jax
from repro_torch.models.lm import tree_map
from repro_torch.optim import adamw_init
from repro_torch.parallel import moe_ep

ARCH = "jamba-1.5-large-398b"
ATOL = RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
NEAR_TIE, RARE = 1e-6, 500


@pytest.fixture
def route_gaps(monkeypatch):
    """Each ``moe.route`` call's per-token routing gaps in the port."""
    gaps = []
    real = moe.route

    def recording(router, xt, k, norm=True):
        with torch.no_grad():
            top = torch.softmax(xt.float() @ router, dim=-1).topk(
                k + 1, dim=-1).values
        gaps.append((top[:, k - 1] - top[:, k]).numpy())
        return real(router, xt, k, norm)

    monkeypatch.setattr(moe, "route", recording)
    return gaps


def _no_near_tie(gaps):
    smallest = min((float(g.min()) for g in gaps), default=1.0)
    assert smallest > NEAR_TIE, f"a routing near-tie: smallest gap {smallest}"


def _pair(seed, **changes):
    cfg_j = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **changes)
    cfg_t = dataclasses.replace(ARCHS[ARCH].reduced(), **changes)
    mj = jax_build(cfg_j)
    pj = mj.init_params(jax.random.PRNGKey(seed))
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    return mj, pj, build(cfg_t, device="cpu"), pt


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _np(x):
    return np.asarray(x, np.float32)


def _jput(cache, pre):
    return jax.tree.map(
        lambda d, s: jax.lax.dynamic_update_slice(d, s.astype(d.dtype),
                                                  (0,) * d.ndim),
        cache, pre)


def _cmp_caches(ct, cj, **tol):
    cj = cache_from_jax(jax.device_get(cj), device="cpu")
    assert ct.keys() == cj.keys()
    for j in cj:
        assert ct[j].keys() == cj[j].keys(), j
        for n in cj[j]:
            assert ct[j][n].shape == cj[j][n].shape, (j, n)
            assert ct[j][n].dtype == cj[j][n].dtype, (j, n)
            np.testing.assert_allclose(ct[j][n].float().numpy(),
                                       cj[j][n].float().numpy(),
                                       err_msg=f"{j}.{n}", **tol)


def test_layer_pattern_and_init_params_tree():
    """One super-block of 8: attention at j = 4, Mamba2 elsewhere, MoE on
    odd j, an MLP on even j; the port's own weights carry exactly the JAX
    leaves (padded experts zero, float32 router, A_log, D, dt_bias)."""
    mj = jax_build(JAX_ARCHS[ARCH].reduced())
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        mj.abstract_params())
    m = build(ARCHS[ARCH].reduced(), device="cpu")
    assert (m.period, m.nblocks) == (8, 1)
    p = m.init_params(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert got == want
    for j in range(8):
        lp = p["blocks"][f"l{j}"]
        assert ("attn" in lp) == (j == 4) and ("mamba" in lp) == (j != 4)
        assert ("moe" in lp) == (j % 2 == 1) and ("mlp" in lp) == (j % 2 == 0)
        if j % 2:
            assert not lp["moe"]["w_gate"][:, m.cfg.num_experts:].any()


def test_cache_tree_matches_jax():
    """``init_cache``: one block's tree mixes K/V (j = 4) and SSM state and
    conv tail (the other sublayers), structure, shapes and types as the
    JAX package's (its ``SSMCache`` named tuples as dicts)."""
    mj, _, mt, _ = _pair(0)
    B, S = 2, 16
    cj = mj.init_cache(B, S)
    ct = mt.init_cache(B, S)
    want = cache_from_jax(jax.device_get(cj), device="cpu")
    assert isinstance(cj["l0"], SSMCache)
    assert jax.tree.structure(tree_map(lambda t: 0, ct)) == \
        jax.tree.structure(tree_map(lambda t: 0, want))
    assert {j: sorted(ct[j]) for j in ct} == {
        f"l{j}": (["k", "v"] if j == 4 else ["conv", "state"])
        for j in range(8)}
    for j in want:
        for n in want[j]:
            assert ct[j][n].shape == want[j][n].shape, (j, n)
            assert ct[j][n].dtype == want[j][n].dtype, (j, n)


def test_prefill_matches_jax(route_gaps):
    mj, pj, mt, pt = _pair(3)
    B, S = 2, 20                          # two SSD chunks, the second ragged
    tok = _tokens(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32)})
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    _no_near_tie(route_gaps)
    assert lt.shape == (B, S, mt.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL, rtol=RTOL)
    _cmp_caches(ct, cj, atol=ATOL, rtol=RTOL)


def test_decode_from_placed_caches_matches_jax(route_gaps):
    """Prefill 8 tokens, place the caches into a 16-slot decode cache, then
    decode 4 steps in both packages: logits and every cache leaf, K/V and
    SSM state written in place in the port."""
    mj, pj, mt, pt = _pair(5)
    B, S, half = 2, 12, 8
    tok = _tokens(mt.cfg, B, S, 6)
    _, prej = mj.prefill(pj, {"tokens": jnp.asarray(tok[:, :half])})
    cache_j = _jput(mj.init_cache(B, 16), prej)
    _, pret = mt.prefill(pt, {"tokens": torch.from_numpy(tok[:, :half])})
    cache_t = mt.init_cache(B, 16)
    place_prefill(cache_t, pret)
    leaves = {(j, n): t for j in cache_t for n, t in cache_t[j].items()}
    for t in range(half, S):
        lj, cache_j = mj.decode_step(
            pj, cache_j, {"tokens": jnp.asarray(tok[:, t:t + 1])},
            jnp.int32(t))
        lt, out = mt.decode_step(
            pt, cache_t, {"tokens": torch.from_numpy(tok[:, t:t + 1])}, t)
        assert all(out[j][n] is leaves[j, n] for j, n in leaves)
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL,
                                   rtol=RTOL)
    _no_near_tie(route_gaps)
    _cmp_caches(cache_t, cache_j, atol=ATOL, rtol=RTOL)


def test_prefill_then_decode_matches_full_forward(route_gaps):
    """tests/test_models_smoke.py:61 (jamba is one of its archs) in the
    port: decode from placed caches continues the prefill, and the greedy
    tokens agree."""
    _, _, mt, pt = _pair(3)
    B, S = 2, 16
    tok = torch.from_numpy(_tokens(mt.cfg, B, S, 4))
    full, _ = mt.prefill(pt, {"tokens": tok})
    half = S // 2
    _, pre = mt.prefill(pt, {"tokens": tok[:, :half]})
    cache = mt.init_cache(B, S)
    place_prefill(cache, pre)
    outs = []
    for t in range(half, S):
        lg, cache = mt.decode_step(pt, cache, {"tokens": tok[:, t:t + 1]}, t)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    _no_near_tie(route_gaps)
    np.testing.assert_allclose(dec.numpy(), full[:, half:].numpy(),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(dec.argmax(-1), full[:, half:].argmax(-1))


def test_ep_config_takes_the_tp_form_without_a_mesh(monkeypatch):
    """``moe_impl="ep"`` routes through ``moe_apply_ep`` only under a mesh;
    without one every MoE layer is the TP form."""
    assert ARCHS[ARCH].moe_impl == "ep"

    def refuse(*a, **kw):
        raise AssertionError("the EP form ran without a mesh")

    monkeypatch.setattr(moe_ep, "moe_apply_ep", refuse)
    _, _, mt, pt = _pair(0)
    tok = torch.from_numpy(_tokens(mt.cfg, 1, 8, 0))
    logits, _ = mt.prefill(pt, {"tokens": tok})
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("S", [64, 1024])
def test_loss_and_gradients_match_jax(S, route_gaps):
    """``loss_fn`` and every gradient leaf — attention, Mamba2 (A_log, D,
    dt_bias), MoE (padded experts zero, float32 router) and MLP — against
    ``jax.value_and_grad(LM.loss_fn)``; S = 1,024 is two CE chunks."""
    mj, pj, mt, pt = _pair(1)
    tok = _tokens(mt.cfg, 2, S + 1, 2).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    lj, gj = jax.value_and_grad(mj.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    tree_map(lambda t: t.requires_grad_(), pt)
    lt = mt.loss_fn(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        t = pt
        for key in path:
            t = t[key.key]
        assert t.grad is not None and torch.isfinite(t.grad).all(), path
        np.testing.assert_allclose(t.grad.numpy(), _np(g), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(path))
    gaps = np.concatenate(route_gaps)
    ties = np.flatnonzero(gaps < NEAR_TIE)
    assert ties.size <= max(1, gaps.size // RARE), gaps[ties]


def test_train_steps_match_the_jax_loop():
    """Three ``lm_train_step``s against the jitted JAX ``train_lm`` step on
    the same batches."""
    mj, pj, mt, pt = _pair(4)
    steps = 3
    stream = synthetic_token_stream(2, 32, mt.cfg.vocab_size, seed=7)

    @jax.jit
    def jax_step(params, opt, batch):
        loss, grads = jax.value_and_grad(mj.loss_fn)(params, batch)
        lr = jax_cosine_warmup(opt.count, peak_lr=1e-3, warmup=20,
                               total=steps)
        params, opt = jax_adamw_update(grads, opt, params, lr=lr)
        return loss, params, opt

    oj, ot = jax_adamw_init(pj), adamw_init(pt)
    tree_map(lambda t: t.requires_grad_(), pt)
    for i in range(steps):
        b = next(stream)
        lj, pj, oj = jax_step(pj, oj, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        lt, pt, ot = train.lm_train_step(
            mt, pt, ot, {k: torch.from_numpy(v) for k, v in b.items()},
            total_steps=steps)
        np.testing.assert_allclose(float(lt), float(lj), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"step {i + 1}")


def _jax_serve_lm_body(model, params, B, prompt_len, gen):
    """The body of the JAX package's ``launch.serve.serve_lm`` with injected
    parameters (its cache placement keeps a leaf whose rank differs)."""
    batch = {"tokens": jnp.ones((B, prompt_len), jnp.int32)}
    logits, pre_caches = model.prefill(params, batch)
    cache = model.init_cache(B, prompt_len + gen)
    cache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src.astype(dst.dtype), (0,) * dst.ndim
        ) if dst.ndim == src.ndim else dst,
        cache, pre_caches,
    )

    @jax.jit
    def step(params, cache, tok, pos):
        lg, cache = model.decode_step(params, cache, {"tokens": tok}, pos)
        nxt = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        return nxt[:, None], cache

    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for i in range(gen):
        tok, cache = step(params, cache, tok, jnp.int32(prompt_len + i))
        out.append(np.asarray(tok))
    return np.concatenate(out, 1)


def test_generate_matches_the_jax_serve_lm():
    mj, pj, mt, pt = _pair(6)
    B, prompt_len, gen = 3, 16, 12
    got, _ = serve.generate(mt, pt, B, prompt_len, gen)
    want = _jax_serve_lm_body(mj, pj, B, prompt_len, gen)
    np.testing.assert_array_equal(got, want)


def test_train_lm_runs_two_steps(tmp_path):
    losses = train.main(["--arch", ARCH, "--workdir", str(tmp_path / "j"),
                         "--steps", "2", "--ckpt-every", "0",
                         "--minibatch", "2", "--seq-len", "32",
                         "--device", "cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
