"""The port's VLM (llama-3.2-vision-11b: cross-attention to image
embeddings every 5th layer) against the JAX package's, on the CPU.

The reduced config (float32, one super-block of 5 layers — self-attention
in all five, cross-attention in the fifth —, d_model 128, 4 heads over 2
KV heads, head dim 32, vocab 512, 16 image tokens) is built in both
packages; the JAX ``LM.init_params(PRNGKey)`` weights, ``xnorm`` and
``xattn`` among them, are carried across by ``convert.params_from_jax``,
and numpy-seeded tokens and image embeddings go through both.

Tolerances: ``ATOL``/``RTOL`` 1e-4 on logits of magnitude ~1–4, as
``tests/test_torch_lm.py`` holds the dense archs (float32 sums in another
order, ~1e-6 relative a layer); the loss and gradients at ``GRAD_RTOL`` /
``GRAD_ATOL`` as ``tests/test_torch_lm_train.py``.  The cross-attention
runs non-causal over all image tokens, with its keys and values recomputed
from the image embeddings in every decode step (no cache), in both
packages.  In bfloat16 the port casts ``image_embeds`` to the model's type
at its entry (the attention kernel takes q, k, v of one type), where the
JAX package lets float32 embeddings promote the cross K/V to float32: the
cast's outputs equal the pre-cast call's bit for bit, lie within
``BF16_RTOL``/``BF16_ATOL`` of the JAX package's fed the bf16 embeddings,
and are no further from the float32 logits than the JAX package's promoted
path plus two bf16 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import build as jax_build
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve, train
from repro_torch.launch.serve import place_prefill
from repro_torch.models import build, cache_from_jax, params_from_jax
from repro_torch.models.lm import tree_map

ARCH = "llama-3.2-vision-11b"
ATOL = RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# two bf16 ulps at [2, 4) and one relative, as tests/test_torch_lm.py
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 0.0625


def _pair(seed, **changes):
    cfg_j = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **changes)
    cfg_t = dataclasses.replace(ARCHS[ARCH].reduced(), **changes)
    mj = jax_build(cfg_j)
    pj = mj.init_params(jax.random.PRNGKey(seed))
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    return mj, pj, build(cfg_t, device="cpu"), pt


def _inputs(cfg, B, S, seed):
    """Tokens (B, S) and image embeddings (B, image_tokens, d_model)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S))
    img = rng.normal(size=(B, cfg.image_tokens, cfg.d_model)).astype(
        np.float32)
    return tok, img


def _jb(tok, img):
    return {"tokens": jnp.asarray(tok, jnp.int32),
            "image_embeds": jnp.asarray(img)}


def _tb(tok, img):
    return {"tokens": torch.from_numpy(tok),
            "image_embeds": torch.from_numpy(img)}


def _np(x):
    return np.asarray(x, np.float32)


def _cmp_caches(ct, cj, **tol):
    cj = cache_from_jax(jax.device_get(cj), device="cpu")
    assert ct.keys() == cj.keys()
    for j in cj:
        assert ct[j].keys() == cj[j].keys() == {"k", "v"}, j
        for n in cj[j]:
            assert ct[j][n].shape == cj[j][n].shape, (j, n)
            np.testing.assert_allclose(ct[j][n].float().numpy(),
                                       cj[j][n].float().numpy(),
                                       err_msg=f"{j}.{n}", **tol)


def test_config_and_layer_pattern():
    """One super-block of 5 sublayers, cross-attention on the fifth (40
    layers: 8 blocks, 8 cross layers at full size)."""
    m = build(ARCHS[ARCH].reduced(), device="cpu")
    assert (m.period, m.nblocks) == (5, 1)
    assert [m.cfg.is_cross_attn_layer(j) for j in range(5)] == [
        False, False, False, False, True]
    full = ARCHS[ARCH]
    assert sum(full.is_cross_attn_layer(i)
               for i in range(full.num_layers)) == 8


def test_init_params_tree_has_the_jax_leaves():
    """The port's own weights carry exactly the JAX leaves, ``xnorm`` and
    ``xattn`` on the cross layer only, names, shapes and types; the
    analytic parameter count."""
    mj = jax_build(JAX_ARCHS[ARCH].reduced())
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        mj.abstract_params())
    m = build(ARCHS[ARCH].reduced(), device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert got == want
    assert "xattn" in p["blocks"]["l4"] and "xnorm" in p["blocks"]["l4"]
    assert all("xattn" not in p["blocks"][f"l{j}"] for j in range(4))
    assert sum(t.numel() for t in jax.tree.leaves(p)) == m.cfg.param_count()


def test_convert_carries_the_cross_leaves():
    """``params_from_jax`` carries every leaf of the JAX tree, ``xnorm``
    and ``xattn`` among them, bit for bit; ``cache_from_jax`` the prefill
    caches of the self-attention sublayers (the cross layers keep none)."""
    mj, pj, mt, pt = _pair(2)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(pj))[0]
    assert len(flat) == len(jax.tree.leaves(pt))
    for path, want in flat:
        got = pt
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    assert {"xnorm", "xattn"} <= set(pt["blocks"]["l4"])
    tok, img = _inputs(mt.cfg, 1, 4, 0)
    _, cj = mj.prefill(pj, _jb(tok, img))
    ct = cache_from_jax(jax.device_get(cj), device="cpu")
    assert set(ct) == {f"l{j}" for j in range(5)}
    assert all(set(c) == {"k", "v"} for c in ct.values())


def test_prefill_matches_jax():
    mj, pj, mt, pt = _pair(3)
    B, S = 2, 16
    tok, img = _inputs(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, _jb(tok, img))
    lt, ct = mt.prefill(pt, _tb(tok, img))
    assert lt.shape == (B, S, mt.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL, rtol=RTOL)
    _cmp_caches(ct, cj, atol=ATOL, rtol=RTOL)


def test_image_embeds_move_the_logits():
    """The cross layer reads the image: other embeddings, other logits."""
    _, _, mt, pt = _pair(3)
    tok, img = _inputs(mt.cfg, 2, 8, 4)
    a, _ = mt.prefill(pt, _tb(tok, img))
    b, _ = mt.prefill(pt, _tb(tok, img[::-1].copy()))
    assert not torch.allclose(a, b, atol=1e-3)


def test_decode_from_placed_caches_matches_jax():
    """Prefill 8 tokens, place the caches into a 16-slot decode cache, then
    decode 4 steps in both packages, the image embeddings fed to each."""
    mj, pj, mt, pt = _pair(5)
    B, S, half = 2, 12, 8
    tok, img = _inputs(mt.cfg, B, S, 6)
    _, prej = mj.prefill(pj, _jb(tok[:, :half], img))
    cache_j = jax.tree.map(
        lambda d, s: jax.lax.dynamic_update_slice(d, s, (0,) * d.ndim),
        mj.init_cache(B, 16), prej)
    _, pret = mt.prefill(pt, _tb(tok[:, :half], img))
    cache_t = mt.init_cache(B, 16)
    place_prefill(cache_t, pret)
    for t in range(half, S):
        lj, cache_j = mj.decode_step(pj, cache_j,
                                     _jb(tok[:, t:t + 1], img), jnp.int32(t))
        lt, cache_t = mt.decode_step(pt, cache_t,
                                     _tb(tok[:, t:t + 1], img), t)
        assert lt.shape == (B, 1, mt.cfg.vocab_size)
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL,
                                   rtol=RTOL)
    _cmp_caches(cache_t, cache_j, atol=ATOL, rtol=RTOL)


def test_prefill_then_decode_matches_full_forward():
    """tests/test_models_smoke.py:61 for the VLM: half the prompt, then
    decode of the rest, equals the full forward — in the port, and its
    decode logits equal the JAX package's decode from the same caches."""
    mj, pj, mt, pt = _pair(3)
    B, S = 2, 16
    tok, img = _inputs(mt.cfg, B, S, 4)
    full, _ = mt.prefill(pt, _tb(tok, img))
    half = S // 2
    _, pre = mt.prefill(pt, _tb(tok[:, :half], img))
    cache = mt.init_cache(B, S)
    place_prefill(cache, pre)
    _, prej = mj.prefill(pj, _jb(tok[:, :half], img))
    cache_j = jax.tree.map(
        lambda d, s: jax.lax.dynamic_update_slice(d, s, (0,) * d.ndim),
        mj.init_cache(B, S), prej)
    outs, outs_j = [], []
    for t in range(half, S):
        lg, cache = mt.decode_step(pt, cache, _tb(tok[:, t:t + 1], img), t)
        lj, cache_j = mj.decode_step(pj, cache_j,
                                     _jb(tok[:, t:t + 1], img), jnp.int32(t))
        outs.append(lg)
        outs_j.append(_np(lj))
    dec = torch.cat(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full[:, half:].numpy(),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(dec.argmax(-1), full[:, half:].argmax(-1))
    np.testing.assert_allclose(dec.numpy(), np.concatenate(outs_j, 1),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [64, 1024])
def test_loss_and_gradients_match_jax(S):
    """``loss_fn`` and every gradient leaf (``xattn`` and ``xnorm``
    among them) against ``jax.value_and_grad(LM.loss_fn)``; S = 1,024 is
    two CE chunks."""
    mj, pj, mt, pt = _pair(1)
    tok, img = _inputs(mt.cfg, 2, S + 1, 2)
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "labels": tok[:, 1:].astype(np.int32), "image_embeds": img}
    lj, gj = jax.value_and_grad(mj.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    tree_map(lambda t: t.requires_grad_(), pt)
    lt = mt.loss_fn(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    leaves = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert any("xattn" in jax.tree_util.keystr(p) for p, _ in leaves)
    for path, g in leaves:
        t = pt
        for key in path:
            t = t[key.key]
        assert t.grad is not None and torch.isfinite(t.grad).all(), path
        np.testing.assert_allclose(t.grad.numpy(), _np(g), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(path))


def _jax_serve_lm_body(model, params, cfg, B, prompt_len, gen):
    """The body of the JAX package's ``launch.serve.serve_lm`` with injected
    parameters, the VLM's image embeddings of ones × 0.01 included."""
    batch = {"tokens": jnp.ones((B, prompt_len), jnp.int32),
             "image_embeds": jnp.ones((B, cfg.image_tokens, cfg.d_model),
                                      jnp.float32) * 0.01}
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
        b = {"tokens": tok, "image_embeds": batch["image_embeds"]}
        lg, cache = model.decode_step(params, cache, b, pos)
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
    got, seconds = serve.generate(mt, pt, B, prompt_len, gen)
    want = _jax_serve_lm_body(mj, pj, mj.cfg, B, prompt_len, gen)
    assert got.shape == (B, gen + 1) and got.dtype == np.int32
    assert seconds > 0
    np.testing.assert_array_equal(got, want)


def test_bf16_image_embeds_are_cast_at_the_entry():
    """A bf16 model fed float32 image embeddings computes with them cast to
    bf16 once, at its entry: the logits and caches equal bit for bit those
    of the same call fed the bf16 embeddings, and lie within the bf16
    tolerance of the JAX package's fed the same bf16 embeddings.  Fed the
    float32 ones, the JAX package promotes the cross K/V to float32; against
    the float32 logits of the same bf16 weights the port's error is at most
    that promoted path's plus two bf16 ulps (``BF16_ATOL``) a position."""
    mj, pj, mt, pt = _pair(3, dtype="bfloat16")
    B, S = 2, 16
    tok, img = _inputs(mt.cfg, B, S, 4)
    assert mt.image_embeds({"image_embeds": torch.from_numpy(img)}).dtype \
        == torch.bfloat16
    lt, ct = mt.prefill(pt, _tb(tok, img))
    img16 = torch.from_numpy(img).to(torch.bfloat16)
    lt2, ct2 = mt.prefill(pt, {"tokens": torch.from_numpy(tok),
                               "image_embeds": img16})
    assert lt.dtype == torch.bfloat16 and torch.equal(lt, lt2)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             ct, ct2)
    got = lt.float().numpy()
    lj16, _ = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32),
                              "image_embeds": jnp.asarray(img16.float()
                                                          .numpy(),
                                                          jnp.bfloat16)})
    np.testing.assert_allclose(got, _np(lj16), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    lj, _ = mj.prefill(pj, _jb(tok, img))          # promoted cross K/V
    m32 = build(dataclasses.replace(mt.cfg, dtype="float32"), device="cpu")
    truth = m32.prefill(tree_map(lambda t: t.float(), pt),
                        _tb(tok, img))[0].numpy()
    err_port = np.abs(got - truth).max(-1)
    err_jax = np.abs(_np(lj) - truth).max(-1)
    assert np.all(err_port <= err_jax + BF16_ATOL), (err_port, err_jax)


def test_train_lm_runs_two_steps(tmp_path):
    """``train --arch llama-3.2-vision-11b``: the batches carry image
    embeddings of ones × 0.01, as the JAX ``train_lm`` builds them."""
    cfg = ARCHS[ARCH].reduced()
    b = train.lm_batch(cfg, {"tokens": torch.zeros((2, 8), dtype=torch.int32),
                             "labels": torch.zeros((2, 8), dtype=torch.int32)})
    assert b["image_embeds"].shape == (2, cfg.image_tokens, cfg.d_model)
    assert torch.all(b["image_embeds"] == torch.tensor(0.01))
    losses = train.main(["--arch", ARCH, "--workdir", str(tmp_path / "v"),
                         "--steps", "2", "--ckpt-every", "0",
                         "--minibatch", "2", "--seq-len", "32",
                         "--device", "cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
