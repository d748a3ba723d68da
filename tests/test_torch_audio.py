"""The port's audio LM (musicgen-medium: a decoder over precomputed frame
embeddings, no token embedding) against the JAX package's, on the CPU.

The reduced config (float32, 4 layers, d_model 128, 4 heads over 2 KV
heads, head dim 32, vocab 512 — one EnCodec codebook's logits) is built in
both packages; the JAX ``LM.init_params(PRNGKey)`` weights (no ``embed``
leaf) are carried across by ``convert.params_from_jax``, and numpy-seeded
frame embeddings (B, S, d_model) go through both, ``batch["embeds"]`` in
place of ``batch["tokens"]``, cast to the model's type at the entry in both
packages.  Decode feeds one frame a step, the JAX smoke test's
``embeds[:, t:t + 1]`` slicing (``tests/test_models_smoke.py:63-95``).

Tolerances as ``tests/test_torch_lm.py`` and ``tests/test_torch_lm_train.py``
hold the dense archs: ``ATOL``/``RTOL`` 1e-4 on logits, ``GRAD_RTOL`` /
``GRAD_ATOL`` on the loss and gradients (float32 sums in another order),
two bf16 ulps (``BF16_RTOL``/``BF16_ATOL``) in bfloat16.  Training batches
are the JAX ``train_lm``'s: ``embeds`` = one_hot(tokens mod d_model) in
float32, ``tokens`` dropped.  The serve CLI, like the JAX package's, has no
frame feed: ``serve --arch musicgen-medium`` exits with a message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import build as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro_torch.configs.registry import ARCHS
from repro_torch.data.synthetic import synthetic_token_stream
from repro_torch.launch import serve, train
from repro_torch.launch.serve import place_prefill
from repro_torch.models import build, cache_from_jax, params_from_jax
from repro_torch.models.lm import tree_map
from repro_torch.optim import adamw_init

ARCH = "musicgen-medium"
ATOL = RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 0.0625


def _pair(seed, **changes):
    cfg_j = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), **changes)
    cfg_t = dataclasses.replace(ARCHS[ARCH].reduced(), **changes)
    mj = jax_build(cfg_j)
    pj = mj.init_params(jax.random.PRNGKey(seed))
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    return mj, pj, build(cfg_t, device="cpu"), pt


def _frames(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


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
        assert ct[j].keys() == cj[j].keys() == {"k", "v"}, j
        for n in cj[j]:
            assert ct[j][n].shape == cj[j][n].shape, (j, n)
            np.testing.assert_allclose(ct[j][n].float().numpy(),
                                       cj[j][n].float().numpy(),
                                       err_msg=f"{j}.{n}", **tol)


def test_init_params_tree_has_no_embedding():
    """The port's own weights carry exactly the JAX leaves — no ``embed``
    — names, shapes and types; the JAX tree comes across through
    ``params_from_jax`` as it is."""
    mj = jax_build(JAX_ARCHS[ARCH].reduced())
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        mj.abstract_params())
    m = build(ARCHS[ARCH].reduced(), device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert got == want and "embed" not in p
    _, pj, _, pt = _pair(0)
    assert set(pt) == set(pj) == {"blocks", "final_norm", "lm_head"}
    assert m.cfg.num_kv_heads == m.cfg.num_heads // 2     # reduced: 4 / 2
    assert ARCHS[ARCH].num_kv_heads == ARCHS[ARCH].num_heads  # MHA, G = 1


def test_embed_inputs_cast_the_frames():
    m = build(dataclasses.replace(ARCHS[ARCH].reduced(), dtype="bfloat16"),
              device="cpu")
    x = torch.from_numpy(_frames(m.cfg, 2, 3, 0))
    got = m.embed_inputs({}, {"embeds": x})
    assert got.dtype == torch.bfloat16 and torch.equal(got,
                                                       x.to(torch.bfloat16))


def test_prefill_matches_jax():
    mj, pj, mt, pt = _pair(3)
    B, S = 2, 16
    e = _frames(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"embeds": jnp.asarray(e)})
    lt, ct = mt.prefill(pt, {"embeds": torch.from_numpy(e)})
    assert lt.shape == (B, S, mt.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL, rtol=RTOL)
    _cmp_caches(ct, cj, atol=ATOL, rtol=RTOL)


def test_bf16_prefill_matches_jax():
    """Both packages in bfloat16, the same bf16 weights and the float32
    frames cast at the entry in both: logits and caches within two bf16
    ulps."""
    mj, pj, mt, pt = _pair(3, dtype="bfloat16")
    e = _frames(mt.cfg, 2, 16, 4)
    lj, cj = mj.prefill(pj, {"embeds": jnp.asarray(e)})
    lt, ct = mt.prefill(pt, {"embeds": torch.from_numpy(e)})
    assert lt.dtype == torch.bfloat16
    np.testing.assert_allclose(lt.float().numpy(), _np(lj), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    _cmp_caches(ct, cj, atol=BF16_ATOL, rtol=BF16_RTOL)


def test_decode_from_placed_caches_matches_jax():
    """Prefill 8 frames, place the caches into a 16-slot decode cache, then
    decode 4 steps of one frame each in both packages."""
    mj, pj, mt, pt = _pair(5)
    B, S, half = 2, 12, 8
    e = _frames(mt.cfg, B, S, 6)
    _, prej = mj.prefill(pj, {"embeds": jnp.asarray(e[:, :half])})
    cache_j = _jput(mj.init_cache(B, 16), prej)
    _, pret = mt.prefill(pt, {"embeds": torch.from_numpy(e[:, :half])})
    cache_t = mt.init_cache(B, 16)
    place_prefill(cache_t, pret)
    for t in range(half, S):
        lj, cache_j = mj.decode_step(
            pj, cache_j, {"embeds": jnp.asarray(e[:, t:t + 1])},
            jnp.int32(t))
        lt, cache_t = mt.decode_step(
            pt, cache_t, {"embeds": torch.from_numpy(e[:, t:t + 1])}, t)
        assert lt.shape == (B, 1, mt.cfg.vocab_size)
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL,
                                   rtol=RTOL)
    _cmp_caches(cache_t, cache_j, atol=ATOL, rtol=RTOL)


def test_prefill_then_decode_matches_full_forward():
    """tests/test_models_smoke.py:61 for the audio LM, frames sliced as the
    JAX test slices ``embeds``: half the frames, then one frame a decode
    step, equals the full forward — in the port, and the JAX package's
    decode from the same caches."""
    mj, pj, mt, pt = _pair(3)
    B, S = 2, 16
    e = _frames(mt.cfg, B, S, 4)
    full, _ = mt.prefill(pt, {"embeds": torch.from_numpy(e)})
    half = S // 2
    _, pre = mt.prefill(pt, {"embeds": torch.from_numpy(e[:, :half])})
    cache = mt.init_cache(B, S)
    place_prefill(cache, pre)
    _, prej = mj.prefill(pj, {"embeds": jnp.asarray(e[:, :half])})
    cache_j = _jput(mj.init_cache(B, S), prej)
    outs, outs_j = [], []
    for t in range(half, S):
        lg, cache = mt.decode_step(
            pt, cache, {"embeds": torch.from_numpy(e[:, t:t + 1])}, t)
        lj, cache_j = mj.decode_step(
            pj, cache_j, {"embeds": jnp.asarray(e[:, t:t + 1])},
            jnp.int32(t))
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
    """``loss_fn`` on a batch of ``embeds`` and ``labels`` (no ``tokens``:
    B and S come from the frames) and every gradient leaf against
    ``jax.value_and_grad(LM.loss_fn)``; S = 1,024 is two CE chunks."""
    mj, pj, mt, pt = _pair(1)
    rng = np.random.default_rng(2)
    batch = {"embeds": _frames(mt.cfg, 2, S, 2),
             "labels": rng.integers(0, mt.cfg.vocab_size,
                                    (2, S)).astype(np.int32)}
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


def test_train_steps_match_the_jax_loop():
    """Three ``lm_train_step``s on ``train.lm_batch``'s one-hot frames
    against the JAX ``train_lm`` step (value_and_grad, cosine_warmup,
    adamw_update, jitted) on the JAX loop's own one-hot frames."""
    mj, pj, mt, pt = _pair(4)
    steps, d = 3, mt.cfg.d_model
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
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        bj["embeds"] = jax.nn.one_hot(bj.pop("tokens") % d, d,
                                      dtype=jnp.float32)
        bt = train.lm_batch(mt.cfg, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert set(bt) == {"embeds", "labels"}
        np.testing.assert_array_equal(bt["embeds"].numpy(),
                                      _np(bj["embeds"]))
        lj, pj, oj = jax_step(pj, oj, bj)
        lt, pt, ot = train.lm_train_step(mt, pt, ot, bt, total_steps=steps)
        np.testing.assert_allclose(float(lt), float(lj), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"step {i + 1}")


def test_train_lm_runs_two_steps(tmp_path):
    losses = train.main(["--arch", ARCH, "--workdir", str(tmp_path / "a"),
                         "--steps", "2", "--ckpt-every", "0",
                         "--minibatch", "2", "--seq-len", "32",
                         "--device", "cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_serve_cli_exits_with_its_message():
    """The LM reads frame embeddings and the CLI has no frame feed (nor has
    the JAX package's): the serve CLI exits saying so, and ``generate``
    refuses the model."""
    with pytest.raises(SystemExit, match="frame embeddings.*no frame feed"):
        serve.main(["--arch", ARCH, "--gen-tokens", "2", "--batch", "1",
                    "--device", "cpu"])
    _, _, mt, pt = _pair(0)
    with pytest.raises(ValueError, match="frame embeddings"):
        serve.generate(mt, pt, 1, 4, 2)
