"""The port's dense LM training path and LM serve CLI against the JAX
package's, on the CPU.

The JAX ``LM.init_params(PRNGKey)`` weights of each dense arch's
``.reduced()`` config (float32, 4 layers, d_model 128, 4 heads over 2 KV
heads, head dim 32, vocab 512; danube with its 32-key window) are carried
across by ``convert.params_from_jax``; the tokens come from numpy seeds.

* ``synthetic_token_stream``: the first three batches bitwise the JAX
  package's for the same seed.
* ``loss_fn`` and every gradient leaf against ``jax.value_and_grad(
  LM.loss_fn)`` at S = 64 (one CE chunk) and S = 1,024 (two 512-position
  chunks, each recomputed in backward; the attention in two 512-row query
  chunks on both sides).  Tolerance ``RTOL``/``ATOL`` = 1e-4 / 1e-6:
  float32 throughout, four layers of matrix products and softmax sums
  taken in another order (XLA's and PyTorch's), ~1e-6 relative a layer.
* In bfloat16 (both packages, the same bf16 weights) the loss within
  ``BF16_LOSS_RTOL``.
* Five steps of ``train_lm``'s step (``launch.train.lm_train_step``: loss,
  ``backward``, ``cosine_warmup`` from the count before its increment,
  ``adamw_update``) from the carried weights against the same jitted step
  of the JAX ``train_lm`` loop on the same batches: every loss within
  ``RTOL``, step 1 at lr 0 leaving every parameter bitwise unchanged.
* ``serve.generate``'s greedy tokens equal to the JAX ``serve_lm`` body's
  on the same weights.
* ``ops.attention`` under autograd (on the CPU, autograd of the plain
  version) and ``FlashAttentionFunction`` (the card's route, its plain
  backward on the CPU) against ``jax.grad`` of the JAX ``attention_apply``,
  causal, with and without a window, chunked and whole.
* Five bfloat16 steps (both packages, the same bf16 weights) with the
  losses within ``BF16_LOSS_RTOL`` of the JAX loop's.
* The train CLI in LM mode: 12 steps with checkpoints, a resume from step
  10, and the LM example.

The MoE and SSM archs (``MOE_SSM``: qwen2-moe, qwen3-moe, mamba2 reduced,
float32) are held the same way: ``loss_fn`` and every gradient leaf —
the padded experts' (zero), the float32 router's, ``A_log``, ``D`` and
``dt_bias`` — at S = 64 and 1,024 within ``RTOL``/``ATOL``, with no NaN
through the SSD's masked segment sums; five ``lm_train_step``s against the
jitted JAX step; ``generate``'s greedy tokens against the JAX ``serve_lm``
body; and the two CLIs (``serve --arch qwen2-moe-a2.7b``, ``train --arch
mamba2-370m``).  A float32 routing near-tie (gap under ``NEAR_TIE``) may
pick another expert in the other package and move that token's loss by
O(1) (~1e-4 of the mean at S = 1,024): the MoE cases record the port's
routing gaps, report the near-tie tokens and assert that they stay rare,
at most one routing decision in ``RARE`` = 500.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.data.synthetic import synthetic_token_stream as jax_token_stream
from repro.models import build as jax_build
from repro.models import layers as jax_layers
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro_torch.configs.registry import ARCHS
from repro_torch.data.synthetic import synthetic_token_stream
from repro_torch.kernels.flash_attention import flash_attention_backward
from repro_torch.launch import serve, train
from repro_torch.models import build, layers, moe, params_from_jax
from repro_torch.models.lm import tree_map
from repro_torch.optim import adamw_init

RTOL, ATOL = 1e-4, 1e-6
# bf16 losses (rtol): both packages round every layer output to 8 bits at
# other places; the mean CE of ~6.3 moves by a few bf16 ulps of the
# per-token terms, well under 1e-2 relative
BF16_LOSS_RTOL = 1e-2
DENSE = ["granite-8b", "granite-20b", "internlm2-20b", "h2o-danube-3-4b"]
MOE_SSM = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-370m"]
NEAR_TIE, RARE = 1e-6, 500  # float32 routing gaps that may flip


@pytest.fixture
def route_gaps(monkeypatch):
    """The per-token routing gaps of every ``moe.route`` call in the
    port."""
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


def _pair(name, seed, **changes):
    cfg_j = dataclasses.replace(JAX_ARCHS[name].reduced(), **changes)
    cfg_t = dataclasses.replace(ARCHS[name].reduced(), **changes)
    mj = jax_build(cfg_j)
    pj = mj.init_params(jax.random.PRNGKey(seed))
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    return mj, pj, build(cfg_t, device="cpu"), pt


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _grads_like(pt):
    return tree_map(lambda t: t.requires_grad_(), pt)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("batch,seq,vocab,seed", [(2, 8, 512, 0),
                                                  (4, 64, 32000, 3)])
def test_token_stream_bitwise_the_jax_one(batch, seq, vocab, seed):
    ours = synthetic_token_stream(batch, seq, vocab, seed=seed)
    theirs = jax_token_stream(batch, seq, vocab, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("name", DENSE)
def test_loss_and_gradients_match_jax(name, S):
    _loss_and_gradients_match_jax(name, S)


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("name", MOE_SSM)
def test_moe_ssm_loss_and_gradients_match_jax(name, S, route_gaps):
    _loss_and_gradients_match_jax(name, S)
    if route_gaps:
        gaps = np.concatenate(route_gaps)
        ties = np.flatnonzero(gaps < NEAR_TIE)
        print(f"near-tie routing decisions: {ties.size} of {gaps.size}, "
              f"gaps {gaps[ties]}")
        assert ties.size <= max(1, gaps.size // RARE)


def _loss_and_gradients_match_jax(name, S):
    mj, pj, mt, pt = _pair(name, 1)
    batch = _batch(mt.cfg, 2, S, 2)
    lj, gj = jax.value_and_grad(mj.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    _grads_like(pt)
    lt = mt.loss_fn(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert lt.dtype == torch.float32 and lt.ndim == 0
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL, atol=ATOL)
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    for path, g in flat_j:
        t = pt
        for key in path:
            t = t[key.key]
        assert t.grad is not None, path
        assert torch.isfinite(t.grad).all(), path
        np.testing.assert_allclose(t.grad.numpy(), _np(g), rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


def test_bf16_loss_matches_jax():
    mj, pj, mt, pt = _pair("granite-8b", 1, dtype="bfloat16")
    batch = _batch(mt.cfg, 2, 64, 2)
    lj = mj.loss_fn(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt = mt.loss_fn(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(float(lt), float(lj), rtol=BF16_LOSS_RTOL)


def test_backbone_train_mode_keeps_no_cache_and_chunks_need_whole_seq():
    _, _, mt, pt = _pair("granite-8b", 0)
    x = torch.zeros((1, 4, mt.cfg.d_model))
    h, caches = mt.backbone(pt, x, positions=torch.arange(4), mode="train")
    assert caches is None and h.shape == x.shape
    batch = _batch(mt.cfg, 1, 1100, 0)     # two chunks, 1,100 % 512 != 0
    with pytest.raises(ValueError, match="multiple of the CE chunk"):
        mt.loss_fn(pt, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("name", ["granite-8b", "h2o-danube-3-4b",
                                  "qwen2-moe-a2.7b", "mamba2-370m"])
def test_train_steps_match_the_jax_loop(name):
    """Five steps of the port's ``lm_train_step`` against the JAX
    ``train_lm`` step (value_and_grad, cosine_warmup(opt.count, 1e-3, 20,
    total), adamw_update) under ``jax.jit``, on the same batches."""
    mj, pj, mt, pt = _pair(name, 4)
    steps = 5
    stream = synthetic_token_stream(4, 32, mt.cfg.vocab_size, seed=7)
    batches = [next(stream) for _ in range(steps)]

    @jax.jit
    def jax_step(params, opt, batch):
        loss, grads = jax.value_and_grad(mj.loss_fn)(params, batch)
        lr = jax_cosine_warmup(opt.count, peak_lr=1e-3, warmup=20,
                               total=steps)
        params, opt = jax_adamw_update(grads, opt, params, lr=lr)
        return loss, params, opt

    oj = jax_adamw_init(pj)
    ot = adamw_init(pt)
    _grads_like(pt)
    first = tree_map(lambda t: t.detach().clone(), pt)
    for i, b in enumerate(batches):
        lj, pj, oj = jax_step(pj, oj, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        lt, pt, ot = train.lm_train_step(
            mt, pt, ot, {k: torch.from_numpy(v) for k, v in b.items()},
            total_steps=steps)
        np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i + 1}")
        if i == 0:              # lr 0: the parameters keep their bits
            tree_map(lambda a, b: torch.testing.assert_close(
                a.detach(), b, rtol=0, atol=0), pt, first)
    assert int(ot.count) == int(oj.count) == steps
    assert all(t.grad is None for t in jax.tree.leaves(pt))


def test_bf16_train_steps_match_the_jax_loop():
    """Five bfloat16 steps of ``lm_train_step`` (bf16 weights, float32
    moments, the update rounded to bf16) against the jitted JAX step: every
    loss within BF16_LOSS_RTOL, step 1 at lr 0 bitwise."""
    mj, pj, mt, pt = _pair("granite-8b", 4, dtype="bfloat16")
    steps = 5
    stream = synthetic_token_stream(4, 32, mt.cfg.vocab_size, seed=7)

    @jax.jit
    def jax_step(params, opt, batch):
        loss, grads = jax.value_and_grad(mj.loss_fn)(params, batch)
        lr = jax_cosine_warmup(opt.count, peak_lr=1e-3, warmup=20,
                               total=steps)
        params, opt = jax_adamw_update(grads, opt, params, lr=lr)
        return loss, params, opt

    oj, ot = jax_adamw_init(pj), adamw_init(pt)
    _grads_like(pt)
    first = tree_map(lambda t: t.detach().clone(), pt)
    for i in range(steps):
        b = next(stream)
        lj, pj, oj = jax_step(pj, oj, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        lt, pt, ot = train.lm_train_step(
            mt, pt, ot, {k: torch.from_numpy(v) for k, v in b.items()},
            total_steps=steps)
        np.testing.assert_allclose(float(lt), float(lj),
                                   rtol=BF16_LOSS_RTOL,
                                   err_msg=f"step {i + 1}")
        if i == 0:
            tree_map(lambda a, b: torch.testing.assert_close(
                a.detach(), b, rtol=0, atol=0), pt, first)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(pt))


def _jax_serve_lm_body(model, params, B, prompt_len, gen):
    """The body of the JAX package's ``launch.serve.serve_lm`` with
    injected parameters."""
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


@pytest.mark.parametrize("name", ["granite-8b", "h2o-danube-3-4b"]
                         + MOE_SSM)
def test_generate_matches_the_jax_serve_lm(name):
    """Danube's 32-key ring wraps: 16 prompt tokens and 24 decode steps;
    mamba2's state and conv tail are placed whole."""
    mj, pj, mt, pt = _pair(name, 6)
    B, prompt_len, gen = 3, 16, 24
    got, seconds = serve.generate(mt, pt, B, prompt_len, gen)
    want = _jax_serve_lm_body(mj, pj, B, prompt_len, gen)
    assert got.shape == (B, gen + 1) and got.dtype == np.int32
    assert seconds > 0
    np.testing.assert_array_equal(got, want)


def _through_the_function(monkeypatch):
    """Route ops.attention through FlashAttentionFunction, as it is on the
    card under grad."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import FlashAttentionFunction

    monkeypatch.setattr(
        ops, "attention",
        lambda q, k, v, *, causal=True, window=0, q_offset=0:
        FlashAttentionFunction.apply(q, k, v, causal, window, q_offset))


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("q_chunk", [32, 96])
def test_attention_gradient_matches_jax_grad(window, q_chunk):
    """The port's attention_apply under autograd — on the CPU, autograd of
    the plain attention through ops.attention — against jax.grad of the JAX
    attention_apply with the same weights: d/d(x, wq, wk, wv, wo) of
    Σ o·w_out."""
    _attention_gradient_matches_jax_grad(window, q_chunk)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("q_chunk", [32, 96])
def test_function_gradient_matches_jax_grad(window, q_chunk, monkeypatch):
    """The same with ops.attention through FlashAttentionFunction (the
    card's route; its backward is the plain version's on the CPU)."""
    _through_the_function(monkeypatch)
    _attention_gradient_matches_jax_grad(window, q_chunk)


def _attention_gradient_matches_jax_grad(window, q_chunk):
    rng = np.random.default_rng(window + q_chunk)
    B, S, D, H, KV, hd = 2, 96, 32, 4, 2, 8
    pj = jax_layers.attention_init(jax.random.PRNGKey(1), D, H, KV, hd,
                                   jnp.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w_out = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(num_heads=H, num_kv=KV, hd=hd, causal=True, window=window,
              rope_theta=1e4, q_chunk=q_chunk)

    def f(p, x):
        o, _ = jax_layers.attention_apply(p, x, None,
                                          positions=jnp.arange(S), **kw)
        return jnp.sum(o * w_out)

    gpj, gxj = jax.grad(f, argnums=(0, 1))(pj, jnp.asarray(x))
    pt = _grads_like(params_from_jax(jax.device_get(pj), device="cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    o, _ = layers.attention_apply(pt, xt, None, positions=torch.arange(S),
                                  **kw)
    (o * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(gxj), rtol=RTOL,
                               atol=1e-5)
    for n in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(pt[n].grad.numpy(), _np(gpj[n]),
                                   rtol=RTOL, atol=1e-5, err_msg=n)


def test_backward_wrapper_on_the_cpu_is_the_plain_autograd():
    """``flash_attention_backward`` on CPU tensors: dk, dv summed over the
    G query heads of a KV head, and the gradient of Σ o·g."""
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFunction,
        flash_attention,
    )

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((n, 40, 16), generator=g) for n in (6, 2, 2))
    dout = torch.randn((6, 40, 16), generator=g)
    o, lse = flash_attention(q, k, v, causal=True, window=9,
                             return_lse=True)
    assert lse.shape == (6, 40) and lse.dtype == torch.float32
    dq, dk, dv = flash_attention_backward(q, k, v, o, dout, lse, causal=True,
                                          window=9)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttentionFunction.apply(*leaves, True, 9, 0).backward(dout)
    for got, leaf in zip((dq, dk, dv), leaves):
        assert torch.equal(got, leaf.grad)
    assert dk.shape == k.shape and dv.shape == v.shape


def test_lm_train_cli_resumes(tmp_path, capsys):
    wd = str(tmp_path / "lm")
    argv = ["--arch", "granite-8b", "--workdir", wd, "--steps", "12",
            "--ckpt-every", "5", "--minibatch", "8", "--seq-len", "32",
            "--device", "cpu"]
    losses = train.main(argv)
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    resumed = train.main(argv[:5] + ["14"] + argv[6:] + ["--resume"])
    out = capsys.readouterr().out
    assert "[resume] from step 10" in out
    assert len(resumed) == 4 and np.all(np.isfinite(resumed))


def test_lm_serve_cli(capsys):
    out = serve.main(["--arch", "granite-8b", "--gen-tokens", "4",
                      "--batch", "2", "--device", "cpu"])
    assert out is None
    line = capsys.readouterr().out
    assert "granite-8b: generated 4×2 tokens" in line and "tok/s" in line


def test_moe_serve_cli(capsys):
    serve.main(["--arch", "qwen2-moe-a2.7b", "--gen-tokens", "4",
                "--batch", "2", "--device", "cpu"])
    line = capsys.readouterr().out
    assert "qwen2-moe-a2.7b: generated 4×2 tokens" in line


def test_ssm_train_cli(tmp_path):
    losses = train.main(["--arch", "mamba2-370m", "--workdir",
                         str(tmp_path / "m"), "--steps", "6",
                         "--ckpt-every", "3", "--minibatch", "4",
                         "--seq-len", "32", "--device", "cpu"])
    assert len(losses) == 6 and np.all(np.isfinite(losses))


def test_lm_example_runs(tmp_path):
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parent.parent / "examples" / "torch"
            / "train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_example_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--quick", "--device", "cpu", "--workdir",
                       str(tmp_path / "ex")])
    assert len(losses) == 6 and np.all(np.isfinite(losses))
