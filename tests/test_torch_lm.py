"""The port's dense decoder LM (serving path, and the training backbone) vs
the JAX package's, on the CPU.

For ``granite-8b`` and ``h2o-danube-3-4b`` ``.reduced()`` (float32, 4
layers, d_model 128, 4 heads over 2 KV heads, head dim 32, vocab 512;
danube with its 32-key window), the JAX ``LM.init_params(PRNGKey)`` tree is
carried across as numpy by ``convert.params_from_jax``, so both packages
compute with the same weights, and numpy-seeded tokens go through both.

Tolerances: atol/rtol 1e-4 on logits of magnitude ~1–4 (the JAX test's
own continuity tolerance is 2e-2): float32 throughout, four layers of sums
taken in another order (XLA's and PyTorch's matrix products, one softmax
against the TPU kernel's online form) drift by ~1e-6 relative a layer;
1e-5 for single layers.

In bfloat16 (both packages, the same bf16 weights) the prefill logits and
caches agree within two bf16 ulps (``BF16_RTOL``/``BF16_ATOL``, with their
reason), and greedy tokens wherever the top-2 gap is wider.

Ports of ``tests/test_models_smoke.py``'s prefill-then-decode continuity
(:61), ring-cache decode (:99) and chunked-vs-unchunked attention (:182)
run within the port and against the JAX side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import build as jax_build
from repro.models import layers as jax_layers
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, list_archs
from repro_torch.models import LM, build, layers, params_from_jax

ATOL = RTOL = 1e-4
DENSE = ["granite-8b", "h2o-danube-3-4b"]


def _pair(name, seed, **changes):
    """The JAX and port models of ``name``'s reduced config, and the JAX
    weights in both packages."""
    cfg_j = dataclasses.replace(JAX_ARCHS[name].reduced(), **changes)
    cfg_t = dataclasses.replace(ARCHS[name].reduced(), **changes)
    mj = jax_build(cfg_j)
    pj = mj.init_params(jax.random.PRNGKey(seed))
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    return mj, pj, build(cfg_t, device="cpu"), pt


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _np(x):
    return np.asarray(x, np.float32)


def _put(cache, pre):
    """Prefill caches into a fixed-size decode cache (in place)."""
    for j in cache:
        for n in ("k", "v"):
            src = pre[j][n]
            cache[j][n][:, :, :, :src.shape[3]] = src


@pytest.mark.parametrize("name", ["granite-8b", "granite-20b",
                                  "internlm2-20b", "h2o-danube-3-4b"])
def test_port_configs_equal_the_jax_package(name):
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(
        JAX_ARCHS[name])
    assert dataclasses.asdict(ARCHS[name].reduced()) == dataclasses.asdict(
        JAX_ARCHS[name].reduced())
    assert ARCHS[name].param_count() == JAX_ARCHS[name].param_count()


def test_registry_lists_the_dense_archs():
    assert list_archs() == ["granite-20b", "granite-8b", "h2o-danube-3-4b",
                            "internlm2-20b"]
    assert all(ARCHS[n].family == "dense" for n in list_archs())


@pytest.mark.parametrize("name", sorted(set(JAX_ARCHS) - set(ARCHS)))
def test_non_dense_families_raise(name):
    cfg = ArchConfig(**dataclasses.asdict(JAX_ARCHS[name].reduced()))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        LM(cfg, device="cpu")


def test_training_mode_is_not_in_this_slice():
    """(The name predates the training slice, which now exists.)
    ``backbone(mode="train")`` keeps no caches and returns ``(hidden,
    None)``, the JAX package's train-mode hidden states within ATOL/RTOL;
    an unknown mode raises."""
    mj, pj, mt, pt = _pair("granite-8b", 0)
    x = np.random.default_rng(1).normal(
        size=(2, 12, mt.cfg.d_model)).astype(np.float32)
    hj, cj = mj.backbone(pj, jnp.asarray(x), positions=jnp.arange(12),
                         mode="train")
    ht, ct = mt.backbone(pt, torch.from_numpy(x), positions=torch.arange(12),
                         mode="train")
    assert cj is None and ct is None
    np.testing.assert_allclose(ht.numpy(), _np(hj), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="train, prefill or decode"):
        mt.backbone(pt, torch.from_numpy(x), positions=torch.arange(12),
                    mode="score")


def test_init_params_tree_and_distributions():
    """The port's own weights: the JAX tree's names, shapes and types, the
    analytic parameter count, and the initialisers' scales."""
    cfg = ARCHS["granite-8b"].reduced()
    mj = jax_build(JAX_ARCHS["granite-8b"].reduced())
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        mj.abstract_params())
    m = build(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert got == want
    assert sum(t.numel() for t in jax.tree.leaves(p)) == cfg.param_count()
    assert float(p["embed"].std()) == pytest.approx(1.0, rel=0.02)
    wq = p["blocks"]["l0"]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.02)
    down = p["blocks"]["l0"]["mlp"]["down"]
    assert float(down.std()) == pytest.approx(cfg.d_ff ** -0.5, rel=0.02)
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    # blocks are drawn one by one: no two blocks alike
    assert not torch.equal(wq[0], wq[1])
    again = m.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(again["lm_head"], p["lm_head"])


def test_params_from_jax_keeps_bf16_bits():
    x = jax.random.normal(jax.random.PRNGKey(0), (5, 7), jnp.bfloat16)
    t = params_from_jax({"w": jax.device_get(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), _np(x))


@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_jax(name):
    mj, pj, mt, pt = _pair(name, 3)
    B, S = 2, 16
    tok = _tokens(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32)})
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    assert lt.shape == (B, S, mt.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL, rtol=RTOL)
    for j in cj:
        for n in ("k", "v"):
            assert ct[j][n].shape == cj[j][n].shape
            np.testing.assert_allclose(ct[j][n].numpy(), _np(cj[j][n]),
                                       atol=ATOL, rtol=RTOL)


# bf16 logits against the JAX package's, (rtol, atol): bf16 keeps 8
# significant bits, one ulp is 2^-7 relative (0.031 at |logit| in [4, 8));
# the two packages round layer outputs at other places (XLA fuses the
# elementwise work between matrix products, PyTorch rounds after each op),
# which moves a logit by one or two ulps over four layers: atol two ulps at
# [2, 4), rtol one ulp
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 0.0625


@pytest.mark.parametrize("name", DENSE)
def test_bf16_prefill_matches_jax(name):
    """The reduced LM in bfloat16 in both packages, the JAX weights carried
    across bit for bit: logits and caches of a 2 × 16-token prefill within
    the bf16 tolerance, and the greedy token equal wherever the JAX
    logits' top-2 gap exceeds it."""
    mj, pj, mt, pt = _pair(name, 3, dtype="bfloat16")
    B, S = 2, 16
    tok = _tokens(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32)})
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    assert lt.dtype == torch.bfloat16 and lj.dtype == jnp.bfloat16
    got, want = lt.float().numpy(), _np(lj)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
    for j in cj:
        for n in ("k", "v"):
            np.testing.assert_allclose(ct[j][n].float().numpy(),
                                       _np(cj[j][n]), atol=BF16_ATOL,
                                       rtol=BF16_RTOL)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > BF16_ATOL + BF16_RTOL * np.abs(
        top2[..., 1])
    assert clear.sum() >= clear.size // 2
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("name", DENSE)
def test_decode_from_placed_caches_matches_jax(name):
    """Prefill 8 tokens, place the caches into a 16-slot decode cache, then
    decode 4 steps in both packages."""
    mj, pj, mt, pt = _pair(name, 5)
    B, S, half = 2, 12, 8
    tok = _tokens(mt.cfg, B, S, 6)
    _, prej = mj.prefill(pj, {"tokens": jnp.asarray(tok[:, :half])})
    cache_j = mj.init_cache(B, 16)
    cache_j = jax.tree.map(
        lambda d, s: jax.lax.dynamic_update_slice(d, s, (0,) * d.ndim),
        cache_j, prej)
    _, pret = mt.prefill(pt, {"tokens": torch.from_numpy(tok[:, :half])})
    cache_t = mt.init_cache(B, 16)
    _put(cache_t, pret)
    for t in range(half, S):
        lj, cache_j = mj.decode_step(
            pj, cache_j, {"tokens": jnp.asarray(tok[:, t:t + 1])},
            jnp.int32(t))
        lt, cache_t = mt.decode_step(
            pt, cache_t, {"tokens": torch.from_numpy(tok[:, t:t + 1])}, t)
        assert lt.shape == (B, 1, mt.cfg.vocab_size)
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(cache_t["l0"]["k"].numpy(),
                               _np(cache_j["l0"]["k"]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_matches_full_forward(name):
    """tests/test_models_smoke.py:61 in the port: decode with caches
    continues the prefill distribution, and the greedy tokens agree."""
    _, _, mt, pt = _pair(name, 3)
    B, S = 2, 16
    tok = torch.from_numpy(_tokens(mt.cfg, B, S, 4))
    full, _ = mt.prefill(pt, {"tokens": tok})
    half = S // 2
    _, pre = mt.prefill(pt, {"tokens": tok[:, :half]})
    cache = mt.init_cache(B, S)
    _put(cache, pre)
    outs = []
    for t in range(half, S):
        lg, cache = mt.decode_step(pt, cache, {"tokens": tok[:, t:t + 1]}, t)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full[:, half:].numpy(),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(dec.argmax(-1), full[:, half:].argmax(-1))


def test_swa_ring_cache_decode_matches_full_forward():
    """tests/test_models_smoke.py:99 in the port: sliding-window decode
    with a window-sized RING cache, from position 0 past two wraps, equals
    the full forward pass — the port's own and the JAX package's ring
    decode."""
    mj, pj, mt, pt = _pair("h2o-danube-3-4b", 5, sliding_window=8,
                           num_layers=2)
    B, S = 2, 24
    tok = _tokens(mt.cfg, B, S, 6)
    full, _ = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    cache = mt.init_cache(B, S)
    assert cache["l0"]["k"].shape[3] == 8                # window-sized
    cache_j = mj.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, cache = mt.decode_step(
            pt, cache, {"tokens": torch.from_numpy(tok[:, t:t + 1])}, t)
        lj, cache_j = mj.decode_step(
            pj, cache_j, {"tokens": jnp.asarray(tok[:, t:t + 1])},
            jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), _np(lj), atol=ATOL,
                                   rtol=RTOL)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_chunked_attention_equals_unchunked():
    """tests/test_models_smoke.py:182 in the port, and both against the
    JAX package's attention_apply with the same weights."""
    rng = np.random.default_rng(0)
    B, S, D, H, KV, hd = 2, 64, 32, 4, 2, 8
    pj = jax_layers.attention_init(jax.random.PRNGKey(0), D, H, KV, hd,
                                   jnp.float32)
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(num_heads=H, num_kv=KV, hd=hd, causal=True, rope_theta=1e4)
    o1, _ = layers.attention_apply(pt, torch.from_numpy(x), None,
                                   positions=torch.arange(S), q_chunk=16,
                                   **kw)
    o2, _ = layers.attention_apply(pt, torch.from_numpy(x), None,
                                   positions=torch.arange(S), q_chunk=S,
                                   **kw)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-5)
    oj, _ = jax_layers.attention_apply(pj, jnp.asarray(x), None,
                                       positions=jnp.arange(S), q_chunk=16,
                                       **kw)
    np.testing.assert_allclose(o2.numpy(), _np(oj), atol=1e-5)


def test_rmsnorm_rope_mlp_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        _np(jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=1e-5)
    for pos in (np.arange(5) + 7, np.arange(10).reshape(2, 5) * 3):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e4).numpy(),
            _np(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e4)),
            atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        layers.rope_frequencies(120, 1e4).numpy(),
        _np(jax_layers.rope_frequencies(120, 1e4)), rtol=1e-6)
    pj = jax_layers.mlp_init(jax.random.PRNGKey(2), 32, 64, jnp.float32)
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    np.testing.assert_allclose(
        layers.mlp_apply(pt, torch.from_numpy(x)).numpy(),
        _np(jax_layers.mlp_apply(pj, jnp.asarray(x))), atol=1e-5, rtol=1e-5)
