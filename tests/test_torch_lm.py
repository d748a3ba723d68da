"""The port's decoder LM (serving path, and the training backbone) vs the
JAX package's, on the CPU: the dense archs, and (``MOE_SSM``) qwen2-moe,
qwen3-moe and mamba2.

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

The MoE and SSM archs' reduced configs (float32; qwen2-moe and qwen3-moe
with 4 experts padded to 16, top-2, qwen2 with one shared expert; mamba2
with 8 SSM heads of 32, state 16, chunk 16, no attention and no FFN) are
held the same way: prefill logits and caches (K/V, SSM state and conv
tail, through ``cache_from_jax``), decode from placed caches and greedy
continuity at ATOL/RTOL; mamba2's bf16 prefill at ``BF16_RTOL``/
``BF16_ATOL``, the MoE archs' bf16 prefill against the float32 logits by
the JAX package's own bf16 error (see ``BF16_TIE``).  A float32 routing
near-tie (a token's k-th and (k+1)-th probabilities within
``NEAR_TIE``, where float32 sums in another order may pick another expert)
would move a token's output by O(1): the MoE tests record the port's
routing gaps and assert that none is that close, so such a tie shows as
what it is and not as a mismatch of the logits.

The hybrid, VLM and audio configs (``NEW_FAMILIES``) equal the JAX
package's, and the registry lists every JAX arch.  Their reduced configs,
and three layer patterns no config of the registry has (a dense config
with experts, an MoE config with a Mamba2 interleave, an SSM with
experts), build in both packages with equal prefill logits and caches at
ATOL/RTOL; ``test_torch_hybrid.py``, ``test_torch_vlm.py`` and
``test_torch_audio.py`` hold the three archs in full.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import build as jax_build
from repro.models import layers as jax_layers
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, list_archs
from repro_torch.launch.serve import place_prefill
from repro_torch.models import LM, build, cache_from_jax, layers, moe
from repro_torch.models import params_from_jax
from repro_torch.models.lm import tree_map

ATOL = RTOL = 1e-4
DENSE = ["granite-8b", "h2o-danube-3-4b"]
MOE_SSM = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "mamba2-370m"]
# the hybrid, VLM and audio archs (tests/test_torch_hybrid.py,
# test_torch_vlm.py and test_torch_audio.py hold them in full)
NEW_FAMILIES = ["jamba-1.5-large-398b", "llama-3.2-vision-11b",
                "musicgen-medium"]
# routing gaps closer than this may flip between the packages in float32
# (a hundred times the float32 noise of a probability)
NEAR_TIE = 1e-6


@pytest.fixture
def route_gaps(monkeypatch):
    """Each ``moe.route`` call's per-token routing gaps (k-th minus
    (k+1)-th probability) in the port while the test runs."""
    gaps = []
    real = moe.route

    def recording(router, xt, k, norm=True):
        top = torch.softmax(xt.float() @ router, dim=-1).topk(
            k + 1, dim=-1).values
        gaps.append((top[:, k - 1] - top[:, k]).numpy())
        return real(router, xt, k, norm)

    monkeypatch.setattr(moe, "route", recording)
    return gaps


def _no_near_tie(gaps):
    smallest = min((float(g.min()) for g in gaps), default=1.0)
    assert smallest > NEAR_TIE, f"a routing near-tie: smallest gap {smallest}"


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


@pytest.mark.parametrize("name", ["granite-8b", "granite-20b",
                                  "internlm2-20b", "h2o-danube-3-4b"]
                         + MOE_SSM + NEW_FAMILIES)
def test_port_configs_equal_the_jax_package(name):
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(
        JAX_ARCHS[name])
    assert dataclasses.asdict(ARCHS[name].reduced()) == dataclasses.asdict(
        JAX_ARCHS[name].reduced())
    assert ARCHS[name].param_count() == JAX_ARCHS[name].param_count()


def test_registry_lists_the_dense_archs():
    """(The name predates the other families.)  The ten archs the port
    runs — every arch of the JAX package's registry — and their
    families."""
    assert {n: ARCHS[n].family for n in list_archs()} == {
        "granite-20b": "dense", "granite-8b": "dense",
        "h2o-danube-3-4b": "dense", "internlm2-20b": "dense",
        "mamba2-370m": "ssm", "qwen2-moe-a2.7b": "moe",
        "qwen3-moe-235b-a22b": "moe", "jamba-1.5-large-398b": "hybrid",
        "llama-3.2-vision-11b": "vlm", "musicgen-medium": "audio"}
    assert list_archs() == sorted(ARCHS) == sorted(JAX_ARCHS)


def _prefill_batches(cfg, B, S, seed):
    """The same numpy-seeded inputs for both packages: tokens (an audio
    config's frame embeddings), and a VLM's image embeddings."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_frames":
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    if cfg.frontend == "image_patches":
        out["image_embeds"] = rng.normal(
            size=(B, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
             for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _prefill_parity(cfg):
    """``cfg`` builds in both packages, and the port's prefill logits and
    caches (the JAX weights carried across) are the JAX package's within
    ATOL/RTOL."""
    mj = jax_build(_jax_cfg(cfg))
    pj = mj.init_params(jax.random.PRNGKey(3))
    mt = LM(cfg, device="cpu")
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    bj, bt = _prefill_batches(cfg, 2, 20, 4)
    lj, cj = mj.prefill(pj, bj)
    lt, ct = mt.prefill(pt, bt)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL, rtol=RTOL)
    _cmp_caches(ct, cj, atol=ATOL, rtol=RTOL)


def _jax_cfg(cfg):
    """The JAX package's ``ArchConfig`` of the same fields."""
    return JaxArchConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_non_dense_families_raise(name):
    """(The name predates the hybrid, VLM and audio slice, whose archs these
    cases refused.)  ``LM`` builds each of them, ``NotImplementedError``
    no more, and its reduced config's prefill logits and caches are the
    JAX package's."""
    cfg = ArchConfig(**dataclasses.asdict(JAX_ARCHS[name].reduced()))
    _prefill_parity(cfg)


@pytest.mark.parametrize("family,change", [
    ("dense", dict(num_experts=4)), ("moe", dict(attn_every=2)),
    ("ssm", dict(num_experts=4))])
def test_other_layer_patterns_raise(family, change):
    """(The name predates the slice that ported every layer pattern, whose
    configs these cases refused.)  A family in a layer pattern its configs
    do not have — a dense config with experts (top-0: the FFN adds zeros,
    as in the JAX package), a hybrid interleave of an MoE config (its SSM
    layers of state 0), experts in an SSM — builds in both packages, and
    the port's prefill logits and caches are the JAX package's."""
    name = {"dense": "granite-8b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-370m"}[family]
    _prefill_parity(dataclasses.replace(ARCHS[name].reduced(), **change))


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
    place_prefill(cache_t, pret)
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
    place_prefill(cache, pre)
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


# ---------------------------------------------------------------------------
# the MoE and SSM archs
# ---------------------------------------------------------------------------

def _jax_put(cache, pre):
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


@pytest.mark.parametrize("name", MOE_SSM)
def test_moe_ssm_init_params_tree(name):
    """The port's own weights carry exactly the JAX leaves (no ``norm2`` in
    mamba2's pure-SSM block; padded experts, float32 router, A_log, D,
    dt_bias), names, shapes and types."""
    mj = jax_build(JAX_ARCHS[name].reduced())
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        mj.abstract_params())
    m = build(ARCHS[name].reduced(), device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
    assert got == want
    assert m.period == 1 and m.nblocks == m.cfg.num_layers
    if m.cfg.num_experts:
        w = p["blocks"]["l0"]["moe"]["w_gate"]
        assert not w[:, m.cfg.num_experts:].any()
    else:
        assert "norm2" not in p["blocks"]["l0"]


@pytest.mark.parametrize("name", MOE_SSM)
def test_moe_ssm_prefill_matches_jax(name, route_gaps):
    mj, pj, mt, pt = _pair(name, 3)
    B, S = 2, 20                         # mamba2: two chunks, 12 padded
    tok = _tokens(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32)})
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    _no_near_tie(route_gaps)
    assert lt.shape == (B, S, mt.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL, rtol=RTOL)
    _cmp_caches(ct, cj, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", MOE_SSM)
def test_moe_ssm_decode_from_placed_caches_matches_jax(name, route_gaps):
    """Prefill 8 tokens, place the caches into a 16-slot decode cache, then
    decode 4 steps in both packages: logits and every cache leaf."""
    mj, pj, mt, pt = _pair(name, 5)
    B, S, half = 2, 12, 8
    tok = _tokens(mt.cfg, B, S, 6)
    _, prej = mj.prefill(pj, {"tokens": jnp.asarray(tok[:, :half])})
    cache_j = _jax_put(mj.init_cache(B, 16), prej)
    _, pret = mt.prefill(pt, {"tokens": torch.from_numpy(tok[:, :half])})
    cache_t = mt.init_cache(B, 16)
    place_prefill(cache_t, pret)
    for t in range(half, S):
        lj, cache_j = mj.decode_step(
            pj, cache_j, {"tokens": jnp.asarray(tok[:, t:t + 1])},
            jnp.int32(t))
        lt, cache_t = mt.decode_step(
            pt, cache_t, {"tokens": torch.from_numpy(tok[:, t:t + 1])}, t)
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL,
                                   rtol=RTOL)
    _no_near_tie(route_gaps)
    _cmp_caches(cache_t, cache_j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", MOE_SSM)
def test_moe_ssm_prefill_then_decode_matches_full_forward(name, route_gaps):
    """tests/test_models_smoke.py:61 in the port (mamba2 is one of its
    archs): decode from placed caches continues the prefill distribution,
    and the greedy tokens agree."""
    _, _, mt, pt = _pair(name, 3)
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


def test_ssm_bf16_prefill_matches_jax():
    """mamba2 reduced in bfloat16 in both packages, the same bf16 weights:
    logits and caches within the bf16 tolerance (the float32 SSM state
    too); the greedy token equal wherever the JAX logits' top-2 gap
    exceeds it."""
    mj, pj, mt, pt = _pair("mamba2-370m", 3, dtype="bfloat16")
    B, S = 2, 16
    tok = _tokens(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32)})
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    assert lt.dtype == torch.bfloat16
    got, want = lt.float().numpy(), _np(lj)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
    _cmp_caches(ct, cj, atol=BF16_ATOL, rtol=BF16_RTOL)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > BF16_ATOL + BF16_RTOL * np.abs(
        top2[..., 1])
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


# The MoE archs in bfloat16.  Both packages' bf16 logits lie ~0.03–0.09
# from the float32 logits of the same bf16 weights (the reduced MoE's
# expert outputs reach ~10² — the JAX initialiser scales them by 1/√E —
# and dominate the bf16 residual stream), more than two bf16 ulps apart
# from each other; and one or two bf16 ulps of the hidden state move a
# routing probability by ~1e-3, so a gap under BF16_TIE may pick another
# expert in either package, which moves that token's logits by O(1).  So
# each position's bf16 error against the float32 logits (the port's float32
# path, which the float32 tests hold to the JAX package's at 1e-4) must lie
# within the JAX package's own bf16 error there plus two ulps (BF16_ATOL),
# at every position whose smallest routing gap in the port is at least
# BF16_TIE; those are reported and excluded, at most one position in
# BF16_TIE_SHARE.
BF16_TIE, BF16_TIE_SHARE = 5e-3, 4


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_bf16_prefill_matches_jax(name, route_gaps):
    mj, pj, mt, pt = _pair(name, 3, dtype="bfloat16")
    B, S = 2, 16
    tok = _tokens(mt.cfg, B, S, 4)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(tok, jnp.int32)})
    lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(tok)})
    assert lt.dtype == torch.bfloat16
    gaps = np.min(np.stack(route_gaps), 0).reshape(B, S)
    m32 = build(dataclasses.replace(mt.cfg, dtype="float32"), device="cpu")
    truth = m32.prefill(tree_map(lambda t: t.float(), pt),
                        {"tokens": torch.from_numpy(tok)})[0].numpy()
    err_port = np.abs(lt.float().numpy() - truth).max(-1)
    err_jax = np.abs(_np(lj) - truth).max(-1)
    tie = gaps < BF16_TIE
    assert tie.sum() <= tie.size // BF16_TIE_SHARE, (
        f"near-tie positions {np.argwhere(tie).tolist()}")
    if tie.any():
        print(f"excluded near-tie positions {np.argwhere(tie).tolist()}")
    over = (err_port > err_jax + BF16_ATOL) & ~tie
    assert not over.any(), (
        f"bf16 error beyond the JAX package's at {np.argwhere(over)}: "
        f"{err_port[over]} against {err_jax[over]}")
    # the first layer's K/V come from the embeddings alone
    for n in ("k", "v"):
        np.testing.assert_allclose(
            ct["l0"][n][0].float().numpy(), _np(cj["l0"][n][0]),
            atol=BF16_ATOL, rtol=BF16_RTOL)
    top2 = np.sort(truth, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL) & ~tie
    np.testing.assert_array_equal(lt.float().numpy().argmax(-1)[clear],
                                  truth.argmax(-1)[clear])
