"""The port's attention kernel's plain version vs the JAX package's TPU
kernel, on the CPU.

The same numpy-seeded inputs go through the JAX package's
``flash_attention`` in interpret mode (as ``tests/test_kernels.py`` runs
it), its oracle ``ref.mha_ref``, and the port's
``flash_attention.flash_attention`` on CPU tensors, which runs the plain
version.  Tolerances: float32 atol 2e-5, the JAX package's own
kernel-vs-oracle tolerance (``tests/test_kernels.py``): the outputs are
convex combinations of N(0, 1) values, and the sides differ only in the
order of float32 sums and the online rescaling; bfloat16 atol 1.6e-2 against
the bf16 TPU kernel (two bf16 roundings of p and of the output, each half an
ulp of 7.8e-3 at 1) and the JAX test's 3e-2 against float32 ``mha_ref``.

Also: ``ops.attention``'s eager contracts, fully masked rows, and the
ring-buffer rule of ``layers.attention_apply`` (keys rolled into position
order, query at q_offset = Wc − 1) against direct absolute-position
masking.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from repro_torch.models import layers

ATOL = 2e-5

# the cases of tests/test_kernels.py::test_flash_attention_kernel
CASES = [
    (4, 2, 64, 64, 32, True, 0, 0),
    (4, 1, 48, 48, 32, True, 0, 0),       # MQA, padded seq
    (2, 2, 64, 64, 32, True, 24, 0),      # sliding window
    (4, 2, 8, 96, 32, True, 0, 88),       # decode tail
    (2, 2, 64, 64, 64, False, 0, 0),      # cross-attn (non-causal)
]


def _qkv(BH, BHkv, Sq, Sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, Sq, d)).astype(np.float32),
            rng.normal(size=(BHkv, Sk, d)).astype(np.float32),
            rng.normal(size=(BHkv, Sk, d)).astype(np.float32))


@pytest.mark.parametrize("BH,BHkv,Sq,Sk,d,causal,window,qoff", CASES)
def test_plain_version_matches_the_tpu_kernel(BH, BHkv, Sq, Sk, d, causal,
                                              window, qoff):
    q, k, v = _qkv(BH, BHkv, Sq, Sk, d, Sq + Sk)
    j = jnp.asarray
    want = np.asarray(jax_flash(j(q), j(k), j(v), causal=causal,
                                window=window, q_offset=qoff, block_q=32,
                                block_k=32, interpret=True))
    oracle = np.asarray(ref.mha_ref(j(q), j(k), j(v), causal=causal,
                                    window=window, q_offset=qoff))
    t = torch.from_numpy
    got = flash_attention(t(q), t(k), t(v), causal=causal, window=window,
                          q_offset=qoff)
    assert got.dtype == torch.float32 and got.shape == (BH, Sq, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL)
    # the dispatch layer on CPU tensors is the plain version, bit for bit
    via_ops = ops.attention(t(q), t(k), t(v), causal=causal, window=window,
                            q_offset=qoff)
    assert torch.equal(via_ops, got)


def test_plain_version_bf16_matches_the_tpu_kernel():
    """tests/test_kernels.py::test_flash_attention_bf16's inputs."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 32, 32)), jnp.bfloat16)
               for _ in range(3))
    want = np.asarray(jax_flash(q, k, v, block_q=16, block_k=16,
                                interpret=True), np.float32)
    oracle = np.asarray(ref.mha_ref(q.astype(jnp.float32),
                                    k.astype(jnp.float32),
                                    v.astype(jnp.float32)))

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()

    got = flash_attention(bf16(q), bf16(k), bf16(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1.6e-2)
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=3e-2)


def test_plain_version_rounds_p_to_v_type():
    """With bf16 v the plain version rounds p before p·v (the TPU kernel's
    p.astype(v.dtype)); with float32 it does not: the two differ."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 16, 40, 32, 7))
    f32 = flash_attention_reference(q, k, v)
    b16 = flash_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16())
    again = flash_attention_reference(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16())
    assert torch.equal(b16, again)
    err = (b16.float() - f32).abs().max().item()
    assert 0 < err < 3e-2


def test_fully_masked_rows_are_zero():
    """A window that hides every key of a row gives 0, not NaN (the TPU
    kernel's acc / max(l, 1e-30)); so does an empty key set."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, 8, 16, 32, 3))
    # rows at positions 20..27 with a window of 4 see keys 17..27: none < 16
    o = flash_attention(q, k, v, causal=True, window=4, q_offset=20)
    assert torch.equal(o, torch.zeros_like(o))
    # a negative offset hides every key from the first rows under causality
    o = flash_attention(q, k, v, causal=True, q_offset=-3)
    assert torch.equal(o[:, :3], torch.zeros_like(o[:, :3]))
    assert torch.isfinite(o).all() and o[:, 3:].abs().sum() > 0
    o = flash_attention(q, k[:, :0], v[:, :0])
    assert torch.equal(o, torch.zeros_like(o))


@pytest.mark.parametrize("pos", [3, 7, 8, 13, 21, 31])
def test_ring_order_matches_absolute_masking(pos):
    """A ring of Wc = 8 slots (slot = position mod 8) holding the last
    keys up to ``pos``: rolled by (pos + 1) mod 8 into position order with
    the query at q_offset = 7 once the ring has wrapped, or read as it is
    with q_offset = pos before, the attention equals the one over all
    positions 0..pos with absolute masking (window 8)."""
    Wc, BH, BHkv, d = 8, 4, 2, 32
    q, k, v = (torch.from_numpy(x) for x in _qkv(BH, BHkv, 1, pos + 1, d,
                                                  pos))
    want = flash_attention(q, k, v, causal=True, window=Wc, q_offset=pos)
    ring_k = torch.zeros((BHkv, Wc, d))
    ring_v = torch.zeros((BHkv, Wc, d))
    for p in range(max(0, pos - Wc + 1), pos + 1):
        ring_k[:, p % Wc] = k[:, p]
        ring_v[:, p % Wc] = v[:, p]
    if pos < Wc:
        got = flash_attention(q, ring_k, ring_v, causal=True, window=Wc,
                              q_offset=pos)
    else:
        shift = -((pos + 1) % Wc)
        got = flash_attention(q, torch.roll(ring_k, shift, 1),
                              torch.roll(ring_v, shift, 1), causal=True,
                              window=Wc, q_offset=Wc - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_attention_apply_ring_decode_matches_absolute_masking():
    """``attention_apply``'s ring path, step by step from position 0 past
    two wraps, against one causal window-masked call over every position."""
    rng = np.random.default_rng(11)
    B, D, H, KV, hd, Wc, S = 2, 32, 4, 2, 8, 8, 20
    gen = torch.Generator().manual_seed(0)
    p = layers.attention_init(gen, D, H, KV, hd, torch.float32)
    x = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    kw = dict(num_heads=H, num_kv=KV, hd=hd, causal=True, window=Wc,
              rope_theta=1e4)
    full, _ = layers.attention_apply(p, x, None,
                                     positions=torch.arange(S), **kw)
    ck = torch.zeros((B, KV, Wc, hd))
    cv = torch.zeros((B, KV, Wc, hd))
    outs = []
    for t in range(S):
        o, (ck, cv) = layers.attention_apply(
            p, x[:, t:t + 1], None, positions=torch.tensor([t]),
            kv_cache=(ck, cv), cache_pos=t, **kw)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-5)


def _contract_cases():
    f = torch.float32
    ok = dict(q=(4, 8, 32), k=(2, 8, 32), v=(2, 8, 32))
    return [
        ("not_multiple", dict(ok, q=(3, 8, 32)), f, "multiple of kv heads"),
        ("rank", dict(ok, q=(4, 8)), f, "must be"),
        ("kv_shapes", dict(ok, v=(2, 9, 32)), f, "must be"),
        ("head_dim_big", dict(q=(4, 8, 136), k=(2, 8, 136), v=(2, 8, 136)),
         f, "head dim"),
        ("head_dim_mismatch", dict(ok, k=(2, 8, 16), v=(2, 8, 16)), f,
         "head dim"),
        ("float16", ok, torch.float16, "one type"),
        ("float64", ok, torch.float64, "one type"),
    ]


@pytest.mark.parametrize("name,shapes,dtype,match", _contract_cases(),
                         ids=[c[0] for c in _contract_cases()])
def test_attention_contracts(name, shapes, dtype, match):
    t = {n: torch.zeros(s, dtype=dtype) for n, s in shapes.items()}
    with pytest.raises(ops.ContractError, match=match):
        ops.attention(t["q"], t["k"], t["v"])


def test_attention_contracts_layout_and_device():
    q = torch.zeros((4, 8, 32))
    k = torch.zeros((2, 8, 32))
    with pytest.raises(ops.ContractError, match="one type"):
        ops.attention(q, k.bfloat16(), k)
    with pytest.raises(ops.ContractError, match="contiguous"):
        ops.attention(torch.zeros((4, 32, 8)).transpose(1, 2), k, k)
    with pytest.raises(ops.ContractError, match="one device"):
        ops.attention(q, k, torch.zeros((2, 8, 32), device="meta"))
    with pytest.raises(ops.ContractError, match="window"):
        ops.attention(q, k, k, window=-1)
    # the kernel wrapper refuses a device it has no kernel for
    m = torch.zeros((4, 8, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(m, m[:2], m[:2])
