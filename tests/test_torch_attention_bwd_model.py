"""The arithmetic of the bf16 attention backward kernel, modelled on the CPU.

The kernel (``csrc/flash_attention_bwd.cu``, bf16 path) forms the scores
and dp by tensor-core products of bf16 tiles with float32 sums, takes
``p = exp(scale·s − lse)`` and ``ds = p (dp − D)`` in float32, rounds p and
ds to bf16 as the A operands of the dv, dk and dq products (float32 sums),
takes ``D = rowsum(dO ∘ o)`` from the bf16 ``o`` and rounds dq, dk, dv to
bf16 once.  :func:`bf16_backward_model` does the same in plain PyTorch,
and the test holds it, at the card tests' bf16 shapes (S ≤ 512), to the
card's unchanged tile check (``test_torch_cuda.BWD_TILE_TOL``: each (head,
64-row tile) block within 2^-7 of its norm of the float32 truth): the
rounding the design adds fits the check, so on the card a failure of that
check is a fault of the kernel.  The bf16 plain version (autograd of the
plain attention) is held to the same check beside it.
"""
import numpy as np
import pytest
import torch

import test_torch_cuda as tc
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    flash_attention_backward_reference,
    flash_attention_reference,
)


def _mask(G, Sq, Sk, causal, window, q_offset):
    qpos = torch.arange(G * Sq) % Sq + q_offset
    kpos = torch.arange(Sk)
    keep = torch.ones((G * Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def bf16_backward_model(q, k, v, o, dout, lse, *, causal, window, q_offset):
    """(dq, dk, dv) in bf16 with the kernel's roundings (see the module's
    docstring); q, k, v, o, dout bf16, lse float32 (BH, Sq)."""
    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    G = BH // BHkv
    scale = d ** -0.5
    f = lambda t: t.float()                               # noqa: E731
    qf = f(q).reshape(BHkv, G * Sq, d)
    gf = f(dout).reshape(BHkv, G * Sq, d)
    kf, vf = f(k), f(v)
    keep = _mask(G, Sq, Sk, causal, window, q_offset)
    s = qf @ kf.transpose(1, 2) * scale
    p = torch.where(keep, torch.exp(s - lse.reshape(BHkv, G * Sq, 1)), 0.0)
    dp = gf @ vf.transpose(1, 2)
    D = (f(dout) * f(o)).sum(-1).reshape(BHkv, G * Sq, 1)
    ds = p * (dp - D)
    r = lambda t: t.to(torch.bfloat16).float()            # noqa: E731
    dv = r(p).transpose(1, 2) @ gf
    dk = (r(ds).transpose(1, 2) @ qf) * scale
    dq = (r(ds) @ kf) * scale
    return tuple(t.to(torch.bfloat16) for t in
                 (dq.reshape(BH, Sq, d), dk, dv))


# the bf16 cases of test_torch_cuda.py::test_flash_attention_backward_
# matches_plain with S <= 512: (BH, BHkv, S or (Sq, Sk), d, causal, window)
CASES = [
    (4, 2, 64, 32, True, 0),
    (8, 2, 70, 120, True, 24),
    (8, 8, 130, 128, True, 0),
    (4, 1, 100, 64, False, 0),
    (6, 2, 257, 120, True, 100),
    (4, 4, 33, 17, True, 0),
    (32, 8, 300, 128, True, 4096),
    (8, 2, (130, 300), 120, True, 0),
    (8, 2, 200, 100, True, 0),
    (6, 2, 400, 64, True, 40),
]


@pytest.mark.parametrize("BH,BHkv,S,d,causal,window", CASES)
def test_bf16_rounding_model_fits_the_tile_check(BH, BHkv, S, d, causal,
                                                 window):
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    rng = np.random.default_rng(BH * 1000 + Sq + d)
    bf = lambda *shape: torch.from_numpy(                  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    q, k, v, dout = bf(BH, Sq, d), bf(BHkv, Sk, d), bf(BHkv, Sk, d), \
        bf(BH, Sq, d)
    o, lse = flash_attention_reference(q, k, v, **kw, return_lse=True)
    assert float(lse.min()) > NEG_INF / 2           # every row sees a key
    got = bf16_backward_model(q, k, v, o, dout, lse, **kw)
    truth = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), dout.float(), **kw)
    plain = flash_attention_backward_reference(q, k, v, dout, **kw)
    for name, a, b, t in zip(("dq", "dk", "dv"), got, plain, truth):
        assert a.dtype == torch.bfloat16 and a.shape == t.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert tc._bwd_tile_error(a, t) <= tc.BWD_TILE_TOL, name
        assert tc._bwd_tile_error(b, t) <= tc.BWD_TILE_TOL, name
