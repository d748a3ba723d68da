"""Blockwise online-softmax grouped-query attention — the Hopper kernel's
wrapper and its plain PyTorch version.

One call of :func:`flash_attention` computes what one call of the JAX
package's ``kernels/flash_attention.py::flash_attention`` computes: for
query heads ``q`` (BH, Sq, d) over KV heads ``k``, ``v`` (BHkv, Sk, d), query
head ``h`` reading KV head ``h // (BH // BHkv)``, the softmax attention of
each query row ``i`` over the keys ``j < Sk`` with ``j <= i + q_offset``
(``causal``) and ``j > i + q_offset - window`` (``window > 0``).  The LM's
attention core (``models.layers.attention_apply``) reaches it through
``ops.attention``, in prefill and in every KV-cache decode step.

* On CUDA tensors the wrapper runs the hand-written kernel
  ``csrc/flash_attention.cu`` (built with ``nvcc`` for ``sm_90a`` at first
  use, see ``kernels/build.py``): one launch — bfloat16 on the tensor cores
  (wgmma, with K/V tiles streamed by TMA when their rows are 16-byte
  aligned, by plain loads otherwise), float32 on the CUDA cores.  It never
  falls back: a refused launch or a failed build raises.
* On CPU tensors it runs :func:`flash_attention_reference`, the plain
  version: the JAX package's ``ref.mha_ref`` with the TPU kernel's
  arithmetic (float32 scores and softmax, ``p`` rounded to ``v``'s type
  before ``p·v`` with a float32 accumulator, the output rounded to ``q``'s
  type, a fully masked row 0).

``flash_attention.launches`` counts kernel launches (a plain integer).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.gs_sweep import ptr

NEG_INF = -1e30
#: Element types and head dims the kernel takes.
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128


def _group(q: torch.Tensor, k: torch.Tensor) -> int:
    BH, BHkv = q.shape[0], k.shape[0]
    if BHkv < 1 or BH % BHkv:
        raise ValueError(f"query heads ({BH}) must be a multiple of kv "
                         f"heads ({BHkv})")
    return BH // BHkv


def flash_attention_reference(
    q: torch.Tensor,            # (BH, Sq, d)
    k: torch.Tensor,            # (BHkv, Sk, d)
    v: torch.Tensor,            # (BHkv, Sk, d)
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention`, any device.

    One softmax over all keys (the kernel's online form rescales the same
    terms tile by tile): float32 scores ``scale · q kᵀ``, masked to
    ``NEG_INF``; ``p = exp(s − max)`` summed unrounded into the
    denominator and rounded to ``v``'s type for ``p·v`` (float32 sums);
    ``o = (p·v) / max(l, 1e-30)`` in ``q``'s type.  The G query heads of a
    KV head are one (G·Sq, d) block against its keys (no repeated K/V)."""
    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    G = _group(q, k)
    scale = d ** -0.5 if scale is None else float(scale)
    if Sk == 0 or q.numel() == 0:     # no key: every row is 0
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    qpos = torch.arange(G * Sq, device=q.device) % Sq + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((G * Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.matmul(q.reshape(BHkv, G * Sq, d).float(),
                     k.float().transpose(1, 2))
    s = s.mul_(scale).masked_fill_(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = s.sub_(m).exp_().masked_fill_(~mask, 0.0)
    den = p.sum(-1, keepdim=True).clamp_min_(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return acc.div_(den).to(q.dtype).view(BH, Sq, d)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def _launcher():
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_args(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
    """What the kernel takes: 3-D q (BH, Sq, d), k and v (BHkv, Sk, d) on one
    device, one type of ``DTYPES``, contiguous, ``BH % BHkv == 0``,
    ``1 <= d <= MAX_HEAD_DIM``; raise ValueError otherwise."""
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"flash_attention: q must be (BH, Sq, d) and k, v (BHkv, Sk, d), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    d = q.shape[2]
    if k.shape[2] != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim must be one d in "
                         f"[1, {MAX_HEAD_DIM}] for q, k and v, got "
                         f"{d} and {k.shape[2]}")
    _group(q, k)
    if {q.dtype, k.dtype, v.dtype} - set(DTYPES) or len(
            {q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError(f"flash_attention: q, k, v must share one type of "
                         f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: q, k, v must lie on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def flash_attention(
    q: torch.Tensor,            # (BH, Sq, d) float32 or bfloat16
    k: torch.Tensor,            # (BHkv, Sk, d), q's type
    v: torch.Tensor,            # (BHkv, Sk, d), q's type
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Grouped-query attention ``(BH, Sq, d)`` in ``q``'s type.

    CUDA tensors run the kernel (one launch on the current stream, not
    synchronised; the output is a new tensor); CPU tensors run
    :func:`flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    check_kernel_args(q, k, v)
    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    if Sq == 0 or BH == 0:
        return out
    lib = _launcher()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(out), BHkv, BH // BHkv, Sq, Sk, d,
            int(bool(causal)), int(window), int(q_offset), scale,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
