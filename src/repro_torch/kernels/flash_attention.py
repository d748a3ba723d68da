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

Training differentiates through :class:`FlashAttentionFunction`: its
forward is :func:`flash_attention` with each row's log-sum-exp
(``return_lse=True``), its backward :func:`flash_attention_backward` — on
CUDA tensors the hand-written kernels of ``csrc/flash_attention_bwd.cu``
(which replace no TPU kernel: the JAX package's training step lets XLA
differentiate its chunked attention; bfloat16 on the tensor cores — wgmma,
TMA — with p and ds rounded to bf16 as product operands, float32 on the
CUDA cores), on CPU tensors their plain version, ``torch.autograd`` of
:func:`flash_attention_reference`.
``flash_attention_backward.launches`` counts its calls on the card (each
call launches the three kernels of the backward once).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

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
    return_lse: bool = False,
):
    """The plain PyTorch version of :func:`flash_attention`, any device.

    One softmax over all keys (the kernel's online form rescales the same
    terms tile by tile): float32 scores ``scale · q kᵀ``, masked to
    ``NEG_INF``; ``p = exp(s − max)`` summed unrounded into the
    denominator and rounded to ``v``'s type for ``p·v`` (float32 sums);
    ``o = (p·v) / max(l, 1e-30)`` in ``q``'s type.  The G query heads of a
    KV head are one (G·Sq, d) block against its keys (no repeated K/V).
    With ``return_lse`` it also returns each row's log-sum-exp
    ``m + log(max(l, 1e-30))`` (float32, (BH, Sq)), the kernel's."""
    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    G = _group(q, k)
    scale = d ** -0.5 if scale is None else float(scale)
    if Sk == 0 or q.numel() == 0:     # no key: every row is 0
        o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.full((BH, Sq), NEG_INF, dtype=torch.float32,
                         device=q.device)
        return (o, lse) if return_lse else o
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
    # no tensor that autograd saves is written in place (the plain backward
    # differentiates this function): exp(-inf) = 0 masks p
    p = (s - m).masked_fill_(~mask, -math.inf).exp()
    del s
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (acc / den).to(q.dtype).view(BH, Sq, d)
    if not return_lse:
        return o
    return o, (m + den.log()).view(BH, Sq)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def _launcher():
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 8 + [ctypes.c_float, i, p]
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
    return_lse: bool = False,
):
    """Grouped-query attention ``(BH, Sq, d)`` in ``q``'s type, and with
    ``return_lse`` each row's float32 log-sum-exp (BH, Sq) beside it.

    CUDA tensors run the kernel (one launch on the current stream, not
    synchronised; the outputs are new tensors; the output's bits do not
    depend on ``return_lse``); CPU tensors run
    :func:`flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         q_offset=q_offset,
                                         return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    check_kernel_args(q, k, v)
    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if Sq == 0 or BH == 0:
        return (out, lse) if return_lse else out
    lib = _launcher()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            ptr(q), ptr(k), ptr(v), ptr(out),
            ptr(lse), BHkv, BH // BHkv, Sq, Sk, d,
            int(bool(causal)), int(window), int(q_offset), scale,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({rc})")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    *, causal: bool = True, window: int = 0, scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention_backward`, any device:
    ``torch.autograd`` of :func:`flash_attention_reference` at ``(q, k,
    v)`` against the output gradient ``dout``.  It recomputes the forward
    and holds its (BHkv, G·Sq, Sk) float32 scores (no ``o`` or lse is
    read).  Returns ``(dq, dk, dv)`` in the inputs' type."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention_reference(*leaves, causal=causal, window=window,
                                      scale=scale, q_offset=q_offset)
        grads = torch.autograd.grad(o, leaves, dout)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _bwd_launcher():
    from repro_torch.kernels import build

    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_backward_args(q, k, v, o, dout, lse) -> None:
    """What the backward kernels take: :func:`check_kernel_args` for q, k,
    v; ``o`` and ``dout`` of q's shape and type, ``lse`` float32 (BH, Sq),
    all on q's device and contiguous, and at least one key; raise
    ValueError otherwise."""
    check_kernel_args(q, k, v)
    for name, t in (("o", o), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tuple(lse.shape) != tuple(q.shape[:2]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be float32 "
                         f"{tuple(q.shape[:2])}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    for name, t in (("o", o), ("dout", dout), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} lies on "
                             f"{t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"contiguous")
    if k.shape[1] == 0:
        raise ValueError("flash_attention_backward: no key (Sk = 0)")


def flash_attention_backward(
    q: torch.Tensor,            # (BH, Sq, d) float32 or bfloat16
    k: torch.Tensor,            # (BHkv, Sk, d), q's type
    v: torch.Tensor,            # (BHkv, Sk, d), q's type
    o: torch.Tensor,            # (BH, Sq, d): flash_attention's output
    dout: torch.Tensor,         # (BH, Sq, d): the output's gradient
    lse: torch.Tensor,          # (BH, Sq) float32: the forward's lse
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)`` for the
    output gradient ``dout``, in the inputs' type; ``dk`` and ``dv`` sum
    over the G query heads of each KV head.

    CUDA tensors run the kernels of ``csrc/flash_attention_bwd.cu`` (three
    launches on the current stream, not synchronised, from ``o`` and the
    forward's ``lse``; float32 sums — bf16 inputs on the tensor cores, p
    and ds rounded to bf16 as operands — and no atomics: two calls give the
    same bits); CPU tensors run :func:`flash_attention_backward_reference`.
    Never falls back: a refused launch or a failed build raises."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, dout, causal=causal, window=window, scale=scale,
            q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on cuda or cpu, "
                         f"not {q.device}")
    check_backward_args(q, k, v, o, dout, lse)
    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    scale = d ** -0.5 if scale is None else float(scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if Sq == 0 or BH == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    lib = _bwd_launcher()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(lse), ptr(delta),
            ptr(dq), ptr(dk), ptr(dv), BHkv, BH // BHkv, Sq, Sk, d,
            int(bool(causal)), int(window), int(q_offset), scale,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_backward kernel launch failed: "
                           f"{msg} ({rc})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward keeps q, k, v,
    its output and each row's log-sum-exp; the backward is
    :func:`flash_attention_backward` (the kernels on the card, the plain
    autograd on the CPU).  ``apply(q, k, v, causal, window, q_offset)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, dout.contiguous(), lse, causal=causal, window=window,
            q_offset=q_offset)
        return dq, dk, dv, None, None, None
