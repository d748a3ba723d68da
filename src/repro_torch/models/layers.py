"""Shared neural layers of the dense decoder LM (PyTorch port of
``repro.models.layers``).

Functional, like the JAX package's: parameters are plain dicts of tensors
in the JAX package's layouts — a projection is an ``(in, out)`` matrix
applied as ``x @ W`` (not ``nn.Linear``'s ``(out, in)``), so that weights
carried across from the JAX package (``models.convert``) are used as they
are.  Initialisers take a ``torch.Generator`` and make the JAX
initialisers' distributions: normal × 1/√fan_in in float32, then the
parameter type.

The projections, the MLP and the LM head are plain matrix products that the
JAX package left to XLA; here they are ``torch.matmul``.  The attention core
is the hand-written kernel, reached through ``ops.attention``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def _dense_init(generator: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / theta ** exps


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, hd); positions: (S,) or (B, S).  The split-halves
    rotation: (x1, x2) → (x1 cos − x2 sin, x1 sin + x2 cos)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs              # (S, hd/2)
        ang = ang[None, None]                                 # (1,1,S,hd/2)
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, None]                                    # (B,1,S,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (self / cross), GQA, optional sliding window
# ---------------------------------------------------------------------------

def attention_init(generator: torch.Generator, d_model: int, num_heads: int,
                   num_kv: int, hd: int, dtype) -> Params:
    return {
        "wq": _dense_init(generator, (d_model, num_heads * hd), dtype),
        "wk": _dense_init(generator, (d_model, num_kv * hd), dtype),
        "wv": _dense_init(generator, (d_model, num_kv * hd), dtype),
        "wo": _dense_init(generator, (num_heads * hd, d_model), dtype),
    }


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_base: int, causal: bool, window: int,
                    q_chunk: int) -> torch.Tensor:
    """(B, KV, G, S, hd) queries over (B, KV, Sk, hd) keys/values through
    ``ops.attention`` on the flattened heads: query row b·KV·G + kv·G + g
    reads KV row b·KV + kv, the kernel's h // G map.  Query i sits at
    position q_base + i.  On the card one launch takes all S rows; on the
    CPU the plain version runs in q_chunk-row chunks, as the JAX package's
    blockwise path does.  Under autograd each call's gradient is the
    backward kernel on the card, the plain version's autograd on the CPU
    (``ops.attention``)."""
    B, KV, G, S, hd = q.shape
    qf = q.reshape(B * KV * G, S, hd)
    kf = k.reshape(B * KV, k.shape[2], hd)
    vf = v.reshape(B * KV, v.shape[2], hd)
    if q.device.type != "cpu" or S <= q_chunk:
        o = ops.attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                          causal=causal, window=window, q_offset=q_base)
    else:
        kf, vf = kf.contiguous(), vf.contiguous()
        o = torch.cat([
            ops.attention(qf[:, c0:c0 + q_chunk].contiguous(), kf, vf,
                          causal=causal, window=window, q_offset=q_base + c0)
            for c0 in range(0, S, q_chunk)
        ], dim=1)
    return o.view(B, KV, G, S, hd)


def attention_apply(
    p: Params,
    x: torch.Tensor,                  # (B, S, D) queries
    kv_x: Optional[torch.Tensor],     # cross-attn source or None (self)
    *,
    num_heads: int,
    num_kv: int,
    hd: int,
    causal: bool,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,   # (S,) rope positions
    rope_theta: float = 0.0,                    # 0 disables rope
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,            # current write position
    q_chunk: int = 512,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Grouped-query attention in the (B, KV, G, S, hd) layout, with the
    JAX package's signature.

    Modes: prefill (``kv_cache`` None — returns the fresh (B, KV, S, hd)
    keys and values as the cache) and decode (``kv_cache`` given: the S
    new keys and values are written at ``cache_pos`` — IN PLACE into the
    caller's cache tensors, which are returned — and the queries attend to
    the cache through the kernel with ``q_offset = cache_pos``; the causal
    mask hides the slots not yet written).

    A sliding-window cache (``window > 0``) is a ring of Wc slots, slot =
    position mod Wc (S = 1).  The kernel takes keys in position order, so
    before the ring wraps (cache_pos < Wc, slots 0..cache_pos hold
    positions 0..cache_pos) it reads the ring as it is; after, the ring is
    rolled by (cache_pos + 1) mod Wc into position order (its last slot the
    current position) and the query sits at q_offset = Wc − 1.
    """
    B, S, D = x.shape
    G = num_heads // num_kv
    src = x if kv_x is None else kv_x
    Ssrc = src.shape[1]

    q = (x @ p["wq"]).view(B, S, num_kv, G, hd).permute(0, 2, 3, 1, 4)
    k = (src @ p["wk"]).view(B, Ssrc, num_kv, hd).transpose(1, 2)
    v = (src @ p["wv"]).view(B, Ssrc, num_kv, hd).transpose(1, 2)

    if rope_theta and positions is not None:
        qf = q.reshape(B, num_kv * G, S, hd)
        qf = apply_rope(qf, positions, rope_theta)
        q = qf.view(B, num_kv, G, S, hd)
        if kv_x is None:                   # self-attention: rotate keys too
            k = apply_rope(k, positions, rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache                  # (B, KV, Smax|Wc, hd)
        Wc = ck.shape[2]
        pos = int(cache_pos)
        if window > 0:
            if S != 1:
                raise ValueError(f"a ring-buffer cache takes one token a "
                                 f"step, got {S}")
            slot = pos % Wc
        else:
            slot = pos
        ck[:, :, slot:slot + S] = k
        cv[:, :, slot:slot + S] = v
        new_cache = (ck, cv)
        if window > 0 and pos >= Wc:
            shift = -((pos + 1) % Wc)
            k, v = torch.roll(ck, shift, dims=2), torch.roll(cv, shift, dims=2)
            q_base = Wc - 1
        else:
            k, v = ck, cv
            q_base = pos
    else:
        k, v = k.contiguous(), v.contiguous()
        new_cache = (k, v)
        q_base = 0

    o = _attention_core(q, k, v, q_base=q_base, causal=causal, window=window,
                        q_chunk=q_chunk)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, num_kv * G * hd)
    return (o @ p["wo"]).to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype) -> Params:
    return {
        "gate": _dense_init(generator, (d_model, d_ff), dtype),
        "up": _dense_init(generator, (d_model, d_ff), dtype),
        "down": _dense_init(generator, (d_ff, d_model), dtype),
    }


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               dtype) -> torch.Tensor:
    return _dense_init(generator, (vocab, d_model), dtype, scale=1.0)


def lm_head_init(generator: torch.Generator, d_model: int, vocab: int,
                 dtype) -> torch.Tensor:
    return _dense_init(generator, (d_model, vocab), dtype)
