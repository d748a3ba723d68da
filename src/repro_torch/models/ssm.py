"""Mamba2 (state-space duality / SSD) block — the chunked scan for prefill
and training, the O(1) step for decode (PyTorch port of
``repro.models.ssm``).

Chunked SSD in the minimal formulation of Dao & Gu (2024): within a chunk
the recurrence is a masked, quadratic-in-chunk contraction; across chunks a
linear recurrence over the (H, P, N) states runs in a loop over the chunks
(the JAX package's ``lax.scan``).  The JAX package computes all of it with
einsums, a scan and ``conv_general_dilated``, outside any Pallas kernel, so
plain PyTorch is its port.  Every formula follows the JAX module; its
three-operand einsums are written as two products each (``torch.einsum``
contracts left to right, which would build a larger intermediate).

Decode keeps the (B, H, P, N) float32 state and the depthwise-conv tail of
the last k − 1 pre-conv inputs: memory per sequence that does not grow with
its length.  A single B/C group (``n_groups = 1``), as in mamba2-370m.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, TypedDict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, rmsnorm
from repro_torch.runtime.device import Device

Params = Dict[str, torch.Tensor]


class SSMCache(TypedDict):
    """A Mamba2 layer's decode cache (a plain dict: the port's tree
    functions walk it like the K/V caches)."""

    state: torch.Tensor   # (B, H, P, N) float32 SSD state
    conv: torch.Tensor    # (B, k-1, conv_dim) pre-conv tail, model type


def mamba_init(generator: torch.Generator, d_model: int, d_state: int,
               head_dim: int, expand: int, conv_k: int, dtype) -> Params:
    """The JAX initialisers: projections normal × 1/√fan_in, ``conv_w`` at
    scale 0.5, ``conv_b`` 0, ``A_log`` 0 (A = −1), ``D`` 1, ``dt_bias`` −2
    (softplus(−2) ≈ 0.13), ``gnorm`` 1; A_log, D and dt_bias in float32."""
    din = expand * d_model
    nh = din // head_dim
    conv_dim = din + 2 * d_state
    dev = generator.device
    return {
        "in_proj": _dense_init(generator, (d_model, 2 * din + 2 * d_state
                                           + nh), dtype),
        "conv_w": _dense_init(generator, (conv_dim, conv_k), dtype,
                              scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32, device=dev),
        "gnorm": torch.ones((din,), dtype=dtype, device=dev),
        "out_proj": _dense_init(generator, (din, d_model), dtype),
    }


# ---------------------------------------------------------------------------
# chunked SSD (training / prefill)
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T) with out[i, j] = Σ_{j<t<=i} x[t]; −inf
    above the diagonal.  The mask is applied to the sum, before any exp,
    so no gradient flows through the −inf entries."""
    T = x.shape[-1]
    i = torch.arange(T, device=x.device)[:, None]
    j = torch.arange(T, device=x.device)[None, :]
    xx = x[..., :, None].expand(x.shape + (T,))           # out[i,j] = x[i]
    xx = torch.where(i > j, xx, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    seg = torch.cumsum(xx, dim=-2)
    return torch.where(i >= j, seg, torch.full((), float("-inf"),
                                               dtype=x.dtype,
                                               device=x.device))


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)  (already includes dt: x·Δ)
    dA: torch.Tensor,     # (B, S, H)     log-decay per step: Δ·A (negative)
    Bm: torch.Tensor,     # (B, S, N)
    Cm: torch.Tensor,     # (B, S, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's type, final_state (B, H, P, N)
    float32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    C_ = S // chunk
    xc = x.reshape(B, C_, chunk, H, P).float()
    dAc = dA.reshape(B, C_, chunk, H).permute(0, 3, 1, 2)     # (B,H,C,l)
    Bc = Bm.reshape(B, C_, chunk, N).float()
    Cc = Cm.reshape(B, C_, chunk, N).float()

    A_cum = torch.cumsum(dAc, dim=-1)                         # (B,H,C,l)

    # 1) intra-chunk (diagonal blocks): scores · L, then · x
    L = torch.exp(_segsum(dAc))                               # (B,H,C,l,l)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)          # (B,C,l,l)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", L * scores[:, None], xc)
    del L

    # 2) chunk-final states: x decayed to the chunk's end, then · B
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)         # (B,H,C,l)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]     # (B,C,l,H,P)
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xd)

    # 3) inter-chunk recurrence (the scan over chunks)
    chunk_decay = torch.exp(A_cum[..., -1])                   # (B,H,C)
    s = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    prev = []
    for c in range(C_):
        prev.append(s)                  # the state *entering* chunk c
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                        # (B,C,H,P,N)

    # 4) state → output: C · state, then the decay into the chunk
    state_decay = torch.exp(A_cum)                            # (B,H,C,l)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states)
    y_off = y_off * state_decay.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), s


# ---------------------------------------------------------------------------
# depthwise causal conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C); w (C, k); left-padded depthwise conv: out[s] =
    Σ_i w[:, i] · x[s − k + 1 + i] + b, a cross-correlation (no flip), as
    the JAX package's ``conv_general_dilated``."""
    k = w.shape[1]
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))                 # (B, C, S+k-1)
    out = F.conv1d(xp, w[:, None, :], groups=x.shape[-1])
    return out.transpose(1, 2) + b


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------

def mamba_apply(
    p: Params,
    x: torch.Tensor,                  # (B, S, D)
    *,
    d_state: int,
    head_dim: int,
    expand: int,
    chunk: int,
    cache: Optional[SSMCache] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, SSMCache]:
    """The Mamba2 block: in_proj → (z, xBC, dt); the causal conv and SiLU;
    the SSD (chunked over the sequence, or one recurrence step in decode);
    the skip D·x; the gated norm rmsnorm(y · silu(z)); out_proj.  The
    projections run in the model's type, dt = softplus(dt + dt_bias), the
    SSD and the state in float32, and so does the gated norm's product
    (rmsnorm's own type: rounded once, as XLA's fused elementwise code
    rounds it in the JAX package).  Returns (out (B, S, D), the new cache);
    the caller's cache is not written."""
    B, S, D = x.shape
    din = expand * D
    nh = din // head_dim
    conv_dim = din + 2 * d_state
    k_conv = p["conv_w"].shape[1]

    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [din, conv_dim, nh], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B,S,nh)
    A = -torch.exp(p["A_log"])                                # (nh,)

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes a cache and one token a step")
        # conv tail: append the current input, convolve the last k inputs
        win = torch.cat([cache["conv"], xBC], dim=1)          # (B, k, conv)
        conv_out = torch.einsum("bkc,ck->bc", win, p["conv_w"]) + p["conv_b"]
        xBC_t = F.silu(conv_out)                              # (B, conv)
        xi, Bt, Ct = torch.split(xBC_t, [din, d_state, d_state], dim=-1)
        xh = xi.reshape(B, nh, head_dim).float()
        dt_t = dt[:, 0]                                       # (B, nh)
        dA = torch.exp(dt_t * A)                              # (B, nh)
        dBx = torch.einsum("bhp,bn->bhpn", dt_t[..., None] * xh, Bt.float())
        state = cache["state"] * dA[..., None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", state, Ct.float())
        y = y + p["D"][None, :, None] * xh
        y = y.reshape(B, 1, din).to(x.dtype)
        new_cache = SSMCache(state=state, conv=win[:, 1:])
    else:
        xBC_raw = xBC                                         # pre-conv tail
        xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xi, Bm, Cm = torch.split(xBC, [din, d_state, d_state], dim=-1)
        xh = xi.reshape(B, S, nh, head_dim)
        dA = dt * A                                           # (B,S,nh)
        # pad S to a chunk multiple: dt = 0 ⇒ decay 1 (state carried),
        # x·dt = 0 ⇒ no input; the padded outputs are dropped below
        ck = min(chunk, S) if S % chunk else chunk
        pad = (-S) % ck

        def _p(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))

        y, final_state = ssd_chunked(
            _p(xh.float() * dt[..., None]), _p(dA), _p(Bm), _p(Cm), ck,
            initial_state=cache["state"] if cache is not None else None)
        y = y[:, :S] + p["D"][None, None, :, None] * xh.float()
        y = y.reshape(B, S, din).to(x.dtype)
        tail = F.pad(xBC_raw, (0, 0, k_conv - 1, 0))[:, -(k_conv - 1):, :]
        new_cache = SSMCache(state=final_state, conv=tail)

    y = rmsnorm(y.float() * F.silu(z.float()), p["gnorm"]).to(x.dtype)
    return (y @ p["out_proj"]).to(x.dtype), new_cache


def mamba_cache_init(batch: int, d_model: int, d_state: int, head_dim: int,
                     expand: int, conv_k: int, dtype=torch.float32, *,
                     device: Device) -> SSMCache:
    """A zero decode cache on ``device`` (no default: the LM passes its
    own, a direct caller names the card or the CPU)."""
    din = expand * d_model
    nh = din // head_dim
    return SSMCache(
        state=torch.zeros((batch, nh, head_dim, d_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_k - 1, din + 2 * d_state),
                         dtype=dtype, device=device),
    )
