"""Mixture-of-experts FFN (Qwen-MoE style): top-k routing and a grouped
product over each expert's tokens (PyTorch port of ``repro.models.moe``).

The TP form (``moe_impl="tp"``, and every decode step): the (token, expert)
pairs are sorted by expert — a STABLE sort, as ``jnp.argsort`` is — so each
expert's tokens are one contiguous group, and the three products of the
SwiGLU FFN run on each non-empty group.  The JAX package leaves that to
``jax.lax.ragged_dot``, a library grouped product outside any Pallas kernel;
here it is one ``torch.matmul`` a non-empty group, the same code on the CPU
and on the card, with the group sizes read on the host once a layer.

The combine takes no atomics: the weighted outputs are put back in (token,
slot) order, (T, k, D), and summed over the k slots in order, so two calls
give the same bits (``index_add_`` on the card adds in an order that changes
from run to run).  That differs from the JAX package's ``.at[tok].add`` only
in the order of the k-term sums.  The elementwise work between the products
— the SwiGLU gate, the routing weight, the combine and the shared expert's
sum — is taken in float32 and rounded once to the model's type, as XLA's
fused elementwise code takes it in the JAX package.  The expert-parallel
form is ``repro_torch.parallel.moe_ep``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, mlp_apply, mlp_init

Params = Dict[str, torch.Tensor]


def pad_experts(num_experts: int, multiple: int = 16) -> int:
    """Experts padded to the model-axis multiple (EP needs E % mesh == 0).

    Pad experts have zero weights and no router column — never routed to,
    never contribute; they only square the sharding (qwen2's 60 → 64).
    """
    return -(-num_experts // multiple) * multiple


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, num_shared: int, shared_ff: int,
             dtype) -> Params:
    """The router (D, E) in float32 at the LOGICAL expert count, the expert
    weights (E_pad, …) zero-padded to ``pad_experts(E)``, and the shared
    expert (an MLP of ``shared_ff or d_ff · num_shared``) when there is one;
    the JAX initialisers' distributions."""
    ep = pad_experts(num_experts)

    def padded(shape):
        w = _dense_init(generator, (num_experts,) + shape, dtype)
        if ep == num_experts:
            return w
        out = torch.zeros((ep,) + shape, dtype=dtype, device=w.device)
        out[:num_experts] = w
        return out

    p = {
        "router": _dense_init(generator, (d_model, num_experts),
                              torch.float32),
        "w_gate": padded((d_model, d_ff)),
        "w_up": padded((d_model, d_ff)),
        "w_down": padded((d_ff, d_model)),
    }
    if num_shared:
        p["shared"] = mlp_init(generator, d_model,
                               shared_ff or d_ff * num_shared, dtype)
    return p


def route(router: torch.Tensor, xt: torch.Tensor, k: int,
          norm: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of the (T, D) tokens: a float32 softmax over the
    router's logits, its k largest probabilities (descending) and their
    experts, the probabilities renormalised to sum 1 (floor 1e-9).
    Returns (weights (T, k) float32, experts (T, k) int64)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    if norm:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return topv, topi


def sort_pairs(topi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The T·k (token, expert) pairs in expert order, stably: ``order``
    (the pair indices t·k + j sorted by expert) and its inverse."""
    order = torch.argsort(topi.reshape(-1), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return order, inv


def pairs_of(xt: torch.Tensor, k: int, order: torch.Tensor) -> torch.Tensor:
    """Each pair's token row, in ``order``: (T·k, D).  The rows are
    repeated k times before the gather so that the gather is a permutation
    (its gradient a permutation too, and the repeat's a sum over k)."""
    T, D = xt.shape
    rep = xt[:, None].expand(T, k, D).reshape(T * k, D)
    return rep.index_select(0, order)


def combine(vals: torch.Tensor, inv: torch.Tensor, k: int,
            T: Optional[int] = None) -> torch.Tensor:
    """The sorted pairs' weighted outputs (T·k, D) summed into their T
    tokens, (T, D): back in (token, slot) order, then a sum over the k
    slots in order — no atomics.  ``T`` defaults to T·k / k; with k = 0 it
    must be given (zeros, as the JAX package's scatter of no pair)."""
    D = vals.shape[-1]
    if T is None:
        T = inv.numel() // k
    return vals.index_select(0, inv).view(T, k, D).sum(1)


def grouped_ffn(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """The SwiGLU FFN of expert e on rows [Σ_{<e} sizes, Σ_{≤e} sizes) of
    the expert-sorted (N, D) rows: ``ragged_dot``'s counterpart, one
    ``torch.matmul`` a product a non-empty group.  Returns (N, D).

    The weights are unbound once a product (E views): in backward that is
    one stack of each leaf's gradient, not a zero gradient of the whole
    leaf for every expert, as a select an expert would give."""
    gates, ups, downs = (w.unbind(0) for w in (w_gate, w_up, w_down))
    outs: List[torch.Tensor] = []
    lo = 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        xe = xs[lo:lo + n]
        a = F.silu((xe @ gates[e]).float()) * (xe @ ups[e])
        outs.append(a.to(xs.dtype) @ downs[e])
        lo += n
    if not outs:
        return xs.new_zeros((0, w_down.shape[-1]))
    return torch.cat(outs)


def moe_apply(p: Params, x: torch.Tensor, *, experts_per_token: int,
              router_weights_norm: bool = True) -> torch.Tensor:
    """Top-k routed MoE over (B, S, D) tokens, dropless: route, sort the
    pairs by expert, the grouped FFN, the routing weight, the combine, and
    the shared expert.  Returns (B, S, D) in x's type."""
    B, S, D = x.shape
    Ep = p["w_gate"].shape[0]            # padded experts (weights, groups)
    k = experts_per_token
    xt = x.reshape(B * S, D)
    topv, topi = route(p["router"], xt, k, router_weights_norm)
    order, inv = sort_pairs(topi)
    xs = pairs_of(xt, k, order)
    sizes = torch.bincount(topi.reshape(-1), minlength=Ep).tolist()
    out = grouped_ffn(xs, p["w_gate"], p["w_up"], p["w_down"], sizes)
    w = topv.reshape(-1).index_select(0, order)
    y = combine(out.float() * w[:, None], inv, k, B * S)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt).float()
    return y.reshape(B, S, D).to(x.dtype)
