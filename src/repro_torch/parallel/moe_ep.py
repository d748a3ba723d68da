"""Expert parallelism (EP) for the MoE FFN: tokens travel to their experts'
rank and back in two all-to-alls (PyTorch port of
``repro.parallel.moe_ep``).

The JAX package runs ``_ep_local`` under ``shard_map`` over a device mesh;
the port runs it SPMD, one process a mesh position (``launch.mesh``).
Every rank holds the global (B, S, D) activations and the whole layer tree,
as the replicated residual stream gives them, and takes its views: the
token shard (batch over ``data``, sequence over ``model``) and its
``E_pad / ep`` experts.  Each rank routes its tokens, fills an (E, C, D)
dispatch buffer — a pair's slot is its rank among its expert's pairs in a
STABLE sort, and pairs past the capacity C are dropped (Switch/GShard) —,
exchanges it over the model axis, runs its experts' FFN as one batched
product, exchanges the outputs back and combines them.  The global output
is then reassembled: each rank writes its shard into zeros and the buffers
are summed over the mesh, exactly (one non-zero term an element), in place
of ``shard_map``'s ``out_specs``.

Under autograd the form is differentiable as the JAX package's is: the
all-to-all's gradient is the reverse all-to-all, the reassembly's is this
rank's slice of the (replicated) output gradient, and the gradients of the
replicated inputs — x and every weight — are summed over the mesh, so that
each rank ends with the whole, replicated gradient.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp_apply
from repro_torch.models.moe import combine, pairs_of, route, sort_pairs

Params = Dict[str, torch.Tensor]


def _sum_over_mesh(mesh, t: torch.Tensor) -> torch.Tensor:
    (t,) = mesh.model.all_reduce(t)
    (t,) = mesh.data.all_reduce(t)
    return t


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all over ``axis``; its transpose is itself."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g.contiguous()), None


class _Replicated(torch.autograd.Function):
    """A tensor that every rank holds alike: the identity, whose gradient
    is summed over the mesh (each rank's holds its own tokens' share)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_mesh(ctx.mesh, g.contiguous()), None


class _Assemble(torch.autograd.Function):
    """This rank's (Bl, Sl, D) shard into the global (B, S, D) output:
    written into float32 zeros at (b0, s0) and summed over the mesh (exact:
    one non-zero term an element, so the sum also carries bf16 exactly);
    the gradient is this rank's slice of the output's."""

    @staticmethod
    def forward(ctx, y, mesh, B, S, b0, s0):
        Bl, Sl, D = y.shape
        ctx.box = (b0, b0 + Bl, s0, s0 + Sl)
        out = torch.zeros((B, S, D), dtype=torch.float32, device=y.device)
        out[b0:b0 + Bl, s0:s0 + Sl] = y.float()
        return _sum_over_mesh(mesh, out).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        b0, b1, s0, s1 = ctx.box
        return g[b0:b1, s0:s1].contiguous(), None, None, None, None, None


def capacity(capacity_factor: float, tokens: int, k: int,
             num_experts: int) -> int:
    """Slots an expert a rank: ``max(1, int(cf · T_loc · k / E_logical))``."""
    return max(1, int(capacity_factor * tokens * k / num_experts))


def dispatch_slots(topi: torch.Tensor, order: torch.Tensor,
                   num_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dispatch of the (T, k) routed experts, the pairs taken in
    ``order`` (``moe.sort_pairs``: by expert, stably): each sorted pair's
    expert, its slot — its rank among its expert's pairs, or ``capacity``
    (the drop sentinel) past it — and ``keep`` (slot < capacity)."""
    flat_e = topi.reshape(-1)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    return sorted_e, slot, keep


def _ep_local(p: Params, xt: torch.Tensor, *, k: int, num_experts: int,
              capacity: int, axis) -> torch.Tensor:
    """One rank's body: its (T, D) tokens in, their (T, D) outputs out.
    ``p`` holds the replicated router and shared expert and this rank's
    ``num_experts / axis.size`` experts; ``num_experts`` is the PADDED
    count (buffers, weights), the routing selects logical experts only."""
    T, D = xt.shape
    E, C, ep = num_experts, capacity, axis.size
    E_loc = E // ep

    # ---- route, and build the (E, C, D) dispatch buffer ----
    topv, topi = route(p["router"], xt, k)
    order, inv = sort_pairs(topi)
    sorted_e, slot, _ = dispatch_slots(topi, order, E, C)
    cell = sorted_e * (C + 1) + slot          # row C of an expert: dropped
    disp = torch.index_put(xt.new_zeros((E * (C + 1), D)), (cell,),
                           pairs_of(xt, k, order))
    disp = disp.view(E, C + 1, D)[:, :C].contiguous()

    # ---- tokens travel to their experts' rank ----
    recv = _AllToAll.apply(disp, axis)        # block j came from rank j
    recv = recv.view(ep, E_loc, C, D).transpose(0, 1).reshape(E_loc,
                                                               ep * C, D)

    # ---- the local experts' FFN, one batched product each ----
    a = (F.silu(torch.bmm(recv, p["w_gate"]).float())
         * torch.bmm(recv, p["w_up"]))
    out = torch.bmm(a.to(recv.dtype), p["w_down"])

    # ---- travel back ----
    out = out.view(E_loc, ep, C, D).transpose(0, 1).reshape(E, C, D)
    back = _AllToAll.apply(out.contiguous(), axis)

    # ---- combine (a dropped pair reads the zero sentinel row) ----
    back = F.pad(back, (0, 0, 0, 1)).reshape(E * (C + 1), D)
    vals = back.index_select(0, cell)
    w = topv.reshape(-1).index_select(0, order)
    y = combine(vals.float() * w[:, None], inv, k, xt.shape[0])
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt).float()
    return y.to(xt.dtype)


def token_shard(mesh, B: int, S: int) -> Tuple[int, int, int, int]:
    """This rank's token shard of a (B, S) batch: (b0, Bl, s0, Sl) —
    batch over the data axis, sequence over the model axis."""
    Bl, Sl = B // mesh.data.size, S // mesh.model.size
    return mesh.data.index * Bl, Bl, mesh.model.index * Sl, Sl


def moe_apply_ep(p: Params, x: torch.Tensor, *, experts_per_token: int,
                 mesh, capacity_factor: float = 2.0) -> torch.Tensor:
    """The MoE over the global (B, S, D) ``x`` on this rank of ``mesh``,
    experts over the model axis, tokens over both; every rank returns the
    global (B, S, D) output.  ``S`` must split over the model axis, ``B``
    over the data axis and the padded experts over the model axis."""
    B, S, D = x.shape
    E = p["w_gate"].shape[0]                 # padded expert count
    E_logical = p["router"].shape[1]
    ep, dp = mesh.model.size, mesh.data.size
    # tokens are ALSO sharded over the EP axis (sequence split): otherwise
    # every model rank would route the same tokens and each expert would
    # chew ep copies of them
    if S % ep or B % dp or E % ep:
        raise ValueError(f"EP on a ({dp}, {ep}) mesh needs S % {ep} == 0, "
                         f"B % {dp} == 0 and E_pad % {ep} == 0; got B {B}, "
                         f"S {S}, E_pad {E}")
    b0, Bl, s0, Sl = token_shard(mesh, B, S)
    C = capacity(capacity_factor, Bl * Sl, experts_per_token, E_logical)
    E_loc = E // ep
    e0 = mesh.model.index * E_loc

    def rep(t):
        return _Replicated.apply(t, mesh)

    local = {"router": rep(p["router"])}
    for n in ("w_gate", "w_up", "w_down"):
        local[n] = rep(p[n])[e0:e0 + E_loc]
    if "shared" in p:
        local["shared"] = {n: rep(t) for n, t in p["shared"].items()}
    xt = rep(x)[b0:b0 + Bl, s0:s0 + Sl].reshape(Bl * Sl, D)
    y = _ep_local(local, xt, k=experts_per_token, num_experts=E,
                  capacity=C, axis=mesh.model)
    return _Assemble.apply(y.reshape(Bl, Sl, D).to(x.dtype), mesh, B, S,
                           b0, s0)
