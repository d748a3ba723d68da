"""The dense decoder LM's serving path (PyTorch port of ``repro.models.lm``).

One model class driven by ``ArchConfig``, like the JAX package's ``LM``,
for the dense family: GQA / MQA / sliding-window attention (granite,
internlm2, h2o-danube).  The layers are grouped into super-blocks of
``period`` layers (1 for the dense family); their parameters are stacked
on a leading ``nblocks`` axis under ``blocks/l{j}/…`` as in the JAX
package's pytree, and a Python loop over the super-blocks takes the place
of ``lax.scan``.

Two entry points, the serving half of the JAX package's three:

* ``prefill``      — full forward over a prompt returning logits + caches
* ``decode_step``  — one token against the KV caches

Every attention layer of both goes through ``layers.attention_apply`` →
``ops.attention`` → the hand-written flash-attention kernel on the card.
Training (``loss_fn``, ``mode="train"``) belongs to a later slice, and so do
the MoE, SSM, hybrid, VLM and audio families (ROADMAP.md, queue 1 item 10):
their configs raise ``NotImplementedError``.  The JAX package's pjit levers
(mesh, ``moe_impl``, ``remat``, ``scan_barrier``, ``seq_parallel``) mean
nothing here: ``ArchConfig`` keeps them and ``LM`` ignores them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.runtime.device import Device, resolve_device

Tree = Dict[str, Any]

#: What each family that this slice does not run is waiting for
#: (ROADMAP.md, queue 1 item 10).
_NOT_PORTED = {
    "moe": "the MoE FFN (models/moe.py, parallel/moe_ep.py)",
    "ssm": "the Mamba2 SSD layers (models/ssm.py)",
    "hybrid": "the Mamba2 SSD layers (models/ssm.py) and the MoE FFN",
    "vlm": "VLM cross-attention",
    "audio": "the audio frontend",
}


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family == "dense" and not (
            cfg.num_experts or cfg.ssm_state or cfg.attn_every
            or cfg.cross_attn_every or cfg.frontend != "none"
            or cfg.d_ff <= 0):
        return
    part = ("a non-dense layer pattern" if cfg.family == "dense" else
            _NOT_PORTED.get(cfg.family, f"the {cfg.family!r} family"))
    raise NotImplementedError(
        f"{cfg.name}: the port runs the dense decoder family only; {part} "
        f"is still to port (ROADMAP.md, queue 1 item 10)")


class LM(nn.Module):
    """The dense decoder LM, serving half.

    An ``nn.Module`` for its place in PyTorch code (``device``, ``dtype``),
    but, like the JAX package's ``LM``, it holds no weights: every method
    takes the parameter tree (``init_params`` or ``convert.params_from_jax``)
    and the caches explicitly.  It runs on ``device`` — the card unless the
    caller passes ``device="cpu"`` — and raises on a host without a GPU
    otherwise.
    """

    def __init__(self, cfg: ArchConfig, device: Device = "cuda"):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.period = 1                 # a dense super-block is one layer
        self.nblocks = cfg.num_layers
        self.dtype = torch_dtype(cfg.dtype)

    # ------------------------------------------------------------------ init

    def _init_sublayer(self, generator: torch.Generator) -> Tree:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "norm1": L.rmsnorm_init(cfg.d_model, dt, dev),
            "norm2": L.rmsnorm_init(cfg.d_model, dt, dev),
            "attn": L.attention_init(generator, cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.hd, dt),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, dt),
        }

    def init_params(self, generator: torch.Generator) -> Tree:
        """Random weights from ``generator`` (a ``torch.Generator`` on this
        model's device), with the JAX initialisers' distributions: matrices
        normal × 1/√fan_in, the embedding normal × 1, norms at 1.  Each
        super-block is drawn on its own and written into the stacked
        tensors, so no second copy of the weights is ever held."""
        cfg, dt = self.cfg, self.dtype
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator lies on {generator.device}, the "
                             f"model on {self.device}")
        params: Tree = {
            "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dt),
        }
        blocks: Optional[Tree] = None
        for b in range(self.nblocks):
            blk = {f"l{j}": self._init_sublayer(generator)
                   for j in range(self.period)}
            if blocks is None:
                blocks = tree_map(
                    lambda t: torch.empty((self.nblocks,) + tuple(t.shape),
                                          dtype=t.dtype, device=t.device),
                    blk)
            tree_map(lambda dst, src: dst[b].copy_(src), blocks, blk)
            del blk
        params["blocks"] = blocks
        params["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, self.device)
        params["lm_head"] = L.lm_head_init(generator, cfg.d_model,
                                           cfg.vocab_size, dt)
        return params

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch: int, max_seq: int) -> Tree:
        """Per-block decode caches, stacked on the block axis:
        ``{"l{j}": {"k", "v"}}`` of (nblocks, batch, KV, kv_len, hd), zeros.

        Sliding-window layers get a RING buffer of ``window`` slots instead
        of ``max_seq`` (slot = position mod window)."""
        cfg = self.cfg
        kv_len = max_seq
        if cfg.sliding_window > 0:
            kv_len = min(max_seq, cfg.sliding_window)
        shape = (self.nblocks, batch, cfg.num_kv_heads, kv_len, cfg.hd)
        return {f"l{j}": {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
        } for j in range(self.period)}

    # --------------------------------------------------------------- forward

    def _block_apply(self, bp: Tree, x: torch.Tensor, *,
                     positions: torch.Tensor, bcache: Optional[Tree],
                     mode: str, pos: Optional[int]):
        cfg = self.cfg
        decode = mode == "decode"
        newc: Tree = {}
        for j in range(self.period):
            lp = bp[f"l{j}"]
            h = L.rmsnorm(x, lp["norm1"])
            kvc = None
            if decode:
                kvc = (bcache[f"l{j}"]["k"], bcache[f"l{j}"]["v"])
            o, newkv = L.attention_apply(
                lp["attn"], h, None,
                num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads, hd=cfg.hd,
                causal=True, window=cfg.sliding_window,
                positions=positions,
                rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
                kv_cache=kvc, cache_pos=pos if decode else None,
            )
            x = x + o
            newc[f"l{j}"] = {"k": newkv[0], "v": newkv[1]}
            h = L.rmsnorm(x, lp["norm2"])
            x = x + L.mlp_apply(lp["mlp"], h)
        return x, newc

    def backbone(self, params: Tree, x: torch.Tensor, *,
                 positions: torch.Tensor, caches: Optional[Tree] = None,
                 mode: str = "prefill", pos: Optional[int] = None):
        """Runs the block stack.  Returns (hidden, caches).

        ``mode="prefill"`` makes new stacked caches of the prompt's keys and
        values; ``mode="decode"`` writes the step's keys and values into
        ``caches`` in place and returns them."""
        if mode not in ("prefill", "decode"):
            raise NotImplementedError(
                f"mode {mode!r}: the port serves (prefill, decode); training "
                f"is a later slice (ROADMAP.md, queue 1 item 10)")
        out: Optional[Tree] = caches if mode == "decode" else None
        for b in range(self.nblocks):
            bp = tree_map(lambda t: t[b], params["blocks"])
            bc = (tree_map(lambda t: t[b], caches) if mode == "decode"
                  else None)
            x, newc = self._block_apply(bp, x, positions=positions,
                                        bcache=bc, mode=mode, pos=pos)
            if mode == "prefill":
                if out is None:
                    out = tree_map(
                        lambda t: torch.empty(
                            (self.nblocks,) + tuple(t.shape), dtype=t.dtype,
                            device=t.device), newc)
                tree_map(lambda dst, src: dst[b].copy_(src), out, newc)
            del newc
        return x, out

    def embed_inputs(self, params: Tree, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"].to(self.device).long()
        return params["embed"][tokens].to(self.dtype)

    def logits(self, params: Tree, hidden: torch.Tensor) -> torch.Tensor:
        h = L.rmsnorm(hidden, params["final_norm"])
        return h @ params["lm_head"]

    # ------------------------------------------------------------- serving

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]):
        """Forward over a full prompt ``batch["tokens"]`` (B, S); returns
        (logits (B, S, vocab), caches of (nblocks, B, KV, S, hd))."""
        x = self.embed_inputs(params, batch)
        S = x.shape[1]
        hidden, caches = self.backbone(
            params, x, positions=torch.arange(S, device=self.device),
            mode="prefill")
        return self.logits(params, hidden), caches

    def decode_step(self, params: Tree, caches: Tree,
                    batch: Dict[str, torch.Tensor], pos):
        """One decode step.  ``batch["tokens"]`` is (B, 1); ``pos`` (an int
        or a 0-d tensor) is its position.  The caches are updated in place
        and returned with the logits (B, 1, vocab)."""
        pos = int(pos)
        x = self.embed_inputs(params, batch)
        hidden, caches = self.backbone(
            params, x,
            positions=torch.full((1,), pos, dtype=torch.long,
                                 device=self.device),
            caches=caches, mode="decode", pos=pos)
        return self.logits(params, hidden), caches


def build(cfg: ArchConfig, device: Device = "cuda") -> LM:
    return LM(cfg, device=device)
