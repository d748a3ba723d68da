"""The decoder LM (PyTorch port of ``repro.models.lm``).

One model class driven by ``ArchConfig``, like the JAX package's ``LM``,
for every family of its registry:

* dense / GQA / MQA / sliding-window attention   (granite, internlm2, danube)
* MoE FFN (top-k routed + shared experts)        (qwen2-moe, qwen3-moe, jamba)
* Mamba2 SSD layers, attention::Mamba2 interleave (mamba2, jamba)
* cross-attention every n-th layer on image embeddings (llama-3.2-vision)
* a frontend of precomputed frame embeddings     (musicgen)

The layers are grouped into super-blocks of ``period`` = lcm of the layer
patterns' periods (8 for jamba, 5 for llama-3.2-vision, 1 for the rest);
each super-block's sublayer j is an attention or a Mamba2 layer
(``is_attn_layer``), then a cross-attention to ``image_embeds`` where
``is_cross_attn_layer``, then an MoE or an MLP FFN (``is_moe_layer``; no
FFN in a pure SSM block).  The parameters are stacked on a leading
``nblocks`` axis under ``blocks/l{j}/…`` as in the JAX package's pytree,
and a Python loop over the super-blocks takes the place of ``lax.scan``.
An audio config (``frontend == "audio_frames"``) has no ``embed`` leaf: its
batches carry ``embeds`` (B, S, d_model) in place of ``tokens``.

The JAX package's three entry points:

* ``loss_fn``      — next-token cross-entropy for training, differentiable
                     by ``torch.autograd`` (``backward()``)
* ``prefill``      — full forward over a prompt returning logits + caches
* ``decode_step``  — one token against the K/V and SSM caches

A block's caches may mix K/V (attention sublayers) and SSM state and conv
tail (Mamba2 sublayers), as jamba's do; decode writes both in place.  The
cross-attention keeps no cache: every step recomputes its keys and values
from ``image_embeds``, as the JAX package does.  ``image_embeds`` (B,
image_tokens, d_model) is cast to the model's type once, at the model's
entry, as the audio frames are: the attention kernel takes q, k and v of
one type (the JAX package lets a float32 source promote the cross K/V to
float32 in a bf16 model).

Every attention and cross-attention layer goes through
``layers.attention_apply`` → ``ops.attention`` → the hand-written
flash-attention kernel on the card; under autograd its gradient is the
hand-written backward kernel.  The MoE FFN (``models.moe``) and the SSD
(``models.ssm``) have no TPU kernel in the JAX package and are plain
PyTorch here.  Given a mesh and ``moe_impl == "ep"``, prefill and training
route the MoE layers through the expert-parallel form
(``parallel.moe_ep``); decode, and any run without a mesh, take the TP
form, as the JAX package does.  ``LM`` reads no other lever of
``ArchConfig``: ``fsdp``, ``zero1``, ``tp_size`` and ``moe_impl``'s expert
layout are read by the sharding rules (``parallel.sharding``), which size
a cell per device, and ``micro_batches`` by the train cell
(``launch.specs.build_lm_cell``).  ``remat``, ``scan_barrier`` and
``seq_parallel`` steer XLA's partitioner and mean nothing here: the config
keeps them and nothing in the port reads them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.runtime.device import Device, resolve_device

Tree = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _lcm(*xs: int) -> int:
    out = 1
    for x in xs:
        if x:
            out = out * x // math.gcd(out, x)
    return out


class _MetaGenerator(torch.Generator):
    """A CPU generator that says it lies on the meta device: the layers'
    initialisers draw on ``generator.device``, and a draw on the meta device
    allocates nothing and consumes no state (PyTorch has no meta generator
    of its own)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class LM(nn.Module):
    """The decoder LM.

    An ``nn.Module`` for its place in PyTorch code (``device``, ``dtype``),
    but, like the JAX package's ``LM``, it holds no weights: every method
    takes the parameter tree (``init_params`` or ``convert.params_from_jax``)
    and the caches explicitly.  It runs on ``device`` — the card unless the
    caller passes ``device="cpu"`` — and raises on a host without a GPU
    otherwise.  ``mesh`` (a ``launch.mesh.Mesh``, this rank's view) is the
    distribution context of the expert-parallel MoE only: with it and
    ``cfg.moe_impl == "ep"`` every rank runs the whole model on the global
    batch and the MoE layers of prefill and training exchange tokens over
    the mesh's model axis.
    """

    def __init__(self, cfg: ArchConfig, device: Device = "cuda", mesh=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.period = _lcm(cfg.attn_every or 1,
                           cfg.moe_every if cfg.num_experts else 1,
                           cfg.cross_attn_every or 1)
        if cfg.num_layers % self.period:
            raise ValueError(
                f"{cfg.name}: num_layers {cfg.num_layers} not divisible by "
                f"super-block period {self.period}")
        self.nblocks = cfg.num_layers // self.period
        self.dtype = torch_dtype(cfg.dtype)

    # ------------------------------------------------------------------ init

    def _init_sublayer(self, generator: torch.Generator, j: int) -> Tree:
        """Sublayer j's leaves, exactly the JAX package's: ``norm1``, then
        ``attn`` or ``mamba``; ``xnorm`` and ``xattn`` on a cross-attention
        layer; ``norm2`` and ``moe`` or ``mlp`` — no ``norm2`` in a
        pure-SSM block (no FFN at all)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p: Tree = {"norm1": L.rmsnorm_init(cfg.d_model, dt, dev)}
        if cfg.is_attn_layer(j):
            p["attn"] = L.attention_init(generator, cfg.d_model,
                                         cfg.num_heads, cfg.num_kv_heads,
                                         cfg.hd, dt)
        else:
            p["mamba"] = ssm_lib.mamba_init(
                generator, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                cfg.ssm_expand, cfg.ssm_conv, dt)
        if cfg.is_cross_attn_layer(j):
            p["xnorm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
            p["xattn"] = L.attention_init(generator, cfg.d_model,
                                          cfg.num_heads, cfg.num_kv_heads,
                                          cfg.hd, dt)
        if cfg.is_moe_layer(j):
            p["norm2"] = L.rmsnorm_init(cfg.d_model, dt, dev)
            p["moe"] = moe_lib.moe_init(
                generator, cfg.d_model, cfg.d_ff, cfg.num_experts,
                cfg.num_shared_experts, cfg.shared_expert_ff, dt)
        elif cfg.d_ff > 0:
            p["norm2"] = L.rmsnorm_init(cfg.d_model, dt, dev)
            p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, dt)
        return p

    def init_params(self, generator: torch.Generator) -> Tree:
        """Random weights from ``generator`` (a ``torch.Generator`` on this
        model's device), with the JAX initialisers' distributions: matrices
        normal × 1/√fan_in, the embedding normal × 1, norms at 1.  Each
        super-block is drawn on its own and written into the stacked
        tensors, so no second copy of the weights is ever held; a single
        super-block (jamba cut to 8 layers is one of 49 GB) becomes the
        stack as it is, a view with the leading axis of 1.  An audio
        config has no ``embed`` leaf."""
        cfg, dt = self.cfg, self.dtype
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator lies on {generator.device}, the "
                             f"model on {self.device}")
        params: Tree = {}
        if cfg.frontend != "audio_frames":
            params["embed"] = L.embed_init(generator, cfg.vocab_size,
                                           cfg.d_model, dt)
        blocks: Optional[Tree] = None
        for b in range(self.nblocks):
            blk = {f"l{j}": self._init_sublayer(generator, j)
                   for j in range(self.period)}
            if self.nblocks == 1:
                blocks = tree_map(lambda t: t.unsqueeze(0), blk)
                break
            if blocks is None:
                blocks = tree_map(
                    lambda t: torch.empty((self.nblocks,) + tuple(t.shape),
                                          dtype=t.dtype, device=t.device),
                    blk)
            tree_map(lambda dst, src: dst[b].copy_(src), blocks, blk)
            del blk
            if self.device.type == "meta":
                break       # nothing is drawn there: one block shapes all
        params["blocks"] = blocks
        params["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, self.device)
        params["lm_head"] = L.lm_head_init(generator, cfg.d_model,
                                           cfg.vocab_size, dt)
        return params

    def abstract_params(self) -> Tree:
        """The tree of :meth:`init_params` on the meta device: its keys,
        shapes and dtypes, nothing allocated (the JAX package's
        ``jax.eval_shape`` of ``init_params``).  It is ``init_params``
        itself, run by a copy of this model on the meta device with a
        generator that draws there, so the two cannot drift apart."""
        return LM(self.cfg, device="meta").init_params(_MetaGenerator())

    def abstract_cache(self, batch: int, max_seq: int) -> Tree:
        """The caches of :meth:`init_cache` on the meta device."""
        return LM(self.cfg, device="meta").init_cache(batch, max_seq)

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch: int, max_seq: int) -> Tree:
        """Per-block decode caches, stacked on the block axis, zeros: an
        attention layer's ``{"k", "v"}`` of (nblocks, batch, KV, kv_len,
        hd), a Mamba2 layer's ``{"state"}`` (nblocks, batch, H, P, N)
        float32 and ``{"conv"}`` (nblocks, batch, k − 1, conv_dim).

        Sliding-window layers get a RING buffer of ``window`` slots instead
        of ``max_seq`` (slot = position mod window)."""
        cfg, nb = self.cfg, self.nblocks
        kv_len = max_seq
        if cfg.sliding_window > 0:
            kv_len = min(max_seq, cfg.sliding_window)
        out: Tree = {}
        for j in range(self.period):
            if cfg.is_attn_layer(j):
                shape = (nb, batch, cfg.num_kv_heads, kv_len, cfg.hd)
                out[f"l{j}"] = {
                    n: torch.zeros(shape, dtype=self.dtype,
                                   device=self.device) for n in ("k", "v")}
            else:
                one = ssm_lib.mamba_cache_init(
                    batch, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                    cfg.ssm_expand, cfg.ssm_conv, self.dtype,
                    device=self.device)
                out[f"l{j}"] = {n: t.expand((nb,) + t.shape).contiguous()
                                for n, t in one.items()}
        return out

    # --------------------------------------------------------------- forward

    def _block_apply(self, bp: Tree, x: torch.Tensor, *,
                     positions: torch.Tensor,
                     image_embeds: Optional[torch.Tensor],
                     bcache: Optional[Tree], mode: str, pos: Optional[int]):
        cfg = self.cfg
        decode = mode == "decode"
        newc: Tree = {}
        for j in range(self.period):
            lp = bp[f"l{j}"]
            h = L.rmsnorm(x, lp["norm1"])
            if cfg.is_attn_layer(j):
                kvc = None
                if decode:
                    kvc = (bcache[f"l{j}"]["k"], bcache[f"l{j}"]["v"])
                o, newkv = L.attention_apply(
                    lp["attn"], h, None,
                    num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                    hd=cfg.hd, causal=True, window=cfg.sliding_window,
                    positions=positions,
                    rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
                    kv_cache=kvc, cache_pos=pos if decode else None,
                )
                x = x + o
                if mode != "train":
                    newc[f"l{j}"] = {"k": newkv[0], "v": newkv[1]}
            else:
                o, newssm = ssm_lib.mamba_apply(
                    lp["mamba"], h,
                    d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                    expand=cfg.ssm_expand, chunk=cfg.ssm_chunk,
                    cache=bcache[f"l{j}"] if decode else None, decode=decode,
                )
                x = x + o
                if decode:              # the caches are written in place
                    for n, t in newssm.items():
                        bcache[f"l{j}"][n].copy_(t)
                if mode != "train":
                    newc[f"l{j}"] = newssm
            if cfg.is_cross_attn_layer(j):
                h = L.rmsnorm(x, lp["xnorm"])
                o, _ = L.attention_apply(
                    lp["xattn"], h, image_embeds,
                    num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                    hd=cfg.hd, causal=False, rope_theta=0.0)
                x = x + o
            if cfg.is_moe_layer(j):
                h = L.rmsnorm(x, lp["norm2"])
                if (cfg.moe_impl == "ep" and self.mesh is not None
                        and not decode):
                    from repro_torch.parallel.moe_ep import moe_apply_ep

                    x = x + moe_apply_ep(
                        lp["moe"], h,
                        experts_per_token=cfg.experts_per_token,
                        mesh=self.mesh,
                        capacity_factor=cfg.moe_capacity_factor)
                else:
                    x = x + moe_lib.moe_apply(
                        lp["moe"], h,
                        experts_per_token=cfg.experts_per_token)
            elif cfg.d_ff > 0:
                h = L.rmsnorm(x, lp["norm2"])
                x = x + L.mlp_apply(lp["mlp"], h)
        return x, newc

    def backbone(self, params: Tree, x: torch.Tensor, *,
                 positions: torch.Tensor,
                 image_embeds: Optional[torch.Tensor] = None,
                 caches: Optional[Tree] = None, mode: str = "train",
                 pos: Optional[int] = None):
        """Runs the block stack.  Returns (hidden, caches).

        ``image_embeds`` (B, image_tokens, d_model) are the cross-attention
        layers' keys' and values' source (a VLM config; the model's type).

        ``mode="train"`` keeps no caches and returns ``(hidden, None)``;
        ``mode="prefill"`` makes new stacked caches of the prompt's keys and
        values and the SSM layers' final states and conv tails;
        ``mode="decode"`` writes the step's keys and values, and the new SSM
        states and tails, into ``caches`` in place and returns them."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode must be train, prefill or decode, not "
                             f"{mode!r}")
        if mode == "train":
            # one unbind a stacked leaf (one stack of its gradient in
            # backward), not a t[b] select a block, whose backward would
            # build a zero gradient of the whole leaf for every block
            blocks = tree_map(lambda t: t.unbind(0), params["blocks"])
            for b in range(self.nblocks):
                x, _ = self._block_apply(
                    tree_map(lambda t: t[b], blocks), x, positions=positions,
                    image_embeds=image_embeds, bcache=None, mode=mode,
                    pos=None)
            return x, None
        out: Optional[Tree] = caches if mode == "decode" else None
        for b in range(self.nblocks):
            bp = tree_map(lambda t: t[b], params["blocks"])
            bc = (tree_map(lambda t: t[b], caches) if mode == "decode"
                  else None)
            x, newc = self._block_apply(bp, x, positions=positions,
                                        image_embeds=image_embeds,
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
        """The (B, S, d_model) inputs of the stack in the model's type: the
        embeddings of ``batch["tokens"]``, or an audio config's frame
        embeddings ``batch["embeds"]``."""
        if self.cfg.frontend == "audio_frames":
            return batch["embeds"].to(self.device, self.dtype)
        tokens = batch["tokens"].to(self.device).long()
        return params["embed"][tokens].to(self.dtype)

    def image_embeds(self, batch: Dict[str, torch.Tensor]):
        """``batch["image_embeds"]`` in the model's type on its device, or
        None."""
        img = batch.get("image_embeds")
        return None if img is None else img.to(self.device, self.dtype)

    def logits(self, params: Tree, hidden: torch.Tensor) -> torch.Tensor:
        h = L.rmsnorm(hidden, params["final_norm"])
        return h @ params["lm_head"]

    # ------------------------------------------------------------- losses

    def loss_fn(self, params: Tree,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (labels already shifted), a 0-d
        float32 tensor; ``loss.backward()`` fills the parameters' grads.

        The CE is *sequence-chunked*: chunks of ``cS = min(512, S)``
        positions, each chunk's float32 (B, cS, V) logits recomputed in
        backward (``torch.utils.checkpoint``, the counterpart of the JAX
        package's ``jax.checkpoint``), so no (B, S, V) float32 tensor is
        ever held; the chunks' sums are added in order and divided by B·S.
        B and S come from ``tokens``, or an audio batch's ``embeds``.
        """
        B, S = batch["embeds" if "embeds" in batch else "tokens"].shape[:2]
        cS = min(512, S)
        nchunks = S // cS
        if nchunks > 1 and S % cS:
            raise ValueError(f"sequence length {S} is not a multiple of the "
                             f"CE chunk {cS}")
        x = self.embed_inputs(params, batch)
        hidden, _ = self.backbone(
            params, x, positions=torch.arange(S, device=self.device),
            image_embeds=self.image_embeds(batch), mode="train")
        hidden = L.rmsnorm(hidden, params["final_norm"])
        labels = batch["labels"].to(self.device).long()
        if nchunks <= 1:
            return self._ce(params, hidden, labels)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for c in range(nchunks):
            sl = slice(c * cS, (c + 1) * cS)
            total = total + checkpoint(self._ce_sum, params["lm_head"],
                                       hidden[:, sl], labels[:, sl],
                                       use_reentrant=False)
        return total / (S * B)

    def _ce(self, params: Tree, hidden: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
        return self._ce_sum(params["lm_head"], hidden, labels) / (
            labels.shape[0] * labels.shape[1])

    @staticmethod
    def _ce_sum(lm_head: torch.Tensor, hidden: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        logits = (hidden @ lm_head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        return (logz - gold).sum()

    # ------------------------------------------------------------- serving

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]):
        """Forward over a full prompt ``batch["tokens"]`` (B, S) (an audio
        config's ``batch["embeds"]`` (B, S, d_model); a VLM's
        ``batch["image_embeds"]`` beside it); returns (logits (B, S,
        vocab), caches: K/V of (nblocks, B, KV, S, hd), SSM states and conv
        tails as ``init_cache`` shapes them)."""
        x = self.embed_inputs(params, batch)
        S = x.shape[1]
        hidden, caches = self.backbone(
            params, x, positions=torch.arange(S, device=self.device),
            image_embeds=self.image_embeds(batch), mode="prefill")
        return self.logits(params, hidden), caches

    def decode_step(self, params: Tree, caches: Tree,
                    batch: Dict[str, torch.Tensor], pos):
        """One decode step.  ``batch["tokens"]`` is (B, 1) (an audio
        config's ``batch["embeds"]`` (B, 1, d_model); a VLM's
        ``batch["image_embeds"]`` beside it, every step); ``pos`` (an int or
        a 0-d tensor) is its position.  The caches are updated in place and
        returned with the logits (B, 1, vocab)."""
        pos = int(pos)
        x = self.embed_inputs(params, batch)
        hidden, caches = self.backbone(
            params, x,
            positions=torch.full((1,), pos, dtype=torch.long,
                                 device=self.device),
            image_embeds=self.image_embeds(batch), caches=caches,
            mode="decode", pos=pos)
        return self.logits(params, hidden), caches


def build(cfg: ArchConfig, device: Device = "cuda", mesh=None) -> LM:
    return LM(cfg, device=device, mesh=mesh)
