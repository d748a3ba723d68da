"""Config dataclasses: architectures, input shapes, meshes.

The port's copy of ``repro.configs.base``, unchanged: the LM stack
(``repro_torch.models``) reads it.  The pjit levers are kept so that a
config reads the same in both packages: ``fsdp``, ``zero1``, ``tp_size``
and ``moe_impl`` are read by the sharding rules (``parallel.sharding``;
``moe_impl`` also by ``models.lm`` under a mesh), ``micro_batches`` by the
train cell (``launch.specs.build_lm_cell``); ``remat``, ``scan_barrier``
and ``seq_parallel`` steer XLA only, and the port reads them nowhere.

Every assigned architecture gets one ``ArchConfig`` in its own module under
``repro.configs``; input-shape sets are ``ShapeConfig`` tuples attached per
family.  Configs are *exact* (full production sizes); smoke tests call
``.reduced()`` for a CPU-sized variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input shape × step kind) cell of the dry-run grid."""

    name: str              # train_4k | prefill_32k | decode_32k | long_500k | ...
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode"), self.kind


# The LM-family shape set shared by all 10 assigned architectures.
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyperparameters (superset across the assigned families)."""

    name: str
    family: str                 # dense | ssm | moe | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    # --- attention flavour ---
    sliding_window: int = 0     # >0: SWA (h2o-danube)
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    shared_expert_ff: int = 0
    moe_every: int = 1          # MoE FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0         # hybrid: attention on layers (i % attn_every == attn_offset)
    attn_offset: int = 0
    # --- multimodal stubs ---
    frontend: str = "none"      # none | audio_frames | image_patches
    cross_attn_every: int = 0   # vlm: cross-attention on every n-th layer
    image_tokens: int = 0
    # --- numerics / perf knobs (hillclimb levers) ---
    dtype: str = "bfloat16"
    remat: str = "none"         # none | full | dots
    use_scan: bool = True
    micro_batches: int = 1      # gradient-accumulation microbatches
    fsdp: bool = False          # shard params/opt over the data axis too
    zero1: bool = False         # shard ONLY optimizer state over data
                                # (ZeRO-1: params stay TP; one gather/step)
    moe_impl: str = "tp"        # tp (baseline) | ep (shard_map all_to_all)
    moe_capacity_factor: float = 2.0  # EP dispatch capacity (§Perf lever)
    tp_size: int = 0            # 0: TP over the full model axis (baseline);
                                # 1: no TP — model axis becomes extra DP and
                                # params go ZeRO-3 over (data×model) (§Perf)
    scan_barrier: bool = False  # optimization_barrier on block params inside
                                # the layer scan: pins ZeRO-3 weight gathers
                                # in-loop instead of letting XLA hoist the
                                # full gathered stack into live memory
    seq_parallel: bool = False  # keep the residual stream sequence-sharded
                                # over `model` between blocks (Megatron-SP;
                                # EP consumes seq-shards natively)
    long_context_ok: bool = False  # sub-quadratic path exists (long_500k cell)
    notes: str = ""

    # ------------------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every:
            return i % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.num_experts:
            return False
        return i % self.moe_every == self.moe_offset

    def is_cross_attn_layer(self, i: int) -> bool:
        return bool(self.cross_attn_every) and (
            i % self.cross_attn_every == self.cross_attn_every - 1
        )

    # ------------------------------------------------------------------

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
        total = V * D + D * V        # embed + lm_head (untied)
        total += D                   # final norm
        for i in range(self.num_layers):
            if self.is_attn_layer(i):
                total += D + D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
            else:                    # mamba2 block
                din, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                conv_dim = din + 2 * ns
                total += D + D * (2 * din + 2 * ns + nh)   # norm + in_proj
                total += conv_dim * self.ssm_conv          # conv
                total += nh * 2 + nh                       # A_log, D, dt_bias
                total += din * D                           # out_proj
            if self.is_cross_attn_layer(i):
                total += D + D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
            # FFN
            if self.is_moe_layer(i):
                total += D * self.num_experts              # router
                total += self.num_experts * 3 * D * F
                if self.num_shared_experts:
                    total += 3 * D * self.shared_expert_ff
                total += D                                 # mlp norm
            elif F > 0:
                total += 3 * D * F + D
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense = self.param_count()
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                dense -= (self.num_experts - self.experts_per_token) * 3 * D * F
        return dense

    def reduced(self) -> "ArchConfig":
        """CPU-sized variant of the same family for smoke tests."""
        import math as _math

        period = 1
        for p in (self.attn_every, self.moe_every if self.num_experts else 1,
                  self.cross_attn_every):
            if p:
                period = period * p // _math.gcd(period, p)
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, period if period > 1 else 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=256 if self.d_ff else 0,
            head_dim=32,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            shared_expert_ff=min(self.shared_expert_ff, 256) if self.shared_expert_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            image_tokens=min(self.image_tokens, 16) if self.image_tokens else 0,
            dtype="float32",
            use_scan=True,
        )

    def shapes(self) -> Tuple[ShapeConfig, ...]:
        """The arch's shape cells; long_500k only if sub-quadratic."""
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.long_context_ok:
                continue
            out.append(s)
        return tuple(out)

    def skipped_shapes(self) -> Tuple[str, ...]:
        return tuple(
            s.name for s in LM_SHAPES if s.name == "long_500k" and not self.long_context_ok
        )
