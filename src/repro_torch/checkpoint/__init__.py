"""Crash-consistent checkpoints (``ckpt``) and elastic re-sharding between
mesh shapes (``elastic``), in the JAX package's on-disk format."""
from repro_torch.checkpoint.ckpt import (
    CheckpointCorruptionError,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    scan_checkpoints,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from repro_torch.checkpoint.elastic import (
    PartitionSpec,
    reshard,
    restore_resharded,
)

__all__ = [
    "CheckpointCorruptionError",
    "PartitionSpec",
    "latest_step",
    "reshard",
    "restore_checkpoint",
    "restore_resharded",
    "save_checkpoint",
    "scan_checkpoints",
    "tree_flatten",
    "tree_map",
    "tree_unflatten",
]
