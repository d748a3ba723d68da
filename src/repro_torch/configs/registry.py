"""Architecture registry of the port: ``--arch <id>`` resolution.

The port's copy of ``repro.configs.registry``: a lazy allowlist of
(arch name → config module) pairs, importing a config module only when its
config is requested.  It lists every LM arch of the JAX package's
registry, all of which the port's ``models.LM`` serves (prefill and cached
decode) and trains (``loss_fn``): the dense decoders, the MoE decoders
(qwen2-moe, qwen3-moe), the attention-free Mamba2 SSM, the hybrid
attention/Mamba2/MoE stack (jamba), the VLM with cross-attention to image
embeddings (llama-3.2-vision) and the decoder over audio frame embeddings
(musicgen).
"""
from __future__ import annotations

import importlib
from collections.abc import Mapping
from typing import Dict, Iterator, List

from repro_torch.configs.base import ArchConfig, ShapeConfig

#: Every LM arch the port accepts, and the only modules the registry will
#: ever import for one.
TEMPLATE_ARCHS: Dict[str, str] = {
    "granite-20b": "repro_torch.configs.granite_20b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}


class _LazyArchs(Mapping):
    """Mapping with the allowlist's keys that imports a config module only
    on first access to its config."""

    def __init__(self) -> None:
        self._cache: Dict[str, ArchConfig] = {}

    def __getitem__(self, name: str) -> ArchConfig:
        if name not in self._cache:
            if name not in TEMPLATE_ARCHS:
                raise KeyError(name)
            mod = importlib.import_module(TEMPLATE_ARCHS[name])
            cfg = mod.CONFIG
            if cfg.name != name:
                raise RuntimeError(
                    f"registry allowlist names {name!r} but "
                    f"{TEMPLATE_ARCHS[name]} declares {cfg.name!r}"
                )
            self._cache[name] = cfg
        return self._cache[name]

    def __iter__(self) -> Iterator[str]:
        return iter(TEMPLATE_ARCHS)

    def __len__(self) -> int:
        return len(TEMPLATE_ARCHS)


ARCHS: Mapping = _LazyArchs()


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def get_shape(arch: ArchConfig, shape_name: str) -> ShapeConfig:
    for s in arch.shapes():
        if s.name == shape_name:
            return s
    raise KeyError(
        f"shape {shape_name!r} not available for {arch.name} "
        f"(skipped: {arch.skipped_shapes()})"
    )
