"""Architecture registry of the port: ``--arch <id>`` resolution.

The port's copy of ``repro.configs.registry``: a lazy allowlist of
(arch name → config module) pairs, importing a config module only when its
config is requested.  It lists the dense decoder archs that the port's
``models.LM`` serves (prefill and KV-cache decode); the MoE, SSM, hybrid,
VLM and audio archs of the JAX package wait for their modules (ROADMAP.md,
queue 1 item 10).
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
