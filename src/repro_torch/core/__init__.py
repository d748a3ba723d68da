"""Core library of the PyTorch port: the paper's EM for LDA, serving half.

This slice carries the typed containers, the eq. 9/10 normalisations, the
active-set selection, held-out inference (§2.4 / eq. 21) and the
disk-backed parameter store; the training loop comes with the next slice.
"""
from repro_torch.core.types import (
    InferPlan,
    InferResult,
    LDAConfig,
    MinibatchData,
    uniform_responsibilities,
)
from repro_torch.core import em, perplexity, scheduling
from repro_torch.core.streaming import (
    CacheStats,
    HotRowCache,
    ParameterStore,
    StoreStats,
    store_from_arrays,
)

__all__ = [
    "InferPlan",
    "InferResult",
    "LDAConfig",
    "MinibatchData",
    "uniform_responsibilities",
    "em",
    "perplexity",
    "scheduling",
    "CacheStats",
    "HotRowCache",
    "ParameterStore",
    "StoreStats",
    "store_from_arrays",
]
