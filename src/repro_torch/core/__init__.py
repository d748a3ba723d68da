"""Core library of the PyTorch port: the paper's EM for LDA.

The typed containers, the E-step, folds and sweeps (``em``), the residual
scheduler (``scheduling``), the FOEM inner loop (``foem``), the streaming
trainer (``trainer``), held-out inference (§2.4 / eq. 21, ``perplexity``)
and the disk-backed parameter store (``streaming``).
"""
from repro_torch.core.types import (
    GlobalStats,
    InferPlan,
    InferResult,
    LDAConfig,
    LocalState,
    MinibatchData,
    SchedulerState,
    SweepPlan,
    SweepResult,
    from_numpy,
    uniform_responsibilities,
)
from repro_torch.core import em, foem, perplexity, scheduling
from repro_torch.core.streaming import (
    CacheStats,
    HotRowCache,
    ParameterStore,
    StoreStats,
    StreamPrefetcher,
    store_from_arrays,
)
from repro_torch.core.trainer import FOEMTrainer, StepMetrics

__all__ = [
    "GlobalStats",
    "InferPlan",
    "InferResult",
    "LDAConfig",
    "LocalState",
    "MinibatchData",
    "SchedulerState",
    "SweepPlan",
    "SweepResult",
    "from_numpy",
    "uniform_responsibilities",
    "em",
    "foem",
    "perplexity",
    "scheduling",
    "CacheStats",
    "FOEMTrainer",
    "HotRowCache",
    "ParameterStore",
    "StepMetrics",
    "StoreStats",
    "StreamPrefetcher",
    "store_from_arrays",
]
