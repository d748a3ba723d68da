"""Core library of the PyTorch port: the paper's EM for LDA.

The typed containers, the E-step, folds and sweeps (``em``), the residual
scheduler (``scheduling``), the FOEM inner loop (``foem``), the SEM baseline
(``sem``), the paper's other online baselines OVB, SCVB and OGS
(``baselines``), the streaming trainer (``trainer``), held-out inference
(§2.4 / eq. 21, ``perplexity``), the disk-backed parameter store with the
lifelong snapshot publisher (``streaming``) and the topic-shift detector
(``scheduling``).
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
from repro_torch.core import baselines, em, foem, perplexity, scheduling, sem
from repro_torch.core.scheduling import ShiftDetector, ShiftEvent
from repro_torch.core.streaming import (
    CacheStats,
    HotRowCache,
    ParameterStore,
    PhiSnapshot,
    SnapshotPublisher,
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
    "baselines",
    "em",
    "foem",
    "perplexity",
    "scheduling",
    "sem",
    "CacheStats",
    "FOEMTrainer",
    "HotRowCache",
    "ParameterStore",
    "PhiSnapshot",
    "ShiftDetector",
    "ShiftEvent",
    "SnapshotPublisher",
    "StepMetrics",
    "StoreStats",
    "StreamPrefetcher",
    "store_from_arrays",
]
