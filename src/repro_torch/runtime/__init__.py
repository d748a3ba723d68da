"""Runtime fault tolerance.  This slice of the port carries the seeded
fault-injection harness that ``ParameterStore.flush`` fires; straggler
mitigation, bounded-staleness merging and the elastic driver come with the
runtime slice."""
from repro_torch.runtime.faults import (
    ANY_STEP,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    MID_FLUSH,
    POINTS,
    POST_FOLD,
    PRE_PROBE,
    PRE_PUBLISH,
    active_plan,
    fire_active,
    get_active,
)

__all__ = [
    "ANY_STEP",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "MID_FLUSH",
    "POINTS",
    "POST_FOLD",
    "PRE_PROBE",
    "PRE_PUBLISH",
    "active_plan",
    "fire_active",
    "get_active",
]
