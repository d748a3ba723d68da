"""Runtime fault tolerance: the seeded fault-injection harness
(``faults``), straggler mitigation and bounded-staleness merging
(``fault_tolerance``), and the elastic FOEM runtime (``elastic``).

``repro_torch.runtime.elastic`` is not imported here: it depends on
``repro_torch.core``, while ``faults``/``fault_tolerance`` are
dependency-light and imported *by* the core layers — an eager import would
cycle.
"""
from repro_torch.runtime.fault_tolerance import (
    BoundedStalenessMerger,
    StragglerMonitor,
)
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
    "BoundedStalenessMerger",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "MID_FLUSH",
    "POINTS",
    "POST_FOLD",
    "PRE_PROBE",
    "PRE_PUBLISH",
    "StragglerMonitor",
    "active_plan",
    "fire_active",
    "get_active",
]
