"""train.writeback_ms: mean StepMetrics.writeback_seconds a step
(core/streaming.py ParameterStore.write_rows)."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    return None if steps is None else 1e3 * readers.mean(
        s["writeback_s"] for s in steps)
