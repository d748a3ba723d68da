"""train.compute_ms: mean StepMetrics.compute_seconds a step: the copies
in, the FOEM inner loop (core/foem.py) and the copies out."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    return None if steps is None else 1e3 * readers.mean(
        s["compute_s"] for s in steps)
