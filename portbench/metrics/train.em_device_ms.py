"""train.em_device_ms: device ms a step of every operation that is neither
a port kernel nor a copy: core/em.py and core/scheduling.py's segment
sums, sorts, gathers and index_put_ (the trace)."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    s = readers.other_device_seconds(rec)
    if steps is None or s is None:
        return None
    return 1e3 * s / len(steps)
