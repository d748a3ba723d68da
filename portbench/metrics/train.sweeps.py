"""train.sweeps: mean inner-loop sweeps a step (StepMetrics.sweeps)."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    return None if steps is None else readers.mean(
        s["sweeps"] for s in steps)
