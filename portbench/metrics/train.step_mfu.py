"""train.step_mfu: the whole step's least time on the card (the larger of
its counted FLOPs over the float32 peak and its counted HBM bytes over the
HBM peak) over the mean step time, in %."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    if steps is None:
        return None
    cfg = rec["cfg"]
    least = sum(readers.bound(readers.step_work(s, cfg)) for s in steps)
    return readers.share(least, sum(s["seconds"] for s in steps))
