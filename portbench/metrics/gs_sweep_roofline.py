"""gs_sweep_roofline: the dense sweeps' least time (work/counts.py's
dense_sweep, by entry and topic) over gs_loop_kernel's device time, in %."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    t = readers.device_seconds(rec, readers.GS_SWEEP)
    if steps is None or t is None:
        return None
    cfg = rec["cfg"]
    least = sum(readers.sweeps_by_kind(s, cfg)[0]
                * readers.bound(readers.dense_work(s, cfg)) for s in steps)
    return readers.share(least, t)
