"""scheduled_sweep_roofline: the scheduled sweeps' least time (on their A
active topics an entry) over the device time of scheduled_sweep's kernels
(its copy and zero passes and its active loop), in %."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    t = readers.device_seconds(rec, readers.SCHEDULED_SWEEP)
    if steps is None or t is None:
        return None
    cfg = rec["cfg"]
    least = sum(readers.sweeps_by_kind(s, cfg)[1]
                * readers.bound(readers.scheduled_work(s, cfg)) for s in steps)
    return readers.share(least, t)
