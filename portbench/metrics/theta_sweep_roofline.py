"""theta_sweep_roofline: the θ-sweep calls' least time (work/counts.py's
theta_chunk, by entry and topic) over the device time of the theta_sweep
kernels, in %."""
from portbench import readers


def read(rec):
    launches = readers.launches(rec)
    t = readers.device_seconds(rec, readers.THETA_SWEEP)
    if launches is None or t is None:
        return None
    cfg = rec["cfg"]
    least = sum(readers.chunks(b, cfg)
                * readers.bound(readers.chunk_work(b, cfg))
                for b in launches)
    return readers.share(least, t)
