"""serve.launch_mfu: a whole launch's least time on the card (the larger
of its counted FLOPs over the float32 peak and its counted HBM bytes over
the HBM peak) over the mean launch time, in %."""
from portbench import readers


def read(rec):
    launches = readers.launches(rec)
    if launches is None:
        return None
    cfg = rec["cfg"]
    least = sum(readers.bound(readers.launch_work(b, cfg))
                for b in launches)
    return readers.share(least, sum(b["launch_seconds"] for b in launches))
