"""train_tokens_per_s: the real tokens of all the window's steps over the
window's whole time (host clock)."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    if steps is None or rec["window_s"] <= 0:
        return None
    return sum(s["tokens"] for s in steps) / rec["window_s"]
