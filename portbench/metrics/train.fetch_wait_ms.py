"""train.fetch_wait_ms: mean StepMetrics.fetch_seconds a step, the wait
for the prefetcher's staged rows (core/trainer.py, core/streaming.py
StreamPrefetcher)."""
from portbench import readers


def read(rec):
    steps = readers.steps(rec)
    return None if steps is None else 1e3 * readers.mean(
        s["fetch_s"] for s in steps)
