"""serve.p95_ms: the 95th percentile of submit-to-resolution latency over
every request resolved inside the window; a failed request counts as
infinitely late."""
import numpy as np


def read(rec):
    if rec.get("kind") != "serve" or not rec["latencies_ms"]:
        return None
    return float(np.percentile(np.asarray(rec["latencies_ms"]), 95))
