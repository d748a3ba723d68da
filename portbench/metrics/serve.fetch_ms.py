"""serve.fetch_ms: mean host ms a launch of TopicServer's row fetch (the
store's rows and the W_s padding)."""
from portbench import readers


def read(rec):
    launches = readers.launches(rec)
    return None if launches is None else 1e3 * readers.mean(
        b["fetch_seconds"] for b in launches)
