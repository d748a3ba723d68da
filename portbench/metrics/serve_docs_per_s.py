"""serve_docs_per_s: the documents resolved inside the window over the
window's whole time (host clock)."""


def read(rec):
    if rec.get("kind") != "serve" or rec["window_s"] <= 0:
        return None
    return rec["resolved"] / rec["window_s"]
