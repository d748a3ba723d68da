"""setup_s: seconds from the harness's first statement to the window's
start (loading, building the kernels, warm-up, the checked steps)."""


def read(rec):
    return rec.get("setup_s")
