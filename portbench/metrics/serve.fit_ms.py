"""serve.fit_ms: mean host ms a launch of the fit: the copy in, eq. 10,
ops.infer (theta_sweep) and θ back."""
from portbench import readers


def read(rec):
    launches = readers.launches(rec)
    return None if launches is None else 1e3 * readers.mean(
        b["fit_seconds"] for b in launches)
