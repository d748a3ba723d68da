"""serve.fill: mean documents a launch over the launch's capacity
(AdmissionRouter's batch_log filled / capacity), in %."""
from portbench import readers


def read(rec):
    launches = readers.launches(rec)
    return None if launches is None else 100.0 * readers.mean(
        b["filled"] / b["capacity"] for b in launches)
