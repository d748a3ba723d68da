"""train.device_idle: the share of the traced window in which no
operation ran on the card, in %."""
from portbench import readers


def read(rec):
    return readers.idle_percent(rec) if readers.steps(rec) else None
