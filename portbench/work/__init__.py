"""The yardstick: the card's peaks (``peaks.py``) and the operations and
bytes that a kernel call or a step needs (``counts.py``)."""
