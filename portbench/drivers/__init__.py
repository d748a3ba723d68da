"""The general drivers that traffic mixes name (``traffic/<mix>.json``'s
``driver`` key): ``train_stream`` and ``serve_closed``.  A driver builds
the program's objects from a configuration, warms them up, runs the
measured window, frees the program and then checks its outputs against
the reference."""
