"""Entry points of the port.  ``python -m repro_torch.launch.serve`` is the
serving CLI (``serve.main``)."""
