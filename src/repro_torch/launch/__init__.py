"""Entry points of the port.  ``python -m repro_torch.launch.serve`` is the
serving CLI (``serve.main``); ``python -m repro_torch.launch.train`` the
streaming FOEM training CLI (``train.main``)."""
