"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name:

* ``configs/<config>.json``: the configuration's sizes, its source, what
  was assumed and what was reduced;
* ``traffic/<traffic>.json``: a traffic mix, the parameters of one of the
  general drivers in ``drivers/`` (named by its ``driver`` key);
* ``metrics/<metric>.py``: one reader a metric, ``read(rec)``, which takes
  the run's record and returns a number or ``None``;
* ``work/``: the operations and bytes a kernel or a step needs, and the
  card's peaks;
* ``reference/``: the plain PyTorch reference that decides ``correct``.

Nothing here imports JAX or the JAX package ``repro``, and the reference
imports nothing of ``repro_torch``.
"""
