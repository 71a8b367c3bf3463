"""The benchmark of the PyTorch and CUDA port (``polgen_rvc_tpu_torch``).

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line. Everything else is found by name: a configuration
in ``configs/<config>.json``, a traffic mix in ``traffic/<mix>.json``, a
per-layer metric's reader in ``metrics/<metric>.py``. ``reference/`` is
the plain PyTorch and NumPy path that decides ``correct``; it imports
nothing of the port.
"""
