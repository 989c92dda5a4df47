"""The benchmark of the PyTorch/H100 port (``gat_recommendation_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything a cell is made of is found
by name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (which names
its entry, ``entries/<entry>.py``), ``limits/<cell>.json`` and, for each
per-layer metric, ``metrics/<metric>.py``. ``reference/`` is the plain
PyTorch/NumPy reference that decides ``correct``; it imports nothing of the
program. ``yardstick/`` holds the peaks and the reduction of the profiler's
trace. Nothing here imports ``jax`` or the JAX package.
"""
