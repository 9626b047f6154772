"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

Everything here is general: a cell is found by its name in
``BENCHMARK.json``, its configuration in ``configs/<name>.json``, its
traffic in ``traffic/<name>.json`` (whose ``kind`` names one of the
generators in ``harness/kinds/``), and each metric in
``metrics/<name>.py``. Nothing here imports ``jax`` or the JAX package.
"""
