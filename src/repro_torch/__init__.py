"""PyTorch + CUDA port of the FedsLLM system (``repro``), for one NVIDIA H100.

Imports ``torch`` and never ``jax`` or ``repro``. Every Pallas kernel of the
reference on the ported path is a hand-written CUDA kernel under ``csrc/``,
built at first use by ``kernels/_build.py``; each keeps a plain PyTorch
version beside it, which runs only for tensors on the CPU.
"""
