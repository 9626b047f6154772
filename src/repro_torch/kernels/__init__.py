"""Hand-written CUDA kernels of the port, one per Pallas kernel of the
reference on the ported path. Each has ``<name>.py`` (the ctypes binding of
``csrc/<name>.cu``), a wrapper ``*_ops.py`` and its plain PyTorch version
``*_ref.py``."""
