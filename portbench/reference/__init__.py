"""The plain reference: float32 PyTorch, TF32 off, no kernel, no cache and
nothing of the program. It takes the benchmark's own weights, adapters and
tokens (``harness/weights.py``) and works everything else out itself."""
