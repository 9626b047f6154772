"""The reference's ``examples/`` on the port, each a module run as
``python -m repro_torch.examples.<name> [--device cpu]`` (the card unless
``--device cpu``). Importing one runs nothing."""
