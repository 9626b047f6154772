"""LoRA adapters of the port."""
