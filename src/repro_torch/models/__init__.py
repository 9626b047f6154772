"""Model stack of the port (dense decoder)."""
