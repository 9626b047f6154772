"""Batched prefill + decode of the port."""
