"""Data pipelines of the port (the reference's ``repro.data``)."""
