"""Strategy registries of the port (the reference's ``repro.api``)."""
