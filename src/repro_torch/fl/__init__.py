"""Federated-learning strategies of the port (the reference's ``repro.fl``)."""
