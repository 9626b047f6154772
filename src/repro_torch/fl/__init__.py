"""Federated-learning strategy axes of the port (the reference's ``repro.fl``):
``local_algos`` (``gd`` | ``fedprox`` | ``scaffold``) and ``workloads``
(``iid`` | ``quantity-skew`` | ``length-skew`` | ``dirichlet``)."""
