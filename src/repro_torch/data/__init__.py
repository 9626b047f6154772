"""Data pipelines of the port (the reference's ``repro.data``)."""

from repro_torch.data.tokens import TokenStream, synthetic_lm_batch
from repro_torch.data.blog_feedback import BlogFeedback
from repro_torch.data.partition import dirichlet_partition, iid_partition

__all__ = [
    "TokenStream",
    "synthetic_lm_batch",
    "BlogFeedback",
    "dirichlet_partition",
    "iid_partition",
]
