"""Split-learning pipelining and the logical-axis sharding rules (the port of
``repro/parallel``: ``pipeline.py``'s microbatched split step and latency
model; ``sharding.py``'s rule sets and spec math on the one-card mesh)."""

from repro_torch.parallel.sharding import (RULESETS, activation_rules, active_context,
                                           set_context, shard, sharding_context, spec_for)

__all__ = ["RULESETS", "activation_rules", "active_context", "set_context", "shard",
           "sharding_context", "spec_for"]
