"""Sharding for the port: logical-axis rules, the ambient context, and
``spawn`` for starting ranks."""
from repro_torch.distributed.context import constrain, current_context, sharding_context
from repro_torch.distributed.sharding import (
    FSDP_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    AxisRules,
    P,
    logical_to_spec,
    shard_tree,
    spec_tree,
)

__all__ = ["AxisRules", "FSDP_RULES", "P", "SERVE_RULES", "TRAIN_RULES", "constrain",
           "current_context", "logical_to_spec", "shard_tree", "sharding_context",
           "spec_tree"]
