"""Sharding of the port: the reference's logical-axis rules onto
``torch.distributed`` device meshes and DTensor placements."""
from .specs import (Rules, SERVE_RULES, TRAIN_RULES, batch_spec, resolve_spec,
                    tree_shardings, tree_specs)
from .context import activation_sharding, constrain

__all__ = ["Rules", "SERVE_RULES", "TRAIN_RULES", "batch_spec",
           "resolve_spec", "tree_shardings", "tree_specs",
           "activation_sharding", "constrain"]
