"""Elastic scaling: reshard checkpointed state onto a different mesh, the
PyTorch counterpart of ``repro/distributed/elastic.py``.

Checkpoints store logical shapes (mesh-independent), so growing/shrinking the
pod count between restarts is a reshard: rebuild the specs for the new mesh
from the same logical axes and place each leaf. A leaf already placed on
another mesh is gathered to its full value first, then placed (each rank
keeps its shard).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.distributed.sharding import ParallelConfig, place_tree


def reshard_tree(tree, mesh, specs):
    """Place every leaf of ``tree`` according to ``specs`` on ``mesh``."""
    return place_tree(tree, mesh, specs)


def elastic_restore(model_builder, cfg, new_mesh, checkpoint_trees: Dict[str, Any]):
    """Rebuild a model + specs for ``new_mesh`` and place restored trees.

    model_builder: (cfg, ParallelConfig) -> model. ``checkpoint_trees``: the
    trees of ``fault_tolerance.load_checkpoint(..., template_trees=...)``
    (nested like the model's parameters), or trees placed on another mesh.
    Returns (model, placed trees); trees other than ``params`` pass through.
    """
    pc = ParallelConfig.from_mesh(new_mesh)
    model = model_builder(cfg, pc)
    placed = {}
    if "params" in checkpoint_trees:
        placed["params"] = reshard_tree(checkpoint_trees["params"], new_mesh,
                                        model.param_specs())
    for name, tree in checkpoint_trees.items():
        if name not in placed:
            placed[name] = tree
    return model, placed
