"""Sharding of the port on torch ``DeviceMesh`` / DTensor.

Port of ``repro.sharding``: ``abstract_mesh`` (``compat``), the
logical-axis rules and their tree builders (``specs``), and the active
mesh the model's hooks read (``context``: ``use_mesh``, the counterpart of
the reference's ``with mesh:``). Importing it opens no process group.
"""
from repro_torch.sharding.compat import AbstractMesh, abstract_mesh, \
    mesh_shape
from repro_torch.sharding.context import current, use_mesh
from repro_torch.sharding.specs import (
    NamedSharding, ShardingRules, batch_shardings, cache_shardings,
    distribute, local_nbytes, logits_sharding, opt_state_shardings,
    param_shardings, placements, replicated)

__all__ = [
    "AbstractMesh", "abstract_mesh", "mesh_shape", "use_mesh", "current",
    "NamedSharding", "ShardingRules", "placements", "param_shardings",
    "opt_state_shardings", "cache_shardings", "batch_shardings",
    "logits_sharding", "replicated", "distribute", "local_nbytes",
]
