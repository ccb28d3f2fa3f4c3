"""A device-free mesh description, the port of ``repro.sharding.compat``.

The reference's ``abstract_mesh(sizes, names)`` builds a
``jax.sharding.AbstractMesh``: axis names and sizes with no devices,
enough for the sharding rules. Here it is ``AbstractMesh``, a frozen
mapping of the same names to the same sizes; a real ``DeviceMesh``
(``launch.mesh``) answers the same ``.shape`` through ``mesh_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in mesh order (``jax``'s ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    sizes: Tuple[int, ...] = tuple(int(s) for s in axis_sizes)
    names: Tuple[str, ...] = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} sizes vs {len(names)} names")
    return AbstractMesh(sizes, names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the sharding rules need a mesh with named dims")
    return dict(zip(names, mesh.mesh.shape))
