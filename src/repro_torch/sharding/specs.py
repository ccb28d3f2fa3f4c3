"""Logical-axis -> mesh sharding rules, on torch ``DeviceMesh`` / DTensor.

Port of ``repro.sharding.specs``. Every ParamSpec carries logical axis
names ("embed", "heads", "ffn", "expert", "vocab", "batch", "cache_seq",
...). This module maps them onto the production mesh:

  single pod : ("data", "model") = (16, 16)          -- 256 devices
  multi-pod  : ("pod", "data", "model") = (2, 16, 16) -- 512 devices

The rules are the reference's, line for line:

  * params: tensor-parallel over "model" via ``MODEL_PRIORITY`` (experts
    first, then heads / ffn / vocab, falling back to the d_model axis when
    the preferred axis does not divide, e.g. qwen2-vl's 12 heads on a
    16-way axis). With ``fsdp=True`` a second, different axis is sharded
    over "data" (``FSDP_PRIORITY``).
  * the "pod" axis shards the batch only; params replicate across pods.
  * KV caches: batch -> "data" (+"pod"), and, when the batch-sharded leaf
    is at least ``cache_model_shard_threshold`` bytes, kv_heads ->
    "model" when divisible, else cache_seq -> "model". Recurrent states
    always shard ssm_inner / heads over "model".
  * divisibility is always checked; non-divisible axes stay replicated.

A partition spec is a plain tuple with one entry per tensor dim: None, an
axis name, or a tuple of names (the reference's ``PartitionSpec``
entries). ``placements(pspec, mesh)`` turns it into DTensor placements,
one per mesh dim: ``Shard(d)`` where the mesh dim names an entry of
tensor dim d, else ``Replicate()``; a tuple entry ("pod", "data") shards
its dim over both mesh dims, pod-major, as JAX's does.
``ShardingRules.named`` binds a spec to the rules' mesh
(``NamedSharding``), and ``distribute`` lays a tree of tensors out by a
tree of them.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch

from repro_torch.sharding.compat import mesh_shape

if TYPE_CHECKING:                    # the model's layers import this package
    from repro_torch.models.layers import ParamSpec


# logical axes eligible for the tensor ("model") dimension, in priority
MODEL_PRIORITY = ("expert", "heads", "heads_flat", "kv_heads", "ffn",
                  "moe_ffn", "ssm_inner", "vocab", "embed_out", "embed")
# logical axes eligible for the fsdp ("data") dimension, in priority
FSDP_PRIORITY = ("embed", "vocab", "ffn", "moe_ffn", "ssm_inner", "expert",
                 "heads", "heads_flat", "embed_out")

PSpec = Tuple[Any, ...]


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(pspec: PSpec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``pspec`` on ``mesh`` (one per mesh dim). A
    mesh dim of size 1 replicates: its one shard is the whole tensor, and
    DTensor's view rules refuse some reshapes of a dim "sharded" over it
    (a batch of 1 flattened into the rows of a matmul)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in mesh_shape(mesh).items():
        dims = [d for d, e in enumerate(pspec) if name in _entry_axes(e)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} used twice in {pspec}")
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec bound to a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PSpec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)

    def local_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The per-device shape of a global ``shape`` (every sharded dim
        divides: the rules check it)."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for d, e in enumerate(self.spec):
            for a in _entry_axes(e):
                out[d] //= sizes[a]
        return tuple(out)


class ShardingRules:
    def __init__(self, mesh, *, fsdp: bool = True,
                 cache_model_shard_threshold: float = 0.5e9):
        self.mesh = mesh
        self.fsdp = fsdp
        shape = mesh_shape(mesh)
        self.shape = shape
        self.model_size = shape.get("model", 1)
        self.data_size = shape.get("data", 1)
        self.pod = "pod" in shape
        self.batch_axes: Tuple[str, ...] = (
            ("pod", "data") if self.pod else ("data",))
        # KV caches only shard their seq axis over "model" when the
        # batch-sharded leaf exceeds this (bytes); small caches replicate
        # over model and skip the per-attention KV gather
        self.cache_model_shard_threshold = cache_model_shard_threshold

    def _batch_parts(self) -> int:
        parts = 1
        for a in self.batch_axes:
            parts *= self.shape[a]
        return parts

    # ------------------------------------------------------------ params --
    def param_pspec(self, s: ParamSpec) -> PSpec:
        axes = list(s.axes)
        assign: Dict[int, str] = {}
        for name in MODEL_PRIORITY:
            if name in axes:
                i = axes.index(name)
                if s.shape[i] % self.model_size == 0 and s.shape[i] > 0:
                    assign[i] = "model"
                    break
        if self.fsdp:
            for name in FSDP_PRIORITY:
                if name in axes:
                    i = axes.index(name)
                    if i in assign:
                        continue
                    if s.shape[i] % self.data_size == 0 and s.shape[i] > 0:
                        assign[i] = "data"
                        break
        return tuple(assign.get(i) for i in range(len(axes)))

    # ------------------------------------------------------------- cache --
    def cache_pspec(self, s: ParamSpec) -> PSpec:
        axes = list(s.axes)
        out: list = [None] * len(axes)
        parts = self._batch_parts()
        for i, name in enumerate(axes):
            if name == "batch" and s.shape[i] % parts == 0:
                # batch=1 long-context: replicate rather than 0-size shards
                out[i] = self.batch_axes if len(self.batch_axes) > 1 \
                    else self.batch_axes[0]

        def try_axis(name):
            if name in axes:
                i = axes.index(name)
                if out[i] is None and s.shape[i] % self.model_size == 0 \
                        and s.shape[i] > 0:
                    out[i] = "model"
                    return True
            return False
        # per-device leaf bytes after batch sharding (dtype <= 4B assumed);
        # batch=1 long-context caches cannot batch-shard, so don't divide
        elems = 1
        for d in s.shape:
            elems *= d
        batch_parts = parts
        if "batch" in axes and s.shape[axes.index("batch")] % batch_parts:
            batch_parts = 1
        approx_bytes = elems * 2 / batch_parts
        if "cache_seq" in axes or "kv_heads" in axes:
            if approx_bytes >= self.cache_model_shard_threshold:
                try_axis("kv_heads") or try_axis("cache_seq")
        else:
            # recurrent states are rewritten every decode step: always shard
            try_axis("ssm_inner") or try_axis("heads")
        return tuple(out)

    # ------------------------------------------------------------- batch --
    def batch_pspec(self, ndim: int, batch_dim: int = 0,
                    batch_size: Optional[int] = None) -> PSpec:
        parts = self._batch_parts()
        spec: list = [None] * ndim
        if batch_size is None or batch_size % parts == 0:
            spec[batch_dim] = (self.batch_axes if len(self.batch_axes) > 1
                               else self.batch_axes[0])
        elif batch_size % self.shape.get("data", 1) == 0:
            spec[batch_dim] = "data"
        return tuple(spec)

    def named(self, pspec: PSpec) -> NamedSharding:
        return NamedSharding(self.mesh, tuple(pspec))


# --------------------------------------------------------------------------
# tree builders
# --------------------------------------------------------------------------

def tree_map_specs(fn, tree):
    from repro_torch.models.layers import tree_map_specs as _map
    return _map(fn, tree)


def param_shardings(rules: ShardingRules, spec_tree) -> Any:
    return tree_map_specs(
        lambda path, s: rules.named(rules.param_pspec(s)), spec_tree)


def opt_state_shardings(rules: ShardingRules, spec_tree) -> Any:
    ps = param_shardings(rules, spec_tree)
    return {"mu": ps, "nu": ps, "step": rules.named(())}


def cache_shardings(rules: ShardingRules, cache_spec_tree) -> Any:
    return tree_map_specs(
        lambda path, s: rules.named(rules.cache_pspec(s)), cache_spec_tree)


def batch_shardings(rules: ShardingRules, batch_struct: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """One sharding per batch leaf (anything with ``.shape``)."""
    return {k: rules.named(rules.batch_pspec(len(v.shape),
                                             batch_size=v.shape[0]))
            for k, v in batch_struct.items()}


def logits_sharding(rules: ShardingRules, shape: Tuple[int, ...]
                    ) -> NamedSharding:
    """[B, (S,) V] logits: batch -> data(+pod), vocab -> model."""
    ndim = len(shape)
    spec: list = [None] * ndim
    spec[0] = rules.batch_pspec(ndim, batch_size=shape[0])[0]
    if shape[-1] % rules.model_size == 0:
        spec[-1] = "model"
    return rules.named(tuple(spec))


def replicated(rules: ShardingRules) -> NamedSharding:
    return rules.named(())


# --------------------------------------------------------------------------
# placing tensors
# --------------------------------------------------------------------------

def distribute(tree, shardings):
    """Lay out a tree of tensors (params, caches, a batch) as DTensors by a
    matching tree of ``NamedSharding`` on a ``DeviceMesh``. A tensor on
    the ``meta`` device stays a shape-only stand-in; a real tensor is
    split by its sharding (``distribute_tensor``: each rank keeps its
    shard of the same global tensor)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if tree is None:
        return None
    sh: NamedSharding = shardings
    return distribute_tensor(tree, sh.mesh, sh.placements)


def local_nbytes(tree, shardings) -> int:
    """Per-device bytes of a tree of tensors (or meta stand-ins) laid out
    by ``shardings``: each leaf's global size over its shard count."""
    if isinstance(tree, dict):
        return sum(local_nbytes(v, shardings[k]) for k, v in tree.items())
    n = tree.element_size() if isinstance(tree, torch.Tensor) else 0
    for d in shardings.local_shape(tuple(tree.shape)):
        n *= d
    return n
