"""The active mesh of a sharded step, and the model's mesh-aware hooks.

The reference enters ``with mesh:`` and its model reads the mesh through
``jax.sharding.get_abstract_mesh()``; the partitioner then places every
op. Here ``with use_mesh(mesh, rules):`` makes a ``DeviceMesh`` and its
``ShardingRules`` current, and DTensor places the ops. Inside it plain
tensors that meet a DTensor (an ``arange``, a rope table) count as
replicated (``implicit_replication``). Without it every hook below is a
no-op, and the model runs on plain tensors as it always has.

Hooks the model calls:

  * ``matmul`` / ``einsum``: torch's, with a DTensor output's partial sums
    reduced at once.
  * ``constrain_replicated(x)``: a DTensor redistributed to
    ``Replicate()`` on every mesh dim (weight-stationary decode), a plain
    tensor unchanged.
  * ``constrain(x, pspec)``: a DTensor redistributed to a partition spec.
  * ``keep_sharded(x, dims)``: a DTensor with only ``dims`` left sharded
    (rwkv6's streams before their 40-head reshape; a table's fsdp shards
    before a lookup).
  * ``lookup(table, ids)``: the embedding lookup (see ``lookup``).
  * ``batch_groups()``: the product of the mesh's "pod" and "data" sizes,
    the MoE layer's token groups.
  * ``local(fn, args, outs)``: ``fn`` on each rank's local shards, for
    the code DTensor cannot place: the kernel calls (a DTensor has no
    ``data_ptr``) and the in-place cache writes around them, MoE's sort
    dispatch, the RWKV and Mamba-2 recurrences. See ``local``.
  * ``distribute_cache(cache, specs)``: a freshly made cache laid out by
    the rules' cache shardings.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.compat import mesh_shape

_STACK: list = []


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: Any                    # torch.distributed.device_mesh.DeviceMesh
    rules: Any                   # sharding.specs.ShardingRules

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(mesh_shape(self.mesh))

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(mesh_shape(self.mesh).values())


@contextlib.contextmanager
def use_mesh(mesh, rules=None):
    """Make ``mesh`` (a named ``DeviceMesh``, or an ``AbstractMesh`` for
    what reads only its axes, such as ``batch_groups``) current for the
    model's hooks; ``rules`` defaults to ``ShardingRules(mesh)``."""
    from torch.distributed.tensor.experimental import implicit_replication
    if rules is None:
        from repro_torch.sharding.specs import ShardingRules
        rules = ShardingRules(mesh)
    _STACK.append(MeshContext(mesh, rules))
    try:
        with implicit_replication():
            yield _STACK[-1]
    finally:
        _STACK.pop()


def _reduced(out):
    """A DTensor's partial sums reduced (``Partial`` -> ``Replicate``, an
    all-reduce); anything else unchanged."""
    if type(out) is not torch.Tensor and is_dtensor(out) \
            and any(p.is_partial() for p in out.placements):
        from torch.distributed.tensor import Replicate
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def matmul(a, b):
    """``torch.matmul``, whose partial sums (a contraction over a sharded
    dim) a DTensor output reduces at once: no later op then meets a
    ``Partial`` input, whose strategies move other inputs from ``Shard`` to
    ``Partial``, which DTensor does not do in every release. The
    reference's partitioner may keep a partial sum longer (ROADMAP C3)."""
    return _reduced(torch.matmul(a, b))


def einsum(equation, *operands):
    """``torch.einsum``, reduced as ``matmul``."""
    return _reduced(torch.einsum(equation, *operands))


def current() -> Optional[MeshContext]:
    return _STACK[-1] if _STACK else None


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain_replicated(x):
    """Pin a (small) decode activation to full replication: fsdp-sharded
    matmuls then reduce partial sums of the activations instead of
    gathering the weight shards every step (weight-stationary decode).
    A plain tensor is returned unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def constrain(x, pspec):
    """A DTensor redistributed to partition spec ``pspec``; a plain tensor
    unchanged."""
    if not is_dtensor(x):
        return x
    from repro_torch.sharding.specs import placements
    return x.redistribute(x.device_mesh, placements(pspec, x.device_mesh))


def keep_sharded(x, dims: Sequence[int]):
    """A DTensor redistributed so that only its ``dims`` stay sharded (each
    on the mesh dims it had), every other sharded dim gathered; a plain
    tensor unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
          for p in x.placements]
    if list(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def lookup(table, ids):
    """``table[ids]`` (an embedding lookup). Under a mesh it runs on each
    rank's local shards (``local_map``): the table's fsdp shards are
    gathered first, so only its vocab dim stays sharded (over one mesh
    dim); each rank takes the rows of the ids in its vocab range and zeros
    for the rest, a partial sum over the vocab's mesh dim that is reduced
    at once (an all-reduce); the rows keep the ids' batch sharding.
    DTensor's own lookup strategies do not serve here in every release
    (hybrid-sharded ids, the gradient of an index)."""
    if not (is_dtensor(table) or is_dtensor(ids)):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (table if is_dtensor(table) else ids).device_mesh
    table, ids = (t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in (table, ids))
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if len(vocab) > 1:
        vocab = []
    table = keep_sharded(table, (0,) if vocab else ())
    if vocab:
        n = table.shape[0] // mesh.size(vocab[0])
        lo = mesh.get_local_rank(vocab[0]) * n
    else:
        lo = 0

    def rows(tab, idx):
        local = idx.long() - lo
        hit = (local >= 0) & (local < tab.shape[0])
        return tab[local.clamp(0, tab.shape[0] - 1)] \
            * hit[..., None].to(tab.dtype)
    out_pl = [Partial() if i in vocab else
              (p if p == Shard(0) else Replicate())
              for i, p in enumerate(ids.placements)]
    return _reduced(local_map(
        rows, out_placements=out_pl,
        in_placements=(tuple(table.placements), tuple(ids.placements)),
        device_mesh=mesh)(table, ids))


def batch_groups() -> Tuple[int, Optional[Tuple[str, ...]], int]:
    """(groups, batch axes, model size) of the current mesh: the product
    of its "pod" and "data" sizes, the names of those axes, and its
    "model" size; (1, None, 1) without a mesh."""
    ctx = current()
    if ctx is None:
        return 1, None, 1
    shape = dict(zip(ctx.names, ctx.sizes))
    axes = tuple(a for a in ("pod", "data") if a in shape)
    g = 1
    for a in axes:
        g *= shape[a]
    return g, axes, shape.get("model", 1)


def distribute_cache(cache, specs):
    """A cache made on plain tensors (zeros), laid out by the current
    rules' cache shardings; unchanged without a mesh."""
    ctx = current()
    if ctx is None:
        return cache
    from repro_torch.sharding.specs import cache_shardings, distribute
    return distribute(cache, cache_shardings(ctx.rules, specs))


@dataclasses.dataclass(frozen=True)
class Arg:
    """One argument of a ``local`` region: the tensor, its batch dim and
    its heads dim (None where it has none), and whether the region writes
    into it."""
    t: Any
    batch: Optional[int] = None
    heads: Optional[int] = None
    inplace: bool = False


def _region_placements(args: Sequence[Arg], mesh):
    """Per mesh dim, what the region shards: "batch" where some argument
    is sharded on its batch dim there, else "heads" where some argument
    is sharded on its heads dim there, else nothing. A dim is only
    sharded where every argument that has it divides."""
    from torch.distributed.tensor import Shard
    kinds = []
    parts = {"batch": 1, "heads": 1}
    for mdim, size in enumerate(mesh.mesh.shape):
        kind = None
        for want in ("batch", "heads"):
            sharded = any(
                is_dtensor(a.t) and getattr(a, want) is not None
                and a.t.placements[mdim] == Shard(getattr(a, want))
                for a in args)
            fits = all(a.t.shape[getattr(a, want)] % (parts[want] * size)
                       == 0 for a in args
                       if getattr(a, want) is not None
                       and isinstance(a.t, torch.Tensor))
            if sharded and fits:
                kind = want
                parts[want] *= size
                break
        kinds.append(kind)
    return kinds


def _placements_for(kinds, batch: Optional[int], heads: Optional[int]):
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for kind in kinds:
        dim = batch if kind == "batch" else heads if kind == "heads" else None
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def _returning_none(fn):
    def run(*args):
        fn(*args)
        return ()
    return run


def local(fn: Callable, args: Sequence[Arg], outs: Sequence[Tuple]):
    """``fn(*tensors)`` on each rank's local shards, through
    ``torch.distributed.tensor.experimental.local_map``.

    Without a DTensor among ``args`` this is ``fn(*tensors)``. Otherwise
    every argument is redistributed so that the region is sharded on the
    batch and heads dims only (``_region_placements``; every other dim,
    such as a sequence-sharded cache's ``cache_seq``, is gathered), ``fn``
    runs on the local tensors, and its outputs, described by ``outs`` as
    (batch dim, heads dim) pairs, come back as DTensors. An argument the
    region writes into (``inplace``) and that had to be redistributed is
    copied back into the caller's DTensor afterwards (a local slice: its
    shards are those of the gathered copy). Plain tensor arguments count
    as replicated."""
    if not any(is_dtensor(a.t) for a in args):
        return fn(*(a.t for a in args))
    if not outs:                      # a write-only region
        fn = _returning_none(fn)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.t for a in args if is_dtensor(a.t)).device_mesh
    kinds = _region_placements(args, mesh)
    ins, in_pl = [], []
    for a in args:
        if not isinstance(a.t, torch.Tensor):
            ins.append(a.t)
            in_pl.append(None)
            continue
        t = a.t if is_dtensor(a.t) else DTensor.from_local(
            a.t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        pl = _placements_for(kinds, a.batch, a.heads)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        ins.append(t)
        in_pl.append(pl)
    # one placement list per output (local_map reads a tuple as outputs)
    out_pl = tuple(list(_placements_for(kinds, b, h)) for b, h in outs)
    mapped = local_map(fn, out_placements=out_pl if len(outs) != 1
                       else out_pl[0], in_placements=tuple(in_pl),
                       device_mesh=mesh)
    result = mapped(*ins)
    if not outs:
        result = None
    for a, t in zip(args, ins):
        if a.inplace and t is not a.t and is_dtensor(a.t):
            a.t.copy_(t.redistribute(mesh, a.t.placements))
    return result
