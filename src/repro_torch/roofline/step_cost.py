"""What one step costs: FLOPs, collectives and per-device bytes.

This takes the place of the reference's ``roofline/hlo_cost.py``, which
walks XLA's post-partitioner HLO text (trip counts times each loop body's
dots and collectives). The port has no compiled module; it runs the step
instead, twice, on ``meta`` stand-ins (nothing allocated):

  * **FLOPs** (``step_flops``): ``torch.utils.flop_counter.FlopCounterMode``
    over the step traced once on plain ``meta`` tensors, with no mesh. The
    model's layer loops are Python, so every layer is counted; the count
    is global and per step (matmuls and attention products, elementwise
    work not counted, as in ``hlo_cost``). The per-device value is global
    / devices. The reference's walk of the partitioned module also counts
    compute each device repeats on replicated data, which this does not
    (ROADMAP C3).
  * **Collectives** (``step_collectives``): the step runs once more as
    DTensors on the mesh under ``CollectiveRecorder``, a
    ``TorchDispatchMode`` that records every ``_c10d_functional``
    collective (and DTensor's shard-to-shard all-to-all) with its local,
    per-device sizes; ``roofline.analysis.collective_bytes`` weights them
    as the reference does.
  * **Memory** (``step_memory``): the per-device bytes of params,
    optimizer state, cache and batch, exactly, from their placements. The
    peak of the step's temporaries is not measured: the record carries
    an ``error`` for it, as the reference's CPU backend does when
    ``memory_analysis()`` is missing.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import collective_bytes
from repro_torch.sharding.specs import local_nbytes

# functional collective -> the reference's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_IGNORED = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveRecorder(TorchDispatchMode):
    """Records (kind, operand bytes, output bytes) of every collective the
    ops under it issue, on each op's local tensors. A DTensor op is handed
    back to DTensor first (``NotImplemented``), so the collectives it
    lowers to come through here (``CommDebugMode``'s way)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, float, float]] = []
        self.unknown: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            name = func._opname
            if name in _KINDS:
                self.ops.append((_KINDS[name], float(_nbytes(args[0])),
                                 float(_nbytes(out))))
            elif name not in _IGNORED:
                self.unknown[name] = self.unknown.get(name, 0) + 1
        return out


def _fresh(tree):
    """New ``meta`` stand-ins shaped as ``tree``'s (a step writes into its
    inputs, and the stand-ins are shared)."""
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def step_flops(spec) -> float:
    """Global FLOPs of one step, traced on plain meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    args = tuple(_fresh(a) for a in spec.args)
    with FlopCounterMode(display=False) as fc:
        spec.step(*args)
    return float(fc.get_total_flops())


def step_collectives(spec) -> Dict[str, object]:
    """The step's collectives on its mesh, per device, weighted
    (``analysis.collective_bytes``), plus ``unknown``: any other c10d op
    seen, by name and count."""
    from repro_torch.launch.steps import distribute_args, run_step
    args = distribute_args(spec, tuple(_fresh(a) for a in spec.args))
    with CollectiveRecorder() as rec:
        run_step(spec, args)
    out = collective_bytes(rec.ops)
    out["unknown"] = dict(rec.unknown)
    return out


def step_memory(spec) -> Dict[str, object]:
    """Per-device bytes of the step's inputs from their placements, by
    role, and their sum (``argument_bytes``); the peak is not measured."""
    roles = {"train": ("param_bytes", "opt_state_bytes", "batch_bytes"),
             "prefill": ("param_bytes", "batch_bytes"),
             "decode": ("param_bytes", "cache_bytes", "token_bytes",
                        "pos_bytes")}[spec.name.split("/")[-1]]
    out: Dict[str, object] = {
        role: int(local_nbytes(a, sh))
        for role, a, sh in zip(roles, spec.args, spec.in_shardings)}
    out["argument_bytes"] = int(sum(out.values()))
    out["error"] = ("peak_bytes not measured: the port traces the step on "
                    "meta tensors and has no memory analysis of it")
    return out


def step_costs(spec, *, chips: int) -> Dict[str, object]:
    """The ``costs`` of ``roofline.analysis.roofline_from_costs``: FLOPs /
    chips, the inputs' per-device bytes as the bytes accessed (each read
    once), and the recorded collectives."""
    mem = step_memory(spec)
    coll = step_collectives(spec)
    return {"flops": step_flops(spec) / chips,
            "bytes_accessed": float(mem["argument_bytes"]),
            "collective_bytes": coll["collective_bytes"],
            "collective_counts": coll["counts"],
            "collective_operand_bytes": coll["per_op_operand_bytes"],
            "collective_unknown": coll["unknown"],
            "memory": mem}
