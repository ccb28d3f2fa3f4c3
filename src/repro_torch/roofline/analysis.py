"""Three-term roofline of one step on the port's card.

Port of ``repro.roofline.analysis``, with ``roofline/hw.py``'s H100 in
place of the TPU:

    compute term    = FLOPs / peak_FLOP/s               (per device)
    memory term     = bytes / HBM_bw                    (per device)
    collective term = collective_bytes / link bw        (per device)

The reference reads FLOPs from XLA's compiled module (``hlo_cost.py``)
and its collectives from the post-partitioner HLO text. The port has no
compiled module: ``roofline.step_cost`` counts the step's FLOPs and
records its collectives while the step runs on the mesh, and hands them
here as ``costs``. The collective weighting is the reference's
(``collective_bytes``): all-gather counts its output (each device
receives the gather), all-reduce 2x its operand (a ring is a
reduce-scatter plus an all-gather), reduce-scatter, all-to-all and
collective-permute their operand.

The collective term uses ``ici_bw`` = 450 GB/s, one direction of an
H100's NVLink. The production mesh's 16-wide "model" axis spans two
8-card NVLink domains, whose links between hosts are slower, so this
term is a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.roofline.hw import H100_SXM, HW

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(ops: Iterable[Tuple[str, float, float]]
                     ) -> Dict[str, object]:
    """Per-op-type operand byte totals, counts, and the weighted
    per-device transfer estimate of recorded collectives, each given as
    (op, operand bytes, output bytes) -- the reference's
    ``collective_bytes_from_hlo`` on parsed HLO lines."""
    out = {op: 0.0 for op in COLLECTIVES}
    counts = {op: 0 for op in COLLECTIVES}
    weighted = 0.0
    for op, opr_b, out_b in ops:
        counts[op] += 1
        out[op] += opr_b
        if op == "all-gather":
            weighted += out_b
        elif op == "all-reduce":
            weighted += 2 * opr_b
        else:
            weighted += opr_b
    return {"per_op_operand_bytes": out, "counts": counts,
            "collective_bytes": weighted}


@dataclasses.dataclass
class RooflineReport:
    name: str
    flops: float                    # per device
    bytes_accessed: float           # per device
    collective_bytes: float         # per device (weighted)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0        # 6ND / 2ND useful-work estimate
    useful_frac: float = 0.0        # model_flops / (flops * chips)
    collective_counts: Optional[Dict[str, int]] = None
    peak_memory_bytes: Optional[float] = None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_from_costs(name: str, costs: Dict[str, object], *, chips: int,
                        model_flops: float = 0.0,
                        analytic_bytes: float = 0.0,
                        hw: HW = H100_SXM) -> RooflineReport:
    """Three-term roofline from a step's measured costs.

    ``costs``: ``flops`` and ``bytes_accessed`` per device,
    ``collective_bytes`` (weighted) and ``collective_counts`` per device,
    and optionally ``peak_memory_bytes``. The memory term uses
    max(bytes, analytic steady-state traffic / chips), the reference's
    rule: the analytic term (weights + cache + optimizer) is the
    dependable lower bound at scale.
    """
    flops = float(costs["flops"])
    byts = max(float(costs.get("bytes_accessed", 0.0)),
               analytic_bytes / max(chips, 1))
    coll = float(costs.get("collective_bytes", 0.0))
    compute_s = flops / hw.peak_flops_bf16
    memory_s = byts / hw.hbm_bw
    collective_s = coll / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    peak = costs.get("peak_memory_bytes")
    return RooflineReport(
        name=name, flops=flops, bytes_accessed=byts, collective_bytes=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_frac=(model_flops / (flops * chips)) if flops else 0.0,
        collective_counts=costs.get("collective_counts"),
        peak_memory_bytes=None if peak is None else float(peak))


def model_flops_estimate(cfg, shape_cfg) -> float:
    """6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.active_param_count()
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n * tokens
    # decode: one token per request
    return 2.0 * n * shape_cfg.global_batch
