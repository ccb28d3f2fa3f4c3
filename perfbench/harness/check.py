"""The comparison that decides ``correct``.

Once the window has closed, the drain is over, the peak memory read and
the program's state freed: a sample of the window's finished requests,
drawn from the seed and always holding the longest, is run through the
plain float32 reference (``reference/<family>.py``) over its prompt and
the tokens the program served. At each served position the gap is how
far the served token's reference logit lies below the reference's best
(greedy decoding serves the program's best); the numbers compared are
the widest gap (``gap_max``) or the mean gap (``gap_mean``), as the
cell's file names them, each against its limit. With ``logit_rows`` the
run keeps the logits the timed path computed for each request's first
tokens (``harness.probe.capture_logits``), and ``logit_err_max`` is the
largest relative L2 distance of those rows from the reference's at the
same positions. Every request of the window must also have finished.

The control (``--control 1``, never in the benchmark's own runs) is the
reference computed in fp8, put in the program's place: at the same
positions of the same requests, its logits stand for the kept rows and
the token it puts first for the served one, and ``correct`` is decided
on those numbers (``control_<name>``) against the same limits.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from harness.spec import reference_module
from harness.weights import CHECK, stream


def sample(run) -> List[Dict]:
    """The window's finished requests to check: the longest first, then
    others in an order drawn from the seed until ``sample_tokens`` served
    tokens or ``sample_requests`` requests."""
    chk = run.cell["check"]
    done = [r for r in run.window_records() if not r["failed"]]
    if not done:
        return []
    size = [r["req"].prompt_len + len(r["generated"]) for r in done]
    first = int(np.argmax(size))
    rng = np.random.default_rng(stream(run.seed, CHECK))
    rest = [i for i in rng.permutation(len(done)) if i != first]
    out, served = [done[first]], len(done[first]["generated"])
    for i in rest:
        if served >= chk["sample_tokens"] or \
                len(out) >= chk["sample_requests"]:
            break
        out.append(done[i])
        served += len(done[i]["generated"])
    return out


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest, over rows, relative L2 distance of ``a`` from ``ref``."""
    return float(((a - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def gaps(run, recs: List[Dict], control: bool = False) -> Dict[str, float]:
    """The numbers a check can compare, over ``recs``: the served tokens'
    widest and mean gap, the kept logits' ``logit_err_max``; with
    ``control`` the same of the fp8 control (``control_*``)."""
    ref = reference_module(run.cfg["reference"])
    worst = {"gap_max": 0.0}
    every = {"gap": [], "control_gap": []}
    if control:
        worst["control_gap_max"] = 0.0
    for r in recs:
        req = r["req"]
        served = r["generated"]
        lg = ref.served_logits(run.cfg, run.params, req.tokens,
                               req.visual_embeds, served)
        best = lg.max(-1).values
        tok = torch.as_tensor(served, device=lg.device)
        got = lg.gather(-1, tok[:, None])[:, 0]
        worst["gap_max"] = max(worst["gap_max"], float((best - got).max()))
        kept = [j for j in range(len(served)) if (req.rid, j) in run.logits]
        if kept:
            prog = torch.stack([run.logits[(req.rid, j)] for j in kept])
            err = rel_err(prog.float(), lg[kept])
            worst["logit_err_max"] = max(worst.get("logit_err_max", 0.0),
                                         err)
        every["gap"] += (best - got).tolist()
        if control:
            low = ref.served_logits(run.cfg, run.params, req.tokens,
                                    req.visual_embeds, served,
                                    precision="fp8")
            pick = low.argmax(-1)
            if kept:
                worst["control_logit_err_max"] = max(
                    worst.get("control_logit_err_max", 0.0),
                    rel_err(low[kept], lg[kept]))
            g = best - lg.gather(-1, pick[:, None])[:, 0]
            worst["control_gap_max"] = max(worst["control_gap_max"],
                                           float(g.max()))
            every["control_gap"] += g.tolist()
            del low
        del lg
    for k, v in every.items():
        if v:
            a = np.asarray(v)
            worst[k + "_mean"] = float(a.mean())
            worst[k + "_nonzero_share"] = float((a > 0).mean())
    return worst


def check(run, control: bool = False):
    """(correct, {name: {"value", "limit"}}, extra) for a finished run:
    the cell's ``check.limits`` name the numbers compared (``gap_max``,
    ``gap_mean``, ``logit_err_max``) and their limits. With ``control``
    the control's readings are compared in the program's place, and the
    program's own go to ``extra``."""
    limits = run.cell["check"]["limits"]
    failed = len(run.failed())
    recs = sample(run)
    out = {"failed_requests": {"value": failed, "limit": 0}}
    extra = {}
    if recs:
        g = gaps(run, recs, control)
        key = ("control_{}" if control else "{}").format
        for name, limit in limits.items():
            out[name] = {"value": g.get(key(name), float("inf")),
                         "limit": limit}
        extra = {"checked_requests": len(recs),
                 "checked_tokens": sum(len(r["generated"]) for r in recs)}
        compared = {key(name) for name in limits}
        extra.update({k: v for k, v in g.items() if k not in compared})
    ok = bool(recs) and all(c["value"] <= c["limit"] for c in out.values())
    return ok, out, extra
