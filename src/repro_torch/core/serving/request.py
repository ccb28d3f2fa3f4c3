"""Request lifecycle for the LVLM serving layer (survey dim 2c).

Port of ``repro.core.serving.request``: pure Python plus numpy, as the
reference, with the same fields (per-request decoder and compression,
the disaggregation ``handoff`` flag) and states (``MIGRATING`` while a
request's KV moves between engines).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class State(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"          # (possibly chunked) prompt processing
    DECODE = "decode"
    MIGRATING = "migrating"      # KV export pinned, awaiting import elsewhere
    PREEMPTED = "preempted"
    DONE = "done"


@dataclasses.dataclass
class SLO:
    ttft_ms: float = 500.0       # time-to-first-token target
    tpot_ms: float = 50.0        # time-per-output-token target


@dataclasses.dataclass
class Request:
    rid: int
    tokens: List[int]                       # prompt token ids
    max_new_tokens: int = 32
    visual_embeds: Optional[np.ndarray] = None   # [Nv, d] stub patches
    arrival: float = 0.0
    slo: SLO = dataclasses.field(default_factory=SLO)
    # per-request decode strategy (survey dim 4): None -> the engine's
    # configured default; otherwise a registered decoder name
    # ("greedy" | "sampling" | "speculative" | "early_exit" | custom).
    # The engine groups decode-phase slots by strategy each iteration, so
    # one Engine serves a mixed-strategy workload.
    decoder: Optional[str] = None
    # per-request visual-token compression strategy (survey dim 1/2a):
    # None -> the engine's default; otherwise a registered strategy name
    # or any preset/parametric name ("fastv-0.5", "framefusion-0.25",
    # "streaming-kv-64", ...) -- resolved exactly like ``decoder``, so a
    # video request can run aggressive pruning next to an uncompressed
    # chat request in the same batch.
    compression: Optional[str] = None
    # extra KV positions reserved beyond prompt+max_new (set by the engine
    # at submit: speculative verify writes up to ``gamma`` draft positions
    # ahead of the committed stream, so its slots need gamma slack).
    # Schedulers account it when admitting against KV capacity.
    lookahead: int = 0
    # disaggregated serving (survey dim 2c-ii): a handoff request runs
    # prefill on THIS engine but decodes elsewhere -- after the first token
    # it parks in MIGRATING instead of entering DECODE, and the KV snapshot
    # is exported to a decode-role replica. Its KV reservation here covers
    # only the prompt (plus the first token), not max_new_tokens.
    handoff: bool = False

    # runtime state ---------------------------------------------------------
    state: State = State.WAITING
    # POST-compression visual-token count, stamped by the engine when the
    # request's compression strategy is first resolved (submit or the
    # admission gate's kv_request_tokens probe). None until then; KV
    # accounting falls back to the full visual count.
    nv_compressed: Optional[int] = None
    prefill_done: int = 0                   # tokens of prompt processed
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    aborted: bool = False                   # cancelled via Engine.abort()
    # scheduling metadata
    priority: int = 0                        # MLFQ level
    served_tokens: int = 0
    predicted_len: Optional[int] = None      # ShuffleInfer-style estimate

    @property
    def prompt_len(self) -> int:
        nv = 0 if self.visual_embeds is None else len(self.visual_embeds)
        return len(self.tokens) + nv

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def kv_prompt_len(self) -> int:
        """Prompt tokens that actually LAND in the KV cache: text plus the
        POST-compression visual count once the engine resolved the
        request's compression strategy (``prompt_len`` keeps the full
        pre-compression count for workload/latency reporting)."""
        if self.nv_compressed is None:
            return self.prompt_len
        return len(self.tokens) + self.nv_compressed

    @property
    def kv_total_len(self) -> int:
        return self.kv_prompt_len + len(self.generated)

    def is_finished(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    # metrics ----------------------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def jct(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None \
                or len(self.generated) <= 1:
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.generated) - 1))


def percentiles(vals: List[float], prefix: str,
                ps=(50, 95, 99)) -> Dict[str, Optional[float]]:
    """``{prefix}_p50/p95/p99`` latency summary (None when empty)."""
    if not vals:
        return {f"{prefix}_p{p}": None for p in ps}
    return {f"{prefix}_p{p}": float(np.percentile(vals, p)) for p in ps}


def slo_attainment(reqs: List[Request]) -> Dict[str, Optional[float]]:
    """Fraction of finished requests meeting their OWN per-request SLO
    targets (``Request.slo``, milliseconds against the virtual clock):
    TTFT, TPOT, and both at once (DistServe-style goodput fraction)."""
    done = [r for r in reqs if r.finish_time is not None]
    if not done:
        return {"slo_ttft_attainment": None, "slo_tpot_attainment": None,
                "slo_goodput": None}
    ttft_ok = tpot_ok = both = 0
    for r in done:
        t_ok = (r.ttft() or 0.0) <= r.slo.ttft_ms * 1e-3
        p_ok = (r.tpot() or 0.0) <= r.slo.tpot_ms * 1e-3
        ttft_ok += t_ok
        tpot_ok += p_ok
        both += t_ok and p_ok
    n = len(done)
    return {"slo_ttft_attainment": ttft_ok / n,
            "slo_tpot_attainment": tpot_ok / n,
            "slo_goodput": both / n}


def summarize(reqs: List[Request]) -> Dict:
    done = [r for r in reqs if r.finish_time is not None]
    if not done:
        return {"finished": 0}
    ttfts = [r.ttft() for r in done if r.ttft() is not None]
    jcts = [r.jct() for r in done]
    tpots = [r.tpot() for r in done if r.tpot() is not None]
    tokens = sum(len(r.generated) for r in done)
    makespan = max(r.finish_time for r in done) - min(r.arrival for r in done)
    out = {
        "finished": len(done),
        "tokens": tokens,
        "throughput_tok_per_s": tokens / max(makespan, 1e-9),
        "ttft_mean": float(np.mean(ttfts)) if ttfts else None,
        "jct_mean": float(np.mean(jcts)),
        "tpot_mean": float(np.mean(tpots)) if tpots else None,
        "makespan": makespan,
    }
    out.update(percentiles(ttfts, "ttft"))
    out.update(percentiles(tpots, "tpot"))
    out.update(slo_attainment(done))
    return out
