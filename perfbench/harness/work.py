"""Operations and bytes of the work a call into the model asks for.

A frozen yardstick: the counts follow the published architecture, read
from the configuration file's own keys (``hidden_size``,
``num_attention_heads``, ``kv_lora_rank`` ...), and the shapes of the
calls into ``Model.prefill / extend / decode_step`` as the benchmark's
wrappers record them (``harness.probe``), never a kernel's launch
arguments. The rules are those of ``repro_torch/roofline/analytic.py``
(2 FLOPs a multiply-add, attention's quadratic term over the causal
pairs), with the mixture of experts counted as published: each token
through its ``num_experts_per_tok`` routed experts and the shared ones.

A call record is a dict: ``kind`` (prefill | extend | decode), ``q`` and
``ctx`` (per live row: the new queries and the keys each query row ends
at), ``nv`` (visual tokens of a prefill), ``unembed`` (rows unembedded).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from harness.peaks import PEAK_FLOPS_BF16, bound_s

BF16 = 2
F32 = 4


class Shape:
    """The sizes the counts need, from a configuration file."""

    def __init__(self, cfg: Dict):
        self.d = cfg["hidden_size"]
        self.layers = cfg["num_hidden_layers"]
        self.h = cfg["num_attention_heads"]
        self.kvh = cfg["num_key_value_heads"]
        self.vocab = cfg["vocab_size"]
        self.ff = cfg["intermediate_size"]
        self.mla = "kv_lora_rank" in cfg
        if self.mla:
            self.qr = cfg.get("q_lora_rank") or 0
            self.kvr = cfg["kv_lora_rank"]
            self.nope = cfg["qk_nope_head_dim"]
            self.rope = cfg["qk_rope_head_dim"]
            self.dv = cfg["v_head_dim"]
            self.dqk = self.nope + self.rope
        else:
            self.hd = cfg.get("head_dim") or self.d // self.h
        self.experts = cfg.get("n_routed_experts") or 0
        self.topk = cfg.get("num_experts_per_tok") or 0
        self.shared = cfg.get("n_shared_experts") or 0
        self.moe_ff = cfg.get("moe_intermediate_size") or 0
        self.dense_layers = (cfg.get("first_k_dense_replace", 0)
                             if self.experts else self.layers)
        self.projector = cfg.get("projector_width") or 0

    # ---------------------------------------------------- per token --
    def attn_proj_flops(self) -> float:
        """Projections in and out of attention, one token, one layer."""
        d, h = self.d, self.h
        if self.mla:
            q = (d * self.qr + self.qr * h * self.dqk) if self.qr \
                else d * h * self.dqk
            return 2.0 * (q + d * (self.kvr + self.rope) + h * self.dv * d)
        return 2.0 * (d * h * self.hd + 2 * d * self.kvh * self.hd
                      + h * self.hd * d)

    def ffn_flops(self) -> float:
        """Every layer's FFN, one token: dense SwiGLU layers, then the
        expert layers at top-k routed + shared experts and the router."""
        dense = 2.0 * 3 * self.d * self.ff * self.dense_layers
        moe_layers = self.layers - self.dense_layers
        moe = moe_layers * (2.0 * self.d * self.experts
                            + 2.0 * 3 * self.d * self.moe_ff
                            * (self.topk + self.shared))
        return dense + moe


def pairs(q: int, ctx: int) -> int:
    """Causal (query, key) pairs of ``q`` new queries ending at ``ctx``."""
    return q * ctx - q * (q - 1) // 2


def model_flops(s: Shape, call: Dict) -> float:
    """The model's FLOPs for one call, live rows only."""
    tokens = sum(call["q"])
    f = tokens * (s.attn_proj_flops() * s.layers + s.ffn_flops())
    f += 2.0 * s.d * s.vocab * call["unembed"]
    f += 2.0 * 2 * s.d * s.projector * call.get("nv", 0)
    for q, ctx in zip(call["q"], call["ctx"]):
        p = pairs(q, ctx)
        if not s.mla:
            f += 4.0 * s.h * s.hd * p * s.layers
        elif call["kind"] == "decode":
            # absorbed form: q into the latent, scores and values there,
            # the latent output back through wv_b
            f += s.layers * 2.0 * s.h * (
                q * s.nope * s.kvr + p * (s.kvr + s.rope) + p * s.kvr
                + q * s.kvr * s.dv)
        else:
            # naive form: per-head keys and values from the latent rows
            f += s.layers * 2.0 * s.h * (
                ctx * s.kvr * (s.nope + s.dv) + p * (s.dqk + s.dv))
    return f


def flash_work(s: Shape, call: Dict):
    """(FLOPs, bytes) of the flash kernel's calls in a prefill or extend:
    one call a layer, q / k / v read once and the output written once,
    bf16."""
    fl = by = 0.0
    for q, ctx in zip(call["q"], call["ctx"]):
        p = pairs(q, ctx)
        if s.mla:
            fl += 2.0 * s.h * (s.dqk + s.dv) * p
            by += BF16 * s.h * (q * s.dqk + ctx * s.dqk + ctx * s.dv
                                + q * s.dv)
        else:
            fl += 4.0 * s.h * s.hd * p
            by += BF16 * (2 * q * s.h * s.hd + 2 * ctx * s.kvh * s.hd)
    return fl * s.layers, by * s.layers


def paged_work(s: Shape, call: Dict):
    """(FLOPs, bytes) of the paged kernel in a decode step: each live
    row's keys and values read once, its query read and output written
    once, bf16."""
    fl = by = 0.0
    for q, ctx in zip(call["q"], call["ctx"]):
        fl += 4.0 * s.h * s.hd * pairs(q, ctx)
        by += BF16 * (2 * ctx * s.kvh * s.hd + 2 * q * s.h * s.hd)
    return fl * s.layers, by * s.layers


def mla_work(s: Shape, call: Dict):
    """(FLOPs, bytes) of the latent kernel in a decode step: each live
    row's latent rows (bf16) read once, its float32 latent query read and
    float32 latent output written once."""
    fl = by = 0.0
    for q, ctx in zip(call["q"], call["ctx"]):
        p = pairs(q, ctx)
        fl += 2.0 * s.h * (p * (s.kvr + s.rope) + p * s.kvr)
        by += BF16 * ctx * (s.kvr + s.rope) \
            + F32 * q * s.h * (s.kvr + s.rope + s.kvr)
    return fl * s.layers, by * s.layers


def mfu_pct(cfg: Dict, calls: List[Dict]) -> Optional[float]:
    """The model's FLOPs of ``calls`` over their summed wall time (each
    call timed until the device finished it), as a share of the bf16
    peak, %; nothing without calls."""
    wall = sum(c["wall_s"] for c in calls)
    if not wall:
        return None
    s = Shape(cfg)
    return 100.0 * sum(model_flops(s, c) for c in calls) \
        / (wall * PEAK_FLOPS_BF16)


def roofline_pct(run, prefix: str, decode: bool,
                 work: Callable) -> Optional[float]:
    """A kernel's share of its roofline, %: the least time (``bound_s``)
    the ``work`` of the traced stretch's decode calls (or, without
    ``decode``, prompt calls) needs, over the device time of the kernels
    whose names start with ``prefix``; nothing where the trace holds no
    such kernel or no such call."""
    t = run.devtrace
    if t is None or not t.kernel_s(prefix):
        return None
    calls = [c for c in run.calls
             if c["profiled"] and (c["kind"] == "decode") == decode]
    if not calls:
        return None
    s = Shape(run.cfg)
    return 100.0 * sum(bound_s(*work(s, c)) for c in calls) \
        / t.kernel_s(prefix)
