"""Model assembly: the dense, ``vlm`` and ``moe`` families (MLA included).

Port of ``repro.models.transformer``. Parameters keep the reference's
stacked layout (every layer leaf has a leading [num_layers] dim) so a
reference checkpoint carries over key for key; the reference's
``lax.scan`` over the stacked layers is a Python loop here, each layer
reading its slice of the stacked params and cache (views, so cache
writes land in the stacked cache). The ``moe`` family's first
``first_k_dense_layers`` layers are a stack of their own
(``dense_layers``, dense MLPs), then ``layers`` with the MoE FFN; the
MoE capacity defaults are the reference's (1.25 for ``forward``,
``prefill`` and ``extend``, dropless for ``decode_step``), so a chunked
prefill drops tokens chunk by chunk as the reference does. A config with
``use_mla`` (deepseek-v3) runs every layer's attention through the MLA
functions of ``models.attention``, with rope over ``qk_rope_head_dim``.

Entry points (as the reference):
  forward(params, batch)                      -> (logits [B,S,V], aux)
  prefill(params, batch, cache_len, windowed) -> (logits [B,S,V], cache)
  extend(params, cache, tokens, start)        -> (logits [B,S_new,V], cache)
  decode_step(params, cache, tokens, pos)     -> (logits [B,V], cache)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ParamSpec, spec


def stack_specs(tree, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacked-layer dim to every ParamSpec in a tree."""
    def _one(path, s: ParamSpec):
        return ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                         s.scale, s.dtype)
    return L.tree_map_specs(_one, tree)


def _layer(tree, i: int):
    """Layer ``i``'s slice (views) of a stacked param or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# layer bodies
# --------------------------------------------------------------------------

def _dense_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    out = {
        "ln1": L.norm_specs(cfg),
        "attn": attn.attn_specs(cfg),
        "ln2": L.norm_specs(cfg),
    }
    if cfg.num_experts:
        out["moe"] = MOE.moe_specs(cfg)
    else:
        out["mlp"] = L.mlp_specs(cfg)
    return out


def _ffn(cfg, p, x, a, moe_cap):
    """The residual around attention output ``a``, then the FFN residual
    (the MoE layer where the layer has one). Returns (x, aux)."""
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    if cfg.num_experts and "moe" in p:
        f, aux = MOE.apply_moe(p["moe"], h, cfg, capacity_factor=moe_cap)
        return x + f, aux
    return x + L.apply_mlp(p["mlp"], h, cfg.activation), {}


def _dense_layer_fwd(cfg, p, x, cos, sin, *, positions, window, causal=True,
                     moe_cap=1.25):
    """Full-seq layer (forward without cache). Returns (x, aux)."""
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.use_mla:
        a = attn.mla_full_attention(p["attn"], h, cos, sin, cfg,
                                    window=window, positions=positions)
    else:
        a = attn.full_attention(p["attn"], h, cos, sin, cfg, causal=causal,
                                window=window, positions=positions)
    return _ffn(cfg, p, x, a, moe_cap)


def _dense_layer_prefill(cfg, p, x, cos, sin, cache, *, positions, window,
                         moe_cap=1.25):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    if cfg.use_mla:
        a, cache = attn.mla_full_attention(p["attn"], h, cos, sin, cfg,
                                           window=window, positions=positions,
                                           cache=cache)
    else:
        a, cache = attn.prefill_into_cache(p["attn"], h, cos, sin, cfg,
                                           cache, window=window,
                                           positions=positions)
    return _ffn(cfg, p, x, a, moe_cap)[0], cache


def _dense_layer_extend(cfg, p, x, cos, sin, cache, start, *, window,
                        moe_cap=1.25):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    append = attn.mla_append_attention if cfg.use_mla \
        else attn.append_attention
    a, cache = append(p["attn"], h, cos, sin, cfg, cache, start,
                      window=window)
    return _ffn(cfg, p, x, a, moe_cap)[0], cache


def _dense_layer_decode(cfg, p, x, cos, sin, cache, pos, *, window,
                        moe_cap=None):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    decode = attn.mla_decode_attention if cfg.use_mla \
        else attn.decode_attention
    a, cache = decode(p["attn"], h, cos, sin, cfg, cache, pos, window=window)
    return _ffn(cfg, p, x, a, moe_cap)[0], cache


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

_FAMILIES = ("dense", "vlm", "moe")
#: families and features the port does not build yet, by ROADMAP item
_NOT_PORTED = {"ssm": "item 18 (models/rwkv.py)",
               "hybrid": "items 18-19 (models/mamba.py, the hybrid family)",
               "audio": "item 19 (the audio family)"}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family in _NOT_PORTED:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue A, "
                f"{_NOT_PORTED[cfg.family]}); the port builds the "
                f"{', '.join(_FAMILIES)} families")
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        if cfg.family == "vlm" and cfg.projector != "mlp":
            raise NotImplementedError(
                "the perceiver projector is not ported yet (ROADMAP queue A, "
                "item 18, models/resampler.py)")

    def segments(self) -> Tuple[Tuple[str, ModelConfig, int], ...]:
        """The stacked layer segments in order: (params / cache key, the
        config its layers run with, depth). The ``moe`` family's dense
        prefix runs with ``num_experts=0`` (dense MLPs)."""
        cfg = self.cfg
        kd = cfg.first_k_dense_layers if cfg.family == "moe" else 0
        out = (("layers", cfg, cfg.num_layers - kd),)
        if kd:
            out = (("dense_layers", cfg.with_(num_experts=0), kd),) + out
        return out

    # ------------------------------------------------------------- specs --
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        out: Dict[str, Any] = {"embed": L.embed_specs(cfg),
                               "final_norm": L.norm_specs(cfg)}
        for key, lcfg, n in self.segments():
            out[key] = stack_specs(_dense_layer_specs(lcfg), n)
        if cfg.family == "vlm":
            out["projector"] = {
                "w1": spec((cfg.d_model, cfg.d_model), ("embed", "embed_out")),
                "w2": spec((cfg.d_model, cfg.d_model), ("embed_out", "embed")),
            }
        return out

    def init(self, seed: int, device) -> Dict[str, Any]:
        return L.init_params(self.param_specs(), seed, self.cfg.dtype, device)

    # ------------------------------------------------------------- cache --
    def cache_specs(self, batch: int, cache_len: int,
                    windowed: bool = False) -> Dict[str, Any]:
        one = attn.kv_cache_specs(self.cfg, batch, cache_len, windowed)
        return {key: stack_specs(one, n) for key, _, n in self.segments()}

    def init_cache(self, batch, cache_len, windowed=False, device="cpu"):
        return attn.zeros_from_specs(
            self.cache_specs(batch, cache_len, windowed), self.cfg.dtype,
            device)

    # ------------------------------------------------------- rope helpers --
    def _cos_sin(self, positions):
        """positions: [S] or [B,S] text pos, or [3,B,S] for M-RoPE."""
        cfg = self.cfg
        hd = cfg.qk_rope_head_dim if cfg.use_mla else cfg.head_dim
        if cfg.use_mrope:
            if positions.ndim == 2:     # text-only fallback: t=h=w
                positions = positions[None].expand((3,) + positions.shape)
            return L.mrope_cos_sin(positions, hd, cfg.rope_theta,
                                   cfg.mrope_sections)
        return L.rope_cos_sin(positions, hd, cfg.rope_theta)

    # ------------------------------------------------------------ embed --
    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x [B,S,d], positions [B,S] or [3,B,S])."""
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["tokens"])
        if cfg.family == "vlm" and "visual_embeds" in batch:
            ve = batch["visual_embeds"].to(x.dtype)
            w1, w2 = params["projector"]["w1"], params["projector"]["w2"]
            # jax.nn.gelu defaults to the tanh approximation
            ve = F.gelu(torch.matmul(ve, w1).float(),
                        approximate="tanh").to(x.dtype)
            ve = torch.matmul(ve, w2).to(x.dtype)
            x = torch.cat([ve, x], dim=1)
        b, s = x.shape[0], x.shape[1]
        if "positions" in batch:
            positions = batch["positions"]
        else:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    @staticmethod
    def _attn_positions(batch, positions):
        """1-D positions for the attention masks: None (arange, the kernel
        path) unless the caller supplied positions."""
        if "positions" not in batch:
            return None
        return positions[0, 0] if positions.ndim == 3 else positions[0]

    def _head(self, params, x):
        x = L.apply_norm(params["final_norm"], x, self.cfg.norm)
        return L.unembed(params["embed"], x, self.cfg.logits_softcap)

    # ----------------------------------------------------------- forward --
    def forward(self, params, batch, *, window: Optional[int] = None,
                moe_cap: Optional[float] = 1.25):
        """Full-sequence logits (scoring) and aux (the MoE layers' mean
        ``lb_loss``)."""
        window = 0 if window is None else window
        x, positions = self._embed_inputs(params, batch)
        cos, sin = self._cos_sin(positions)
        pos_1d = self._attn_positions(batch, positions)
        lbs = []
        for key, lcfg, n in self.segments():
            for i in range(n):
                x, aux = _dense_layer_fwd(
                    lcfg, _layer(params[key], i), x, cos, sin,
                    positions=pos_1d, window=window, moe_cap=moe_cap)
                if "lb_loss" in aux:
                    lbs.append(aux["lb_loss"])
        aux_acc = {"lb_loss": torch.stack(lbs).mean()} if lbs else {}
        return self._head(params, x), aux_acc

    # ----------------------------------------------------------- prefill --
    def prefill(self, params, batch, *, cache_len: Optional[int] = None,
                windowed: bool = False, window: Optional[int] = None,
                moe_cap: Optional[float] = 1.25, last_only: bool = False):
        """Run the full prompt, returning (logits, filled cache).

        ``last_only``: unembed only the final position (logits [B,1,V]).
        """
        cfg = self.cfg
        window = (cfg.sliding_window if windowed else 0) if window is None \
            else window
        x, positions = self._embed_inputs(params, batch)
        b, s = x.shape[0], x.shape[1]
        # cache must cover the full (visual + text) prefill length
        cache_len = max(cache_len or 0, s)
        cache = self.init_cache(b, cache_len, windowed, device=x.device)
        cos, sin = self._cos_sin(positions)
        pos_1d = self._attn_positions(batch, positions)
        for key, lcfg, n in self.segments():
            for i in range(n):
                x, _ = _dense_layer_prefill(
                    lcfg, _layer(params[key], i), x, cos, sin,
                    _layer(cache[key], i), positions=pos_1d, window=window,
                    moe_cap=moe_cap)
        if last_only:
            x = x[:, -1:]
        return self._head(params, x), cache

    # ------------------------------------------------------------ extend --
    def extend(self, params, cache, tokens, start, *,
               window: Optional[int] = None,
               moe_cap: Optional[float] = 1.25):
        """Chunked continuation: score ``tokens [B,S_new]`` appended to an
        existing cache at offset ``start`` -- a scalar (the batch extends
        from one position) or [B] per-request offsets."""
        window = window or 0
        x = L.embed_tokens(params["embed"], tokens)
        b, s_new = tokens.shape
        positions = attn._extend_positions(start, s_new, x.device
                                           ).expand(b, s_new)
        cos, sin = self._cos_sin(positions)
        for key, lcfg, n in self.segments():
            for i in range(n):
                x, _ = _dense_layer_extend(
                    lcfg, _layer(params[key], i), x, cos, sin,
                    _layer(cache[key], i), start, window=window,
                    moe_cap=moe_cap)
        return self._head(params, x), cache

    # ------------------------------------------------------------ decode --
    def decode_step(self, params, cache, tokens, pos, *,
                    windowed: bool = False, window: Optional[int] = None,
                    moe_cap: Optional[float] = None):
        """tokens [B,1] -> (logits [B,V], cache).

        pos: scalar (all requests at one position) or [B] per-request
        positions (continuous batching).
        """
        cfg = self.cfg
        window = (cfg.sliding_window if windowed else 0) if window is None \
            else window
        x = L.embed_tokens(params["embed"], tokens)
        b = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device).long().reshape(-1
                                                                   ).expand(b)
        cos, sin = self._cos_sin(pos[:, None])
        for key, lcfg, n in self.segments():
            for i in range(n):
                x, _ = _dense_layer_decode(
                    lcfg, _layer(params[key], i), x, cos, sin,
                    _layer(cache[key], i), pos, window=window,
                    moe_cap=moe_cap)
        return self._head(params, x)[:, 0], cache
