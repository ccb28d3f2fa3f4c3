"""Model assembly for all six architecture families.

Port of ``repro.models.transformer``. Parameters keep the reference's
stacked layout (every layer leaf has a leading [num_layers] dim) so a
reference checkpoint carries over key for key; the reference's
``lax.scan`` over the stacked layers is a Python loop here, each layer
reading its slice of the stacked params and cache (views, so cache
writes land in the stacked cache).

* ``dense`` / ``vlm`` / ``moe``: the ``moe`` family's first
  ``first_k_dense_layers`` layers are a stack of their own
  (``dense_layers``, dense MLPs), then ``layers`` with the MoE FFN; the
  MoE capacity defaults are the reference's (1.25 for ``forward``,
  ``prefill`` and ``extend``, dropless for ``decode_step``). A config
  with ``use_mla`` (deepseek-v3) runs every layer's attention through the
  MLA functions of ``models.attention``. A ``vlm`` with
  ``projector="perceiver"`` resamples the patches to ``num_latents``
  visual tokens (``models.resampler``).
* ``ssm`` (RWKV-6): time-mix and channel-mix per layer
  (``models.rwkv``), an O(1) state cache and no rope.
* ``hybrid`` (Zamba2): groups of ``attn_layer_period`` Mamba-2 layers
  (``models.mamba``), each group followed by one parameter-tied
  attention + MLP block with a windowed KV ring per group.
* ``audio`` (Whisper): a non-causal encoder over ``frames``, a decoder
  with causal self-attention and cross-attention over the encoder.

Every attention call of these families takes the kernels of
``models.attention`` on the card: the shared block's prefill the flash
kernel's window mode and its decode the paged kernel's masked mode,
whisper's encoder and cross prefill the flash kernel's non-causal mode,
its cross decode the paged kernel over the cross cache. The recurrences
are plain PyTorch, as the reference's are jnp.

Entry points (as the reference):
  forward(params, batch, remat)               -> (logits [B,S,V], aux)
  loss(params, batch, remat=True)             -> (loss, {"nll", aux})
  prefill(params, batch, cache_len, windowed) -> (logits [B,S,V], cache)
  extend(params, cache, tokens, start)        -> (logits [B,S_new,V], cache)
  decode_step(params, cache, tokens, pos)     -> (logits [B,V], cache)
``extend`` takes the attention-cache families (dense, vlm, moe) only, as
the reference's.

Profiler sites (``Model.profiler``, which the serving ``Engine`` sets to
its own; ``NULL_PROFILER`` otherwise): in ``prefill``, ``extend`` and
``decode_step`` of the dense / vlm / moe families each layer's attention
call is a ``model.attn`` site and its FFN call a ``model.ffn`` site
(``model.moe``, from ``apply_moe``, in an expert layer), timed here and
appended to ``Profiler.laps``, filed after the layer loop
(``close_laps``); the norms and residual adds between them lie in the
caller's site. ``model.head`` is the final norm and the unembedding, in
every family.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models.resampler import apply_resampler, resampler_specs
from repro_torch.models.layers import ParamSpec, spec
from repro_torch.obs.profile import NULL_PROFILER
from repro_torch.sharding.context import (distribute_cache, is_dtensor,
                                          matmul)


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


def _ckpt(fn, remat):
    """``fn`` rematerialised in the backward where ``remat`` asks (the
    reference's ``_ckpt`` around a scan body): its activations are not
    kept, and autograd runs it again for the gradient. ``remat="dots"``
    (the reference saves the matmul outputs) is full remat here: torch's
    checkpoint has no policy for which outputs to keep."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _store(cache, new) -> None:
    """Copy the leaves of ``new`` into the cache views ``cache`` (a
    layer's recurrent state: the reference's scan returns it as ys)."""
    for k, v in new.items():
        cache[k].copy_(v)


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


def _ffn(cfg, p, x, a, moe_cap, prof=NULL_PROFILER):
    """The residual around attention output ``a``, then the FFN residual
    (the MoE layer where the layer has one). Returns (x, aux)."""
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    if cfg.num_experts and "moe" in p:
        f, aux = MOE.apply_moe(p["moe"], h, cfg, capacity_factor=moe_cap,
                               profiler=prof)
        return x + f, aux
    if prof.enabled:
        t0 = prof.clock()
    f = L.apply_mlp(p["mlp"], h, cfg.activation)
    if prof.enabled:
        prof.laps.append(("model.ffn", t0, prof.clock(), None))
    return x + f, {}


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
                         moe_cap=1.25, prof=NULL_PROFILER):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    if prof.enabled:
        t0 = prof.clock()
    if cfg.use_mla:
        a, cache = attn.mla_full_attention(p["attn"], h, cos, sin, cfg,
                                           window=window, positions=positions,
                                           cache=cache)
    else:
        a, cache = attn.prefill_into_cache(p["attn"], h, cos, sin, cfg,
                                           cache, window=window,
                                           positions=positions)
    if prof.enabled:
        prof.laps.append(("model.attn", t0, prof.clock(), None))
    return _ffn(cfg, p, x, a, moe_cap, prof)[0], cache


def _dense_layer_extend(cfg, p, x, cos, sin, cache, start, *, window,
                        moe_cap=1.25, prof=NULL_PROFILER):
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    append = attn.mla_append_attention if cfg.use_mla \
        else attn.append_attention
    if prof.enabled:
        t0 = prof.clock()
    a, cache = append(p["attn"], h, cos, sin, cfg, cache, start,
                      window=window)
    if prof.enabled:
        prof.laps.append(("model.attn", t0, prof.clock(), None))
    return _ffn(cfg, p, x, a, moe_cap, prof)[0], cache


def _dense_layer_decode(cfg, p, x, cos, sin, cache, pos, *, window,
                        moe_cap=None, weight_stationary=False,
                        prof=NULL_PROFILER):
    if weight_stationary:
        x = L.constrain_replicated(x)
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    decode = attn.mla_decode_attention if cfg.use_mla \
        else attn.decode_attention
    if prof.enabled:
        t0 = prof.clock()
    a, cache = decode(p["attn"], h, cos, sin, cfg, cache, pos, window=window)
    if prof.enabled:
        prof.laps.append(("model.attn", t0, prof.clock(), None))
    return _ffn(cfg, p, x, a, moe_cap, prof)[0], cache


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
#: the families with an attention KV cache: the ones ``extend`` takes
_KV_FAMILIES = ("dense", "vlm", "moe")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # the recorder of the layer and head sites (not a field: the serving
    # Engine sets its own profiler here)
    profiler = NULL_PROFILER

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.cfg.family!r}")

    def segments(self) -> Tuple[Tuple[str, ModelConfig, int], ...]:
        """The stacked transformer-layer segments in order: (params /
        cache key, the config its layers run with, depth). The ``moe``
        family's dense prefix runs with ``num_experts=0`` (dense MLPs).
        Only the dense, vlm and moe families have them."""
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
        if cfg.family in _KV_FAMILIES:
            for key, lcfg, n in self.segments():
                out[key] = stack_specs(_dense_layer_specs(lcfg), n)
        elif cfg.family == "ssm":
            out["layers"] = stack_specs(
                {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg),
                 **R.rwkv_specs(cfg)}, cfg.num_layers)
        elif cfg.family == "hybrid":
            out["layers"] = stack_specs(
                {"ln": L.norm_specs(cfg), "mamba": M.mamba_specs(cfg)},
                cfg.num_layers)
            out["shared_attn"] = {
                "ln": L.norm_specs(cfg), "attn": attn.attn_specs(cfg),
                "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
        else:                                                  # audio
            out["encoder"] = {
                "layers": stack_specs(_dense_layer_specs(cfg),
                                      cfg.encoder_layers),
                "norm": L.norm_specs(cfg),
                "pos_embed": spec((cfg.encoder_seq, cfg.d_model),
                                  (None, "embed"), scale=0.02),
            }
            out["layers"] = stack_specs(
                {"ln1": L.norm_specs(cfg), "attn": attn.attn_specs(cfg),
                 "ln_x": L.norm_specs(cfg),
                 "xattn": attn.cross_attn_specs(cfg),
                 "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)},
                cfg.num_layers)
        if cfg.family == "vlm":
            if cfg.projector == "perceiver":
                out["projector"] = resampler_specs(
                    cfg, num_latents=cfg.num_latents)
            else:
                out["projector"] = {
                    "w1": spec((cfg.d_model, cfg.d_model),
                               ("embed", "embed_out")),
                    "w2": spec((cfg.d_model, cfg.d_model),
                               ("embed_out", "embed")),
                }
        return out

    def init(self, seed: int, device) -> Dict[str, Any]:
        return L.init_params(self.param_specs(), seed, self.cfg.dtype, device)

    # ------------------------------------------------------------- cache --
    def n_hybrid_groups(self) -> Tuple[int, int]:
        """(shared-block calls, trailing Mamba-2 layers) of the hybrid
        family."""
        cfg = self.cfg
        g = cfg.num_layers // cfg.attn_layer_period
        return g, cfg.num_layers - g * cfg.attn_layer_period

    def cache_specs(self, batch: int, cache_len: int,
                    windowed: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.family in _KV_FAMILIES:
            one = attn.kv_cache_specs(cfg, batch, cache_len, windowed)
            return {key: stack_specs(one, n)
                    for key, _, n in self.segments()}
        if cfg.family == "ssm":
            return {"layers": stack_specs(R.rwkv_cache_specs(cfg, batch),
                                          cfg.num_layers)}
        if cfg.family == "hybrid":
            g, _ = self.n_hybrid_groups()
            return {
                "layers": stack_specs(M.mamba_cache_specs(cfg, batch),
                                      cfg.num_layers),
                # the shared block: one windowed KV ring per call
                "shared_attn": stack_specs(
                    attn.kv_cache_specs(cfg, batch, cache_len,
                                        windowed=True), g),
            }
        cross = spec((batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim),
                     ("batch", "enc_seq", "kv_heads", None), init="zeros")
        return {
            "layers": stack_specs(
                attn.kv_cache_specs(cfg, batch, cache_len, windowed),
                cfg.num_layers),
            "cross": stack_specs({"k": cross, "v": cross}, cfg.num_layers),
        }

    def init_cache(self, batch, cache_len, windowed=False, device="cpu"):
        """Zeros (``slot_pos`` -1); under a mesh, DTensors laid out by the
        rules' cache shardings (``sharding.context.distribute_cache``)."""
        specs = self.cache_specs(batch, cache_len, windowed)
        return distribute_cache(
            attn.zeros_from_specs(specs, self.cfg.dtype, device), specs)

    # ------------------------------------------------------- rope helpers --
    def _cos_sin(self, positions):
        """positions: [S] or [B,S] text pos, or [3,B,S] for M-RoPE."""
        cfg = self.cfg
        if cfg.is_attention_free:
            return None, None
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
            if cfg.projector == "perceiver":
                # Flamingo resampler: any number of patches -> num_latents
                # fixed visual tokens (survey dim 3a)
                ve = apply_resampler(params["projector"], ve)
            else:
                w1, w2 = params["projector"]["w1"], params["projector"]["w2"]
                # jax.nn.gelu defaults to the tanh approximation
                ve = F.gelu(matmul(ve, w1).float(),
                            approximate="tanh").to(x.dtype)
                ve = matmul(ve, w2).to(x.dtype)
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
        prof = self.profiler
        if prof.enabled:
            prof.site_begin("model.head")
        x = L.apply_norm(params["final_norm"], x, self.cfg.norm)
        logits = L.unembed(params["embed"], x, self.cfg.logits_softcap)
        if prof.enabled:
            prof.site_end("model.head")
        return logits

    # ------------------------------------------------ ssm / hybrid layers --
    def _rwkv_layer(self, p, x, state=None):
        """One RWKV-6 layer: (x, its new state {tm_shift, wkv, cm_shift})."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm)
        tm, tm_state = R.time_mix_forward(p["time_mix"], h, cfg, state=state)
        x = x + tm
        h = L.apply_norm(p["ln2"], x, cfg.norm)
        cm, cm_state = R.channel_mix_forward(p["channel_mix"], h, cfg,
                                             state=state)
        return x + cm, dict(tm_state, **cm_state)

    def _shared_block(self, sp, x, attend):
        """The hybrid family's tied attention + MLP block; ``attend(p, h)``
        is its attention."""
        cfg = self.cfg
        x = x + attend(sp["attn"], L.apply_norm(sp["ln"], x, cfg.norm))
        h = L.apply_norm(sp["ln2"], x, cfg.norm)
        return x + L.apply_mlp(sp["mlp"], h, cfg.activation)

    def _hybrid(self, params, x, mamba, attend, remat=False):
        """The hybrid family's layers in order: Mamba-2 layer i is
        ``mamba(i, p, h)``; after every ``attn_layer_period`` of them the
        shared block runs, its attention ``attend(group, p, h)``. With
        ``remat`` each group (its Mamba-2 layers and the shared block) is
        rematerialised, the trailing layers are not (the reference's)."""
        cfg = self.cfg
        period = cfg.attn_layer_period
        n_groups, _ = self.n_hybrid_groups()

        def layers(x, lo, hi):
            for i in range(lo, hi):
                lp = _layer(params["layers"], i)
                x = x + mamba(i, lp["mamba"], L.apply_norm(lp["ln"], x,
                                                           cfg.norm))
            return x

        def group(x, gi):
            x = layers(x, gi * period, (gi + 1) * period)
            return self._shared_block(params["shared_attn"], x,
                                      lambda p, h: attend(gi, p, h))
        for gi in range(n_groups):
            x = _ckpt(group, remat)(x, gi)
        return layers(x, n_groups * period, cfg.num_layers)

    @staticmethod
    def _chunk(x):
        """The SSD chunk of a [B,T,d] input: the largest of 128 ... 1 that
        divides T (the reference's rule)."""
        t = x.shape[1]
        return next(c for c in (128, 64, 32, 16, 8, 4, 2, 1) if t % c == 0)

    # ------------------------------------------------------------- audio --
    def _encode(self, params, frames):
        """Whisper's encoder: non-causal self-attention layers over the
        frame embeddings, then its norm. frames [B,Se,d]."""
        cfg = self.cfg
        ep = params["encoder"]
        x = frames.to(L.DTYPES[cfg.dtype]) \
            + ep["pos_embed"][None, :frames.shape[1]]
        for i in range(cfg.encoder_layers):
            x, _ = _dense_layer_fwd(cfg, _layer(ep["layers"], i), x, None,
                                    None, positions=None, window=0,
                                    causal=False)
        return L.apply_norm(ep["norm"], x, cfg.norm)

    def _audio_embed(self, params, tokens):
        """(x [B,S,d], cos, sin) of the decoder's prompt at 0 .. S-1."""
        x = L.embed_tokens(params["embed"], tokens)
        cos, sin = L.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                                  self.cfg.head_dim, self.cfg.rope_theta)
        return x, cos, sin

    def _audio_decoder(self, params, x, self_attend, cross_attend,
                       remat=False):
        """Whisper's decoder layers over the embedded tokens x [B,S,d]:
        causal self-attention ``self_attend(i, p, h)``, cross-attention
        ``cross_attend(i, p, h)``, MLP; each layer rematerialised with
        ``remat`` (the encoder is not, as in the reference)."""
        cfg = self.cfg

        def layer(x, i):
            lp = _layer(params["layers"], i)
            x = x + self_attend(i, lp["attn"],
                                L.apply_norm(lp["ln1"], x, cfg.norm))
            x = x + cross_attend(i, lp["xattn"],
                                 L.apply_norm(lp["ln_x"], x, cfg.norm))
            h = L.apply_norm(lp["ln2"], x, cfg.norm)
            return x + L.apply_mlp(lp["mlp"], h, cfg.activation)
        for i in range(cfg.num_layers):
            x = _ckpt(layer, remat)(x, i)
        return x

    # ----------------------------------------------------------- forward --
    def forward(self, params, batch, *, window: Optional[int] = None,
                remat=False, moe_cap: Optional[float] = 1.25):
        """Full-sequence logits (training / scoring) and aux (the MoE
        layers' mean ``lb_loss``). ``remat`` rematerialises each layer in
        the backward (``_ckpt``): each transformer and RWKV layer, each
        hybrid group, each whisper decoder layer."""
        cfg = self.cfg
        window = 0 if window is None else window
        if cfg.family == "audio":
            enc = self._encode(params, batch["frames"])
            x, cos, sin = self._audio_embed(params, batch["tokens"])
            x = self._audio_decoder(
                params, x,
                lambda i, p, h: attn.full_attention(p, h, cos, sin, cfg,
                                                    causal=True),
                lambda i, p, h: attn.cross_attention(
                    p, h, *attn.cross_kv(p, enc)), remat=remat)
            return self._head(params, x), {}
        x, positions = self._embed_inputs(params, batch)
        cos, sin = self._cos_sin(positions)
        pos_1d = self._attn_positions(batch, positions)
        lbs = []
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x, _ = _ckpt(self._rwkv_layer, remat)(
                    _layer(params["layers"], i), x)
        elif cfg.family == "hybrid":
            x = self._hybrid(
                params, x,
                lambda i, p, h: M.mamba_forward(p, h, cfg,
                                                chunk=self._chunk(h))[0],
                lambda gi, p, h: attn.full_attention(
                    p, h, cos, sin, cfg, causal=True,
                    window=cfg.sliding_window, positions=pos_1d),
                remat=remat)
        else:
            for key, lcfg, n in self.segments():
                for i in range(n):
                    x, aux = _ckpt(_dense_layer_fwd, remat)(
                        lcfg, _layer(params[key], i), x, cos, sin,
                        positions=pos_1d, window=window, moe_cap=moe_cap)
                    if "lb_loss" in aux:
                        lbs.append(aux["lb_loss"])
        aux_acc = {"lb_loss": torch.stack(lbs).mean()} if lbs else {}
        return self._head(params, x), aux_acc

    # -------------------------------------------------------------- loss --
    def loss(self, params, batch, *, remat=True):
        """(mean next-token NLL over ``loss_mask`` + the MoE router's
        ``router_aux_loss_coef * lb_loss``, {"nll": that loss, scalar aux})
        as the reference's ``Model.loss``: a vlm's logits are cut to the
        text positions; the log-sum-exp runs in float32."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch, remat=remat)
        tokens = batch["tokens"]
        labels = batch.get("labels", None)
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                               dim=1)
        # VLM: logits cover [visual | text]; loss only on text positions
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        mask = batch.get("loss_mask", None)
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=logits.device)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        if is_dtensor(logits):
            # DTensor's rule for a gather on vocab-sharded logits fails
            # (its masked partial cannot follow the [..., 0]): the label's
            # logit as a masked sum instead, the same number
            hit = labels.long()[..., None] == torch.arange(
                logits.shape[-1], device=logits.device)
            ll = torch.where(hit, logits, 0.0).sum(-1)
        else:
            ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (lse - ll) * mask
        loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
        if "lb_loss" in aux:
            loss = loss + cfg.router_aux_loss_coef * aux["lb_loss"]
        return loss, {"nll": loss, **{k: v for k, v in aux.items()
                                      if v.ndim == 0}}

    # ----------------------------------------------------------- prefill --
    def prefill(self, params, batch, *, cache_len: Optional[int] = None,
                windowed: bool = False, window: Optional[int] = None,
                moe_cap: Optional[float] = 1.25, last_only: bool = False):
        """Run the full prompt, returning (logits, filled cache).

        ``last_only``: unembed only the final position (logits [B,1,V]).
        """
        cfg = self.cfg
        if cfg.family == "audio":
            x, cache = self._prefill_audio(params, batch, cache_len)
        else:
            window = (cfg.sliding_window if windowed else 0) \
                if window is None else window
            x, positions = self._embed_inputs(params, batch)
            b, s = x.shape[0], x.shape[1]
            # cache must cover the full (visual + text) prefill length
            cache_len = max(cache_len or 0, s)
            cache = self.init_cache(b, cache_len, windowed, device=x.device)
            cos, sin = self._cos_sin(positions)
            pos_1d = self._attn_positions(batch, positions)
            if cfg.family == "ssm":
                for i in range(cfg.num_layers):
                    x, st = self._rwkv_layer(_layer(params["layers"], i), x)
                    _store(_layer(cache["layers"], i), st)
            elif cfg.family == "hybrid":
                x = self._hybrid_prefill(params, x, cache, cos, sin, pos_1d)
            else:
                for key, lcfg, n in self.segments():
                    for i in range(n):
                        x, _ = _dense_layer_prefill(
                            lcfg, _layer(params[key], i), x, cos, sin,
                            _layer(cache[key], i), positions=pos_1d,
                            window=window, moe_cap=moe_cap,
                            prof=self.profiler)
                if self.profiler.enabled:
                    self.profiler.close_laps()
        if last_only:
            x = x[:, -1:]
        return self._head(params, x), cache

    def _hybrid_prefill(self, params, x, cache, cos, sin, pos_1d):
        cfg = self.cfg

        def mamba(i, p, h):
            st = _layer(cache["layers"], i)
            y, new = M.mamba_forward(p, h, cfg, chunk=self._chunk(h),
                                     cache=st)
            _store(st, new)
            return y

        def attend(gi, p, h):
            return attn.prefill_into_cache(
                p, h, cos, sin, cfg, _layer(cache["shared_attn"], gi),
                window=cfg.sliding_window, positions=pos_1d)[0]
        return self._hybrid(params, x, mamba, attend)

    def _prefill_audio(self, params, batch, cache_len):
        """(decoder output [B,S,d], cache): the encoder's keys and values
        of every layer land in ``cache["cross"]``."""
        cfg = self.cfg
        enc = self._encode(params, batch["frames"])
        x, cos, sin = self._audio_embed(params, batch["tokens"])
        cache = self.init_cache(x.shape[0], cache_len or x.shape[1],
                                device=x.device)

        def self_attend(i, p, h):
            return attn.prefill_into_cache(
                p, h, cos, sin, cfg, _layer(cache["layers"], i))[0]

        def cross_attend(i, p, h):
            xkv = _layer(cache["cross"], i)
            k, v = attn.cross_kv(p, enc)
            _store(xkv, {"k": k, "v": v})
            return attn.cross_attention(p, h, k, v)
        return self._audio_decoder(params, x, self_attend,
                                   cross_attend), cache

    # ------------------------------------------------------------ extend --
    def extend(self, params, cache, tokens, start, *,
               window: Optional[int] = None,
               moe_cap: Optional[float] = 1.25):
        """Chunked continuation: score ``tokens [B,S_new]`` appended to an
        existing cache at offset ``start`` -- a scalar (the batch extends
        from one position) or [B] per-request offsets. The attention-cache
        families only (the ssm and hybrid prefill already streams into an
        O(1) state), as the reference."""
        if self.cfg.family not in _KV_FAMILIES:
            raise NotImplementedError(
                f"extend() not supported for family {self.cfg.family!r}")
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
                    moe_cap=moe_cap, prof=self.profiler)
        if self.profiler.enabled:
            self.profiler.close_laps()
        return self._head(params, x), cache

    # ------------------------------------------------------------ decode --
    def decode_step(self, params, cache, tokens, pos, *,
                    windowed: bool = False, window: Optional[int] = None,
                    moe_cap: Optional[float] = None,
                    weight_stationary: bool = False):
        """tokens [B,1] -> (logits [B,V], cache).

        pos: scalar (all requests at one position) or [B] per-request
        positions (continuous batching). ``weight_stationary`` replicates
        each dense / vlm / moe layer's input under a mesh (the reference's
        ``constrain_replicated``); without one it changes nothing.
        """
        cfg = self.cfg
        window = (cfg.sliding_window if windowed else 0) if window is None \
            else window
        x = L.embed_tokens(params["embed"], tokens)
        b = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device).long().reshape(-1
                                                                   ).expand(b)
        cos, sin = self._cos_sin(pos[:, None])
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                st = _layer(cache["layers"], i)
                x, new = self._rwkv_layer(_layer(params["layers"], i), x,
                                          state=st)
                _store(st, new)
        elif cfg.family == "hybrid":
            x = self._hybrid_decode(params, x, cache, cos, sin, pos)
        elif cfg.family == "audio":
            x = self._decode_audio(params, x, cache, cos, sin, pos)
        else:
            for key, lcfg, n in self.segments():
                for i in range(n):
                    x, _ = _dense_layer_decode(
                        lcfg, _layer(params[key], i), x, cos, sin,
                        _layer(cache[key], i), pos, window=window,
                        moe_cap=moe_cap, weight_stationary=weight_stationary,
                        prof=self.profiler)
            if self.profiler.enabled:
                self.profiler.close_laps()
        return self._head(params, x)[:, 0], cache

    def _hybrid_decode(self, params, x, cache, cos, sin, pos):
        cfg = self.cfg

        def mamba(i, p, h):
            st = _layer(cache["layers"], i)
            y, new = M.mamba_decode_step(p, h, cfg, st)
            _store(st, new)
            return y

        def attend(gi, p, h):
            return attn.decode_attention(
                p, h, cos, sin, cfg, _layer(cache["shared_attn"], gi), pos,
                window=cfg.sliding_window)[0]
        return self._hybrid(params, x, mamba, attend)

    def _decode_audio(self, params, x, cache, cos, sin, pos):
        cfg = self.cfg
        return self._audio_decoder(
            params, x,
            lambda i, p, h: attn.decode_attention(
                p, h, cos, sin, cfg, _layer(cache["layers"], i), pos)[0],
            lambda i, p, h: attn.cross_decode_attention(
                p, h, _layer(cache["cross"], i)))
