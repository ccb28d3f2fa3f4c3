"""Step functions + shape-only inputs + shardings per (arch x input shape).

Port of ``repro.launch.steps``. ``build_step(arch, shape, mesh)`` returns
a ``StepSpec``: the step callable, ``meta``-tensor stand-ins for every
input (the reference's ``ShapeDtypeStruct``s: shapes and dtypes, nothing
allocated), and matching in / out ``NamedSharding`` trees -- what
``launch.dryrun`` needs to trace the pair on the production mesh, and
what ``run_step`` needs to run it on real tensors.

Shape semantics (as the reference):
  train_4k    -> train_step  (loss + AdamW update)
  prefill_32k -> prefill_step (populate KV cache / SSM state; last-token
                 logits only)
  decode_32k  -> serve_step  (ONE token against a seq_len cache)
  long_500k   -> serve_step; dense/vlm/moe archs run the sliding-window
                 variant (window 16384, ring-buffer cache); ssm/hybrid run
                 natively. whisper-tiny is skipped (configs.SKIPS).

whisper-tiny's decoder is capped at 448 positions; its train/prefill/
decode shapes use min(seq_len, 448) for the decoder stream with the full
1500-frame encoder context.

The reference donates the params and optimizer state (train) and the
cache (decode) to its jitted step. The port's steps update them in place
(the AdamW of ``training.optimizer``, the model's cache writes), so there
is nothing to donate (ROADMAP C3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SKIPS, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.layers import DTYPES, tree_map_specs
from repro_torch.models.registry import build
from repro_torch.sharding.context import use_mesh
from repro_torch.sharding.specs import (ShardingRules, batch_shardings,
                                        cache_shardings, distribute,
                                        logits_sharding, opt_state_shardings,
                                        param_shardings, replicated)
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import OptimizerConfig

LONG_CONTEXT_WINDOW = 16384


@dataclasses.dataclass
class StepSpec:
    name: str
    step: Callable
    args: Tuple[Any, ...]            # trees of meta-tensor stand-ins
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    rules: ShardingRules
    model_cfg: Optional[ModelConfig] = None
    shape_cfg: Optional[ShapeConfig] = None
    model: Any = None


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=DTYPES[dtype], device="meta")


def _abstract_tree(spec_tree, default_dtype):
    return tree_map_specs(
        lambda path, s: _struct(s.shape, s.dtype or default_dtype), spec_tree)


def effective_config(arch: str, shape_name: str,
                     smoke: bool = False) -> ModelConfig:
    """The config actually run for this pair (long-context variants)."""
    cfg = get_config(arch, smoke=smoke)
    if shape_name == "long_500k" and cfg.family in ("dense", "vlm", "moe") \
            and cfg.sliding_window == 0:
        cfg = cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def batch_structs(cfg: ModelConfig, sc: ShapeConfig,
                  with_labels: bool) -> Dict[str, torch.Tensor]:
    """Stand-ins for a full-sequence batch (train / prefill)."""
    b = sc.global_batch
    s = sc.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        s = min(s, cfg.decoder_max_seq or s)
        out["frames"] = _struct((b, cfg.encoder_seq, cfg.d_model), "float32")
        out["tokens"] = _struct((b, s), "int32")
    elif cfg.family == "vlm":
        nv = min(cfg.num_visual_tokens, s - 1)
        out["visual_embeds"] = _struct((b, nv, cfg.d_model), "float32")
        out["tokens"] = _struct((b, s - nv), "int32")
    else:
        out["tokens"] = _struct((b, s), "int32")
    if with_labels:
        st = out["tokens"].shape
        out["labels"] = _struct(st, "int32")
        out["loss_mask"] = _struct(st, "float32")
    return out


def _opt_structs(param_structs):
    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return _struct(tree.shape, "float32")
    return {"mu": f32(param_structs), "nu": f32(param_structs),
            "step": _struct((), "int32")}


def _cache_len(cfg: ModelConfig, sc: ShapeConfig) -> int:
    s = sc.seq_len
    if cfg.family == "audio":
        s = min(s, cfg.decoder_max_seq or s)
    return s


def build_step(arch: str, shape_name: str, mesh, *,
               fsdp: bool = True, remat: bool = True,
               moe_cap: float = 1.25,
               decode_batch_replicated: bool = False,
               weight_quant: str = "none", smoke: bool = False,
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None) -> Optional[StepSpec]:
    """None if the pair is skipped (configs.SKIPS). ``mesh`` is a
    ``DeviceMesh`` or an ``AbstractMesh`` (shardings only).
    ``global_batch`` / ``seq_len`` cut the shape and ``smoke`` takes the
    arch's smoke config (a run on one device); the dry run uses
    neither."""
    if (arch, shape_name) in SKIPS:
        return None
    sc = SHAPES[shape_name]
    if global_batch or seq_len:
        sc = dataclasses.replace(sc, global_batch=global_batch
                                 or sc.global_batch,
                                 seq_len=seq_len or sc.seq_len)
    cfg = effective_config(arch, shape_name, smoke=smoke)
    if weight_quant != "none":
        cfg = cfg.with_(weight_quant=weight_quant)
    model = build(cfg)
    # fsdp only pays off when model-sharded weights still exceed ~1 GB per
    # device: smaller archs replicate across "data"
    rules = ShardingRules(mesh)
    param_bytes_per_dev = cfg.param_count() * 2 / rules.model_size
    fsdp = fsdp and param_bytes_per_dev > 1e9
    rules = ShardingRules(mesh, fsdp=fsdp)

    pspec_tree = model.param_specs()
    params_sh = param_shardings(rules, pspec_tree)
    params_st = _abstract_tree(pspec_tree, cfg.dtype)

    if sc.kind == "train":
        oc = OptimizerConfig()
        bst = batch_structs(cfg, sc, with_labels=True)
        bsh = batch_shardings(rules, bst)
        opt_st = _opt_structs(params_st)
        opt_sh = opt_state_shardings(rules, pspec_tree)

        step = make_train_step(model, oc, remat=remat)

        def train_step(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics["loss"]

        return StepSpec(
            name=f"{arch}/{shape_name}/train", step=train_step,
            args=(params_st, opt_st, bst),
            in_shardings=(params_sh, opt_sh, bsh),
            out_shardings=(params_sh, opt_sh, replicated(rules)),
            rules=rules, model_cfg=cfg, shape_cfg=sc, model=model)

    if sc.kind == "prefill":
        bst = batch_structs(cfg, sc, with_labels=False)
        bsh = batch_shardings(rules, bst)
        cache_spec = model.cache_specs(sc.global_batch, _cache_len(cfg, sc),
                                       windowed=False)
        cache_sh = cache_shardings(rules, cache_spec)

        def prefill_step(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch,
                                     cache_len=_cache_len(cfg, sc),
                                     moe_cap=moe_cap, last_only=True)

        lsh = logits_sharding(rules, (sc.global_batch, 1, cfg.vocab_size))
        return StepSpec(
            name=f"{arch}/{shape_name}/prefill", step=prefill_step,
            args=(params_st, bst), in_shardings=(params_sh, bsh),
            out_shardings=(lsh, cache_sh), rules=rules, model_cfg=cfg,
            shape_cfg=sc, model=model)

    # decode kinds (decode_32k / long_500k)
    windowed = (shape_name == "long_500k"
                and cfg.family in ("dense", "vlm", "moe"))
    cache_len = _cache_len(cfg, sc)
    cache_spec = model.cache_specs(sc.global_batch, cache_len,
                                   windowed=windowed)
    cache_st = _abstract_tree(cache_spec, cfg.dtype)
    cache_sh = cache_shardings(rules, cache_spec)
    b = sc.global_batch
    tok_st = _struct((b, 1), "int32")
    pos_st = _struct((b,), "int32")
    if decode_batch_replicated:
        # weight-stationary decode: replicate the (tiny) token batch so
        # fsdp-sharded matmuls reduce activations rather than gathering
        # the weight shards every step
        tok_sh = pos_sh = replicated(rules)
    else:
        tok_sh = rules.named(rules.batch_pspec(2, batch_size=b))
        pos_sh = rules.named(rules.batch_pspec(1, batch_size=b))

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(
                params, cache, tokens, pos, windowed=windowed,
                moe_cap=moe_cap, weight_stationary=decode_batch_replicated)

    lsh = logits_sharding(rules, (b, cfg.vocab_size))
    return StepSpec(
        name=f"{arch}/{shape_name}/decode", step=serve_step,
        args=(params_st, cache_st, tok_st, pos_st),
        in_shardings=(params_sh, cache_sh, tok_sh, pos_sh),
        out_shardings=(lsh, cache_sh), rules=rules, model_cfg=cfg,
        shape_cfg=sc, model=model)


def materialize(spec: StepSpec, seed: int, device) -> Tuple[Any, ...]:
    """Real inputs for ``spec`` on ``device``, from ``seed``: the params
    (``Model.init``), zero moments and step 0, a batch (tokens and labels
    uniform over the vocab, every position in the loss, visual embeddings
    and frames N(0, 0.02)), a cache of N(0, 1) rows whose windowed ring
    holds the last positions before ``pos`` (``slot_pos``), ``pos`` =
    cache_len - 1 for every row, and the tokens 7."""
    from repro_torch.training.optimizer import adamw_init
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = spec.model_cfg

    def fill(s):
        if s.dtype.is_floating_point:
            scale = 0.02 if s.ndim == 3 and s.shape[-1] == cfg.d_model \
                else 1.0
            return (torch.randn(s.shape, generator=gen, device=device)
                    * scale).to(s.dtype)
        return torch.randint(0, cfg.vocab_size, s.shape, generator=gen,
                             device=device).to(s.dtype)

    params = spec.model.init(seed, device)
    if spec.name.endswith("/train"):
        batch = {k: fill(v) for k, v in spec.args[2].items()}
        batch["loss_mask"] = torch.ones_like(batch["loss_mask"])
        return params, adamw_init(params), batch
    if spec.name.endswith("/prefill"):
        return params, {k: fill(v) for k, v in spec.args[1].items()}
    cache_st, tok_st, pos_st = spec.args[1:]
    pos = torch.full(pos_st.shape, _cache_len(cfg, spec.shape_cfg) - 1,
                     dtype=pos_st.dtype, device=device)

    def leaf(path, s):
        if path[-1] != "slot_pos":
            return fill(s)
        length = s.shape[-1]
        i = torch.arange(length, device=device)
        p = pos[0] - torch.remainder(pos[0] - i, length)
        return p.to(s.dtype).expand(s.shape).contiguous()
    cache = tree_map_specs(leaf, cache_st)
    return (params, cache,
            torch.full(tok_st.shape, 7, dtype=tok_st.dtype, device=device),
            pos)


def distribute_args(spec: StepSpec, args):
    """``args`` (real tensors, or meta stand-ins shaped as ``spec.args``)
    laid out by ``spec.in_shardings`` on the spec's ``DeviceMesh``."""
    return tuple(distribute(a, sh) for a, sh in zip(args,
                                                    spec.in_shardings))


def run_step(spec: StepSpec, args):
    """``spec.step(*args)`` under the spec's mesh (``use_mesh``): ``args``
    are DTensors (``distribute_args``)."""
    with use_mesh(spec.rules.mesh, spec.rules):
        return spec.step(*args)
