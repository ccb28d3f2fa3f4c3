"""``LVLM``: the public inference facade of the port.

Port of ``repro.api.lvlm`` for this slice:

    from repro_torch.api import LVLM, GenerationConfig

    lvlm = LVLM.from_pretrained("qwen2-vl-2b")          # on the CUDA device
    out = lvlm.generate(prompt_tokens, GenerationConfig(max_new_tokens=16))
    for tok in lvlm.generate_stream(prompt_tokens):
        ...
    report = lvlm.serve(requests, EngineConfig(scheduler="chunked"))

Visual-token compression is a named default strategy
(``GenerationConfig(compression="fastv-0.5")``) that any request may
override (``Request.compression``); ``compressors=`` registers extra
named strategies with the engine.

Everything runs on ``device``: the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no ``device=``, construction
raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.compressors import make_compressor
from repro_torch.api.generation import DECODER_NAMES, GenerationConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.serving import Engine, EngineConfig, Request
from repro_torch.models.convert import load_checkpoint, params_from_flat
from repro_torch.models.layers import DTYPES
from repro_torch.models.registry import build

Prompt = Sequence[int]


@dataclasses.dataclass
class GenerationResult:
    """One prompt's continuation plus run-level stats."""
    tokens: List[int]                 # generated token ids
    prompt_len: int                   # text tokens (visual not included)
    decoder: str
    stats: Dict                       # engine summary + decoder counters
    request: Request                  # full lifecycle record (ttft/jct/...)


@dataclasses.dataclass
class ServeResult:
    """Outcome of a full serving run (scheduler metrics + raw requests)."""
    stats: Dict
    requests: List[Request]
    engine: Engine


def _is_single_prompt(prompts) -> bool:
    return len(prompts) > 0 and not hasattr(prompts[0], "__len__")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    CUDA device; raises when neither is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


class LVLM:
    """Facade over (model, params on one device); see module docstring."""

    def __init__(self, model, params):
        self.model = model
        self.params = params

    # ---------------------------------------------------------- factory --
    @classmethod
    def from_pretrained(cls, arch: str, *, smoke: bool = False,
                        seed: int = 0, checkpoint: Optional[str] = None,
                        device=None, **overrides) -> "LVLM":
        """config -> build -> param init (or checkpoint restore).

        ``overrides`` are ``ModelConfig.with_`` fields. ``checkpoint`` is a
        reference checkpoint directory (manifest.json + shard_*.npz), read
        with numpy alone and cast to the config's dtype.
        """
        dev = resolve_device(device)
        cfg = get_config(arch, smoke=smoke)
        if overrides:
            cfg = cfg.with_(**overrides)
        model = build(cfg)
        if checkpoint is not None:
            flat, dtypes, _step = load_checkpoint(checkpoint)
            params = params_from_flat(flat, dev, dtype=DTYPES[cfg.dtype],
                                      dtypes=dtypes)
        else:
            params = model.init(seed, dev)
        return cls(model, params)

    @classmethod
    def from_config(cls, cfg: ModelConfig, *, seed: int = 0,
                    device=None) -> "LVLM":
        model = build(cfg)
        return cls(model, model.init(seed, resolve_device(device)))

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["tok"].device

    def with_params(self, params) -> "LVLM":
        """Same architecture, new weights."""
        return LVLM(self.model, params)

    # ----------------------------------------------------------- engine --
    def _build_engine(self, gen: GenerationConfig, *, max_batch: int,
                      cache_len: int,
                      engine_cfg: Optional[EngineConfig] = None,
                      compressors: Optional[Dict] = None) -> Engine:
        if engine_cfg is None:
            engine_cfg = EngineConfig(max_batch=max_batch,
                                      cache_len=cache_len,
                                      scheduler="continuous")
        # generation knobs always come from gen; engine_cfg keeps only the
        # serving-layer knobs (batch, cache, scheduler, cost).
        # gen.compression is sugar for a NAMED default strategy registered
        # with the engine
        engine_cfg = dataclasses.replace(
            engine_cfg,
            temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p,
            eos_id=gen.eos_id, seed=gen.seed,
            decoder=gen.decoder)
        # analysis: allow L003 (this is the port's facade: it owns engine construction)
        return Engine(self.model, self.params, engine_cfg,
                      compressor=make_compressor(gen.compression),
                      compressors=compressors)

    def _requests(self, prompts, gen, visual_embeds) -> List[Request]:
        n = len(prompts)
        if visual_embeds is None:
            ves: List[Optional[np.ndarray]] = [None] * n
        elif isinstance(visual_embeds, (list, tuple)):
            ves = list(visual_embeds)
        else:                                      # one array, one prompt
            ves = [np.asarray(visual_embeds)]
        if len(ves) != n:
            raise ValueError(f"{n} prompts but {len(ves)} visual_embeds")
        return [Request(rid=i, tokens=[int(t) for t in p],
                        max_new_tokens=gen.max_new_tokens,
                        visual_embeds=ve)
                for i, (p, ve) in enumerate(zip(prompts, ves))]

    @staticmethod
    def _cache_len(reqs: List[Request], gen: GenerationConfig) -> int:
        if not reqs:
            raise ValueError("generate() needs at least one prompt")
        need = max(r.prompt_len + r.max_new_tokens for r in reqs) + 2
        return -(-need // 16) * 16                 # round up to x16

    # --------------------------------------------------------- generate --
    def generate(self, prompts, gen: Optional[GenerationConfig] = None, *,
                 visual_embeds=None,
                 engine_cfg: Optional[EngineConfig] = None,
                 compressors: Optional[Dict] = None
                 ) -> Union[GenerationResult, List[GenerationResult]]:
        """Generate continuations.

        ``prompts``: one token-id sequence or a list of them (a single
        prompt returns a single ``GenerationResult``). ``visual_embeds``:
        one [Nv, d] array (single prompt) or a list parallel to ``prompts``.
        ``compressors``: extra named compression strategies registered
        with the engine (preset/parametric names resolve without
        registration).
        """
        gen = gen if gen is not None else GenerationConfig()
        single = _is_single_prompt(prompts)
        if single:
            prompts = [prompts]
        reqs = self._requests(prompts, gen, visual_embeds)
        eng = self._build_engine(
            gen, max_batch=min(8, max(1, len(reqs))),
            cache_len=self._cache_len(reqs, gen), engine_cfg=engine_cfg,
            compressors=compressors)
        for r in reqs:
            eng.submit(r)
        stats = dict(eng.run(), **eng.decoder_stats())
        results = [GenerationResult(tokens=list(r.generated),
                                    prompt_len=len(r.tokens),
                                    decoder=gen.decoder, stats=stats,
                                    request=r)
                   for r in reqs]
        return results[0] if single else results

    def generate_stream(self, prompt: Prompt,
                        gen: Optional[GenerationConfig] = None, *,
                        visual_embeds=None) -> Iterator[int]:
        """Per-token iterator over one prompt's continuation."""
        gen = gen if gen is not None else GenerationConfig()
        reqs = self._requests([prompt], gen,
                              None if visual_embeds is None
                              else [np.asarray(visual_embeds)])
        eng = self._build_engine(gen, max_batch=1,
                                 cache_len=self._cache_len(reqs, gen))
        req = reqs[0]
        eng.submit(req)
        served = 0
        while eng.step():
            while served < len(req.generated):
                yield req.generated[served]
                served += 1
        while served < len(req.generated):
            yield req.generated[served]
            served += 1

    # ------------------------------------------------------------ serve --
    def serve(self, requests: List[Request],
              engine_cfg: Optional[EngineConfig] = None,
              gen: Optional[GenerationConfig] = None,
              compressors: Optional[Dict] = None) -> ServeResult:
        """Full serving run: scheduler + batching + virtual-clock metrics.

        ``engine_cfg`` keeps its serving knobs (scheduler, batch, cache);
        ``gen`` optionally selects the default decoder, its sampling knobs
        and the default compression preset on top. A request may name its
        own decoder (``Request.decoder``) and compression strategy
        (``Request.compression``: any preset/parametric name or a key of
        ``compressors``); KV accounting uses each request's
        post-compression token count. Stats include the virtual-clock
        decode cost per strategy group (``decode_cost_by_group``) and the
        per-strategy prefill token reduction (``compression/<name>/...``).
        """
        ec = engine_cfg if engine_cfg is not None else EngineConfig()
        if gen is not None:
            ec = dataclasses.replace(
                ec, decoder=gen.decoder, temperature=gen.temperature,
                top_k=gen.top_k, top_p=gen.top_p, eos_id=gen.eos_id)
        elif ec.decoder not in DECODER_NAMES:
            ec = dataclasses.replace(ec, decoder="sampling")
        # analysis: allow L003 (this is the port's facade: it owns engine construction)
        eng = Engine(self.model, self.params, ec,
                     compressor=make_compressor(
                         gen.compression if gen is not None else None),
                     compressors=compressors)
        for r in requests:
            eng.submit(r)
        stats = dict(eng.run(), **eng.decoder_stats())
        stats["decode_cost_by_group"] = dict(eng.group_costs)
        for name, cs in eng.compression_stats().items():
            for k, v in cs.items():
                stats[f"compression/{name}/{k}"] = v
        return ServeResult(stats=stats, requests=list(eng.finished),
                           engine=eng)
