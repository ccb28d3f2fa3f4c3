"""``LVLM``: the public inference facade of the port.

Port of ``repro.api.lvlm`` for this slice:

    from repro_torch.api import LVLM, GenerationConfig

    lvlm = LVLM.from_pretrained("qwen2-vl-2b")          # on the CUDA device
    out = lvlm.generate(prompt_tokens, GenerationConfig(max_new_tokens=16))
    for tok in lvlm.generate_stream(prompt_tokens):
        ...
    report = lvlm.serve(requests, EngineConfig(scheduler="chunked"),
                        obs=True, profile=True)     # traced + profiled
    server = lvlm.serve_async(EngineConfig(max_batch=8), control=True)
    async with server:
        async for tok in server.submit(request):
            ...
    router = lvlm.serve_cluster(2, EngineConfig(max_batch=8),
                                roles=["prefill", "decode"])
    async with router:                 # KV crosses prefill -> decode
        async for tok in router.submit(request):
            ...

Every decode strategy (greedy, sampling, speculative, early_exit) runs
through the same engine and decoder hook; ``GenerationConfig(decoder=)``
names the default, ``Request.decoder`` overrides it per request, and
``draft=`` (an ``LVLM``) is the speculative draft model (None: the target
drafts for itself). Visual-token compression is a named default strategy
(``GenerationConfig(compression="fastv-0.5")``) that any request may
override (``Request.compression``); ``compressors=`` registers extra
named strategies with the engine.

Everything runs on ``device``: the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no ``device=``, construction
raises instead of carrying on on the CPU. ``serve_async`` and every
replica of ``serve_cluster`` run on the LVLM's device too, and share its
weights: only the KV pools are per replica.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.compressors import make_compressor
from repro_torch.api.decoders import make_decoder
from repro_torch.api.generation import DECODER_NAMES, GenerationConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.serving import Engine, EngineConfig, Request
from repro_torch.models.convert import load_checkpoint, params_from_flat
from repro_torch.models.layers import DTYPES
from repro_torch.models.registry import build
from repro_torch.obs import Profiler, Tracer
from repro_torch.serving import AsyncLVLMServer

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
    def _strategy_decoders(self, gen: GenerationConfig,
                           draft: Optional["LVLM"]) -> Dict:
        """Named decoder instances parameterized by ``gen``, registered
        with the engine so per-request strategies (``Request.decoder``)
        use the caller's gamma/LANTERN/exit knobs and draft model.
        Validation is lazy: an entry only errors if a request selects
        it."""
        return {
            "speculative": make_decoder(
                "speculative", gen,
                draft=None if draft is None else draft.model,
                d_params=None if draft is None else draft.params),
            "early_exit": make_decoder("early_exit", gen),
        }

    def _build_engine(self, gen: GenerationConfig, *, max_batch: int,
                      cache_len: int, draft: Optional["LVLM"] = None,
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
        decoders = self._strategy_decoders(gen, draft)
        # analysis: allow L003 (this is the port's facade: it owns engine construction)
        return Engine(self.model, self.params, engine_cfg,
                      decoder=decoders.get(gen.decoder), decoders=decoders,
                      compressor=make_compressor(gen.compression),
                      compressors=compressors)

    @staticmethod
    def _resolve_obs(obs):
        """``obs=`` facade knob -> a ``repro_torch.obs.Tracer`` or None.

        ``None``/``False`` -> no tracing (the engine holds NULL_TRACER and
        every instrumentation site short-circuits); ``True`` -> a fresh
        ``Tracer``; a ``Tracer`` instance is used as-is (share one across
        servers to merge their events into a single trace)."""
        if obs is None or obs is False:
            return None
        return Tracer() if obs is True else obs

    @staticmethod
    def _resolve_profile(profile):
        """``profile=`` facade knob -> a ``repro_torch.obs.Profiler`` or
        None; mirrors ``_resolve_obs``."""
        if profile is None or profile is False:
            return None
        return Profiler() if profile is True else profile

    @staticmethod
    def _resolve_control(control):
        """``control=`` facade knob -> a ``repro_torch.control.Controller``
        or None.

        Mirrors ``_resolve_obs``: ``None``/``False`` -> no adaptive
        control (ZERO policy calls -- every site guards on
        ``control is not None``); ``True`` -> a fresh ``Controller`` with
        the default degradation ladder; a ``ControlConfig`` or
        ``AdaptivePolicy`` wraps into a fresh ``Controller``; a
        ``Controller`` instance is used as-is (share one across replicas
        so the fleet walks a single ladder)."""
        if control is None or control is False:
            return None
        from repro_torch.control import Controller
        if control is True:
            return Controller()
        if isinstance(control, Controller):
            return control
        return Controller(control)

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
        margin = 2 + (gen.gamma if gen.decoder == "speculative" else 0)
        need = max(r.prompt_len + r.max_new_tokens for r in reqs) + margin
        return -(-need // 16) * 16                 # round up to x16

    # --------------------------------------------------------- generate --
    def generate(self, prompts, gen: Optional[GenerationConfig] = None, *,
                 visual_embeds=None, draft: Optional["LVLM"] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 compressors: Optional[Dict] = None
                 ) -> Union[GenerationResult, List[GenerationResult]]:
        """Generate continuations.

        ``prompts``: one token-id sequence or a list of them (a single
        prompt returns a single ``GenerationResult``). ``visual_embeds``:
        one [Nv, d] array (single prompt) or a list parallel to ``prompts``.
        ``draft``: an ``LVLM`` used as the speculative draft model (None ->
        self-draft). ``compressors``: extra named compression strategies
        registered with the engine (preset/parametric names resolve
        without registration).
        """
        gen = gen if gen is not None else GenerationConfig()
        single = _is_single_prompt(prompts)
        if single:
            prompts = [prompts]
        reqs = self._requests(prompts, gen, visual_embeds)
        eng = self._build_engine(
            gen, max_batch=min(8, max(1, len(reqs))),
            cache_len=self._cache_len(reqs, gen), draft=draft,
            engine_cfg=engine_cfg, compressors=compressors)
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
                        visual_embeds=None, draft: Optional["LVLM"] = None
                        ) -> Iterator[int]:
        """Per-token iterator over one prompt's continuation (any decoder;
        a speculative round surfaces several tokens at once)."""
        gen = gen if gen is not None else GenerationConfig()
        reqs = self._requests([prompt], gen,
                              None if visual_embeds is None
                              else [np.asarray(visual_embeds)])
        eng = self._build_engine(gen, max_batch=1,
                                 cache_len=self._cache_len(reqs, gen),
                                 draft=draft)
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
    def _serve_engine(self, engine_cfg: Optional[EngineConfig] = None,
                      gen: Optional[GenerationConfig] = None,
                      draft: Optional["LVLM"] = None,
                      compressors: Optional[Dict] = None,
                      tracer=None, profiler=None) -> Engine:
        """Serving-engine wiring shared by ``serve`` (sync, closed-loop)
        and ``serve_async`` (streaming, open-loop): resolve the default
        strategy + generation knobs onto the EngineConfig and register
        every named per-request strategy (decoders AND compressors)."""
        ec = engine_cfg if engine_cfg is not None else EngineConfig()
        g = gen if gen is not None else GenerationConfig(
            decoder=ec.decoder if ec.decoder in DECODER_NAMES else "sampling",
            temperature=ec.temperature, top_k=ec.top_k, top_p=ec.top_p,
            eos_id=ec.eos_id)
        if gen is not None:
            ec = dataclasses.replace(
                ec, decoder=gen.decoder, temperature=gen.temperature,
                top_k=gen.top_k, top_p=gen.top_p, eos_id=gen.eos_id)
        elif ec.decoder not in DECODER_NAMES:
            ec = dataclasses.replace(ec, decoder="sampling")
        decoders = self._strategy_decoders(g, draft)
        # analysis: allow L003 (this is the port's facade: it owns engine construction)
        return Engine(self.model, self.params, ec,
                      decoder=decoders.get(ec.decoder), decoders=decoders,
                      compressor=make_compressor(
                          gen.compression if gen is not None else None),
                      compressors=compressors, tracer=tracer,
                      profiler=profiler)

    def serve(self, requests: List[Request],
              engine_cfg: Optional[EngineConfig] = None,
              gen: Optional[GenerationConfig] = None,
              draft: Optional["LVLM"] = None,
              compressors: Optional[Dict] = None,
              obs=None, profile=None, control=None) -> ServeResult:
        """Full serving run: scheduler + batching + virtual-clock metrics.

        ``engine_cfg`` keeps its serving knobs (scheduler, batch, cache);
        ``gen`` optionally selects the default decoder, its sampling,
        speculative and early-exit knobs and the default compression
        preset on top; ``draft`` is the speculative draft model of every
        speculative request (None -> self-draft). A request may name its
        own decoder (``Request.decoder``; a mixed run's decoder stats are
        prefixed, ``"speculative/acceptance"``) and compression strategy
        (``Request.compression``: any preset/parametric name or a key of
        ``compressors``); KV accounting uses each request's
        post-compression token count. Stats include the virtual-clock
        decode cost per strategy group (``decode_cost_by_group``) and the
        per-strategy prefill token reduction (``compression/<name>/...``).
        ``obs=True`` (or a ``Tracer``) traces the run and ``profile=True``
        (or a ``Profiler``) profiles its hot-path sites; the engine holds
        them as ``result.engine.tracer`` / ``.profiler``. ``control=``
        (True, a ``ControlConfig``, an ``AdaptivePolicy`` or a
        ``Controller``) degrades each request at submit against the KV
        already committed. For open-loop traffic with streaming delivery
        and cancellation, see ``serve_async``.
        """
        eng = self._serve_engine(engine_cfg, gen, draft,
                                 compressors=compressors,
                                 tracer=self._resolve_obs(obs),
                                 profiler=self._resolve_profile(profile))
        ctl = self._resolve_control(control)
        for r in requests:
            if ctl is not None:
                # closed-loop shaping: degrade against already-committed
                # KV; the override commits immediately (submitted now)
                ctl.shape_sync(eng, r)
            eng.submit(r)
        stats = dict(eng.run(), **eng.decoder_stats())
        stats["decode_cost_by_group"] = dict(eng.group_costs)
        for name, cs in eng.compression_stats().items():
            for k, v in cs.items():
                stats[f"compression/{name}/{k}"] = v
        return ServeResult(stats=stats, requests=list(eng.finished),
                           engine=eng)

    def serve_async(self, engine_cfg: Optional[EngineConfig] = None,
                    gen: Optional[GenerationConfig] = None, *,
                    draft: Optional["LVLM"] = None,
                    admission=None, metrics=None, compressors=None,
                    pacing: str = "virtual", pacing_scale: float = 1.0,
                    disconnect_timeout_s: Optional[float] = None,
                    obs=None, profile=None,
                    control=None) -> AsyncLVLMServer:
        """Async streaming server over the same engine wiring as ``serve``,
        on this LVLM's device (the card unless it was built with
        ``device="cpu"``).

        Returns a ``repro_torch.serving.AsyncLVLMServer``: a background
        pump over the grouped step loop with per-request async token
        channels, KV-watermark admission control (backpressure instead of
        pool exhaustion), mid-stream cancellation that frees every held
        resource, and per-request TTFT/TPOT/queue-wait SLO telemetry:

            server = lvlm.serve_async(EngineConfig(max_batch=8))
            async with server:
                async for tok in server.submit(req):
                    ...

        ``admission`` is an ``AdmissionConfig`` (high/low KV watermarks,
        optional max inflight, deferred-queue ``order``: "fifo" or
        SLO-slack "slack"); ``metrics`` an optional shared
        ``MetricsRegistry``. ``pacing="wall"`` sleeps each step's virtual
        duration (times ``pacing_scale``) in real time -- the default
        "virtual" runs steps back-to-back and stays deterministic.
        ``disconnect_timeout_s`` aborts a stream whose consumer stopped
        reading for that many wall seconds. ``obs`` / ``profile`` as in
        ``serve``; ``control=`` attaches an SLO-adaptive controller that
        degrades deferred requests under KV pressure instead of queueing
        them. At temperature 0 the streams are bit-identical to
        ``serve``'s outputs.
        """
        return AsyncLVLMServer(self, engine_cfg=engine_cfg, gen=gen,
                               draft=draft, admission=admission,
                               metrics=metrics, compressors=compressors,
                               pacing=pacing, pacing_scale=pacing_scale,
                               disconnect_timeout_s=disconnect_timeout_s,
                               tracer=self._resolve_obs(obs),
                               profiler=self._resolve_profile(profile),
                               control=self._resolve_control(control))

    def serve_cluster(self, replicas=2,
                      engine_cfg: Optional[EngineConfig] = None,
                      gen: Optional[GenerationConfig] = None, *,
                      routing="round_robin", draft: Optional["LVLM"] = None,
                      admission=None, compressors=None,
                      roles: Optional[Sequence[str]] = None,
                      shared_prefix: Optional[bool] = None,
                      pacing: str = "virtual",
                      pacing_scale: float = 1.0,
                      disconnect_timeout_s: Optional[float] = None,
                      obs=None, profile=None, control=None) -> "Router":
        """Multi-engine router: N async server replicas behind ONE submit
        surface (``repro_torch.cluster.Router``), with pluggable routing.
        Every replica runs on this LVLM's device and shares its weights;
        only the KV pools are per replica, so a KV migration between
        replicas is a device-to-device copy on one card.

        ``replicas`` is an int (homogeneous fleet sharing ``engine_cfg`` /
        ``gen`` / ``draft`` / ``admission``) or a sequence of per-replica
        override dicts with any of those keys -- a heterogeneous fleet,
        e.g. one speculative-heavy replica and one early-exit replica:

            router = lvlm.serve_cluster(
                [{"gen": GenerationConfig(decoder="speculative", gamma=4)},
                 {"gen": GenerationConfig(decoder="early_exit")}],
                routing="least_kv")
            async with router:
                async for tok in router.submit(req):
                    ...

        ``routing`` is a ``repro_torch.cluster.ROUTING_POLICIES`` name
        (round_robin | least_kv | prefix_affinity) or a policy instance.

        ``roles`` disaggregates the fleet (unified | prefill | decode,
        one per replica; a per-replica spec dict may carry a ``"role"``
        key instead): prefill replicas hand post-compression KV to
        decode replicas over the modeled KV link. ``shared_prefix``
        promotes the per-replica prefix caches to one cluster-shared
        radix tier (default: exactly when the fleet is role-split).
        Pacing/disconnect knobs apply to every replica (see
        ``serve_async``). With one replica the router streams are
        bit-identical to the bare server's.
        """
        from repro_torch.cluster import Router

        if isinstance(replicas, int):
            if replicas < 1:
                raise ValueError("serve_cluster needs at least one replica")
            specs: List[Dict] = [{} for _ in range(replicas)]
        else:
            specs = [dict(s) for s in replicas]
            if not specs:
                raise ValueError("serve_cluster needs at least one replica")
        if roles is not None and len(roles) != len(specs):
            raise ValueError(f"roles has {len(roles)} entries for "
                             f"{len(specs)} replicas")
        rep_roles = list(roles) if roles is not None \
            else ["unified"] * len(specs)
        # ONE tracer for the whole fleet: a migrated request's spans land
        # in a single contiguous trace; the Router assigns each engine its
        # replica track index. Same for the profiler: fleet-merged site
        # histograms, rendered once in Router.metrics_snapshot()
        tracer = self._resolve_obs(obs)
        profiler = self._resolve_profile(profile)
        # ... and ONE adaptive controller: per-replica pressure levels,
        # fleet-shared actuation counters, router-level routing bias
        ctl = self._resolve_control(control)
        servers = []
        for i, spec in enumerate(specs):
            unknown = set(spec) - {"engine_cfg", "gen", "draft", "admission",
                                   "compressors", "role"}
            if unknown:
                raise ValueError(f"unknown replica spec keys: {unknown}")
            if "role" in spec:
                rep_roles[i] = spec["role"]
            servers.append(self.serve_async(
                spec.get("engine_cfg", engine_cfg),
                spec.get("gen", gen),
                draft=spec.get("draft", draft),
                admission=spec.get("admission", admission),
                compressors=spec.get("compressors", compressors),
                pacing=pacing, pacing_scale=pacing_scale,
                disconnect_timeout_s=disconnect_timeout_s,
                obs=tracer, profile=profiler, control=ctl))
        return Router(servers, routing=routing, roles=rep_roles,
                      shared_prefix=shared_prefix, control=ctl)
