# analysis: allow R001 (slice 1 ports no KV migration, so there is no complete_export to release)
"""The LVLM serving engine of the port (the main path plus dim 1).

Port of ``repro.core.serving.engine``: one ``Engine`` drives the model over
a dense slot pool (the preallocated [layers, max_batch, cache_len, K, D]
KV cache) under any of the four schedulers (static | continuous | mlfq |
chunked, the last running real ``model.extend`` chunk continuation), with
a virtual clock advanced by the analytic ``CostModel``, so TTFT/TPOT/JCT
are the reference's numbers exactly. Decoding runs behind the reference's
decoder hook (``engine_decode``); the default is ``SamplingEngineDecoder``.

Visual-token compression (dim 1) is per request, as in the reference: a
compressor registry (``Engine(compressor=, compressors=)``), each request
naming its strategy (``Request.compression``), the strategy run on the
engine's device on the request's visual embeddings before prefill, and KV
accounting on the POST-compression token count.

Left to later slices (ROADMAP queue A), and refused with
``NotImplementedError`` when a request or config asks for them: prefix
caching and live KV compaction -- any compression strategy with a
``decode_budget()`` (``streaming-kv``, ``l2-kv``,
``<selector>-kv-<budget>``) -- (A9, slice 3), the speculative and
early-exit decoders (slice 4), KV migration / handoff (slice 6), tracing,
profiling and the runtime sanitizer (slice 5).

NOTE: ``repro_torch.api`` (``LVLM``) is the public surface.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CompressionConfig
from repro_torch.core.decoding.sampling import sample_token
from repro_torch.core.serving.disaggregation import CostModel
from repro_torch.core.serving.request import Request, State, summarize
from repro_torch.core.serving.scheduler import SCHEDULERS
from repro_torch.core.token_compression.policy import (
    CompressionStrategy, resolve_compression)
from repro_torch.models.layers import embed_tokens


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    cache_len: int = 256
    scheduler: str = "continuous"
    # KV token capacity the continuous/mlfq schedulers budget against;
    # None = the dense slot pool's size, max_batch * cache_len
    kv_capacity_tokens: Optional[int] = None
    chunk_size: int = 32                 # chunked-prefill chunk
    token_budget: int = 128              # chunked-prefill per-iter budget
    temperature: float = 0.0
    top_k: int = 0                       # 0 = no top-k warp
    top_p: float = 0.0                   # 0 = no nucleus warp
    eos_id: int = -1                     # -1 = never stop on eos
    seed: int = 0
    decoder: str = "sampling"            # default strategy: sampling|greedy
    # (no compression field: the default compression strategy reaches the
    # engine only as Engine(compressor=), which the facade builds)
    cost: CostModel = dataclasses.field(default_factory=CostModel)


class SamplingEngineDecoder:
    """Default decoder hook: one fixed-shape decode step over the whole
    slot pool, then temperature/top-k/top-p sampling.

    Hook contract (as the reference): ``engine_decode(engine, reqs) ->
    {slot: [emitted tokens]}``; the decoder owns the forward pass and the
    slot bookkeeping (``pool`` / ``slot_pos`` / ``slot_last_tok``).
    """
    name = "sampling"

    def __init__(self, greedy: bool = False):
        self.greedy = greedy
        self.name = "greedy" if greedy else "sampling"

    def stats(self) -> Dict:
        return {}

    def engine_decode(self, eng: "Engine", reqs: List[Request]) -> Dict:
        ec = eng.ec
        toks = np.zeros((ec.max_batch, 1), np.int64)
        # fixed-shape decode runs EVERY slot; inactive slots (empty or
        # mid-prefill) write to the reserved scratch position cache_len-1
        # (requests are capacity-checked never to reach it)
        pos = np.full(ec.max_batch, ec.cache_len - 1, np.int64)
        for r in reqs:
            toks[r._slot, 0] = eng.slot_last_tok[r._slot]
            pos[r._slot] = eng.slot_pos[r._slot]
        logits, eng.pool = eng.model.decode_step(
            eng.params, eng.pool, torch.from_numpy(toks).to(eng.device),
            torch.from_numpy(pos).to(eng.device))
        temp = 0.0 if self.greedy else ec.temperature
        nxt = sample_token(eng.gen, logits, temperature=temp, top_k=ec.top_k,
                           top_p=ec.top_p).cpu().numpy()
        emitted: Dict[int, List[int]] = {}
        for r in reqs:
            s = r._slot
            tok = int(nxt[s])
            eng.slot_last_tok[s] = tok
            eng.slot_pos[s] += 1
            emitted[s] = [tok]
        return emitted


def _make_default_decoder(name: str):
    if name in ("sampling", "greedy"):
        return SamplingEngineDecoder(greedy=(name == "greedy"))
    # strategy adapters live one layer up; resolved lazily, as the reference
    from repro_torch.api.decoders import make_decoder
    return make_decoder(name)


def _slot_get(pool, slot):
    """One slot's cache as a batch-1 cache: a view, so writes through it
    land in the pool."""
    return {k: (_slot_get(v, slot) if isinstance(v, dict)
                else v[:, slot:slot + 1]) for k, v in pool.items()}


def _slot_set(pool, slot, one):
    """Copy a batch-1 cache into the pool's slot, in place (the
    reference's ``.at[:, slot].set`` returns a new pool)."""
    for k, v in pool.items():
        if isinstance(v, dict):
            _slot_set(v, slot, one[k])
        else:
            v[:, slot] = one[k][:, 0]


class Engine:
    def __init__(self, model, params, ec: EngineConfig, *, compressor=None,
                 compressors: Optional[Dict] = None):
        self.ec = ec
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = params["embed"]["tok"].device
        self.pool = model.init_cache(ec.max_batch, ec.cache_len,
                                     device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * ec.max_batch
        self.slot_pos = np.zeros(ec.max_batch, np.int64)   # next write pos
        self.slot_last_tok = np.zeros(ec.max_batch, np.int64)
        self.slot_nv = np.zeros(ec.max_batch, np.int64)    # visual offset

        kw: Dict = {}
        if ec.scheduler in ("continuous", "mlfq"):
            kw = dict(max_batch=ec.max_batch,
                      kv_capacity_tokens=self.kv_capacity_tokens)
        elif ec.scheduler == "chunked":
            kw = dict(max_batch=ec.max_batch, token_budget=ec.token_budget,
                      chunk_size=ec.chunk_size)
        elif ec.scheduler == "static":
            kw = dict(batch_size=ec.max_batch)
        self.sched = SCHEDULERS[ec.scheduler](**kw)

        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        self.aborted: List[Request] = []
        self.clock = 0.0
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(ec.seed)
        self.iters = 0
        # cumulative decode-phase virtual-clock cost per strategy group
        self.group_costs: Dict[str, float] = {}

        # decoder registry: the configured default plus the strategies
        # requests name (``Request.decoder``), resolved lazily
        self.decoder = _make_default_decoder(ec.decoder)
        self._default_name = self.decoder.name
        self._decoders: Dict[str, object] = {self._default_name: self.decoder}
        self._used_decoders: set = set()

        # compressor registry: the default strategy (no compression unless
        # the caller passes one) plus named per-request strategies; unknown
        # names resolve lazily through the preset / parametric grammar,
        # validated on first use like decoders
        self.compressor = compressor if compressor is not None \
            else CompressionStrategy(CompressionConfig())
        self._compressors: Dict[str, object] = dict(compressors or {})
        self._default_comp_name = getattr(self.compressor, "name", "none")
        self._compressors[self._default_comp_name] = self.compressor
        self._validated_comps: set = set()
        # per-strategy visual-token counters: name -> [in, out]
        self._comp_counts: Dict[str, List[int]] = {}
        self._validate_compressor(self._default_comp_name, self.compressor)

    # ----------------------------------------------------------- decoders --
    def _resolve_decoder(self, name: Optional[str]) -> Tuple[str, object]:
        """Per-request strategy resolution: None -> the engine default."""
        if name is None:
            return self._default_name, self.decoder
        dec = self._decoders.get(name)
        if dec is None:
            dec = _make_default_decoder(name)
            self._decoders[name] = dec
        return name, dec

    def decoder_stats(self) -> Dict:
        """Counters of every strategy that served a request (flat keys for
        one strategy, prefixed with its name for a mixed run)."""
        names = [n for n in self._decoders if n in self._used_decoders]
        if not names:
            names = [self._default_name]
        if len(names) == 1:
            return dict(self._decoders[names[0]].stats())
        out: Dict = {}
        for n in names:
            for k, v in self._decoders[n].stats().items():
                out[f"{n}/{k}"] = v
        return out

    @staticmethod
    def _check_served(req: Request) -> None:
        """Refuse what this slice of the port does not serve yet."""
        if req.handoff:
            raise NotImplementedError(
                f"request {req.rid}: KV handoff (disaggregated serving) is "
                "not ported yet (ROADMAP queue A, slice 6)")

    # -------------------------------------------------------- compressors --
    def _validate_compressor(self, name: str, comp) -> None:
        if name in self._validated_comps:
            return
        if getattr(comp, "decode_budget", lambda: None)() is not None:
            raise NotImplementedError(
                f"compression strategy {name!r} compacts the KV cache live, "
                "which is not ported yet (ROADMAP A9, the compacting "
                "engine)")
        validate = getattr(comp, "validate", None)
        if validate is not None:
            validate(self)
        self._validated_comps.add(name)

    def _resolve_compressor(self, name: Optional[str]) -> Tuple[str, object]:
        """Per-request compression resolution: None -> the engine default;
        otherwise a registered strategy or any preset/parametric name
        (resolved lazily, mirror of ``_resolve_decoder``)."""
        if name is None:
            return self._default_comp_name, self.compressor
        comp = self._compressors.get(name)
        if comp is None:
            comp = CompressionStrategy(resolve_compression(name), name=name)
            self._compressors[name] = comp
        self._validate_compressor(name, comp)
        return name, comp

    def _stamp_compressed_nv(self, req: Request) -> None:
        """Resolve the request's strategy and stamp its POST-compression
        visual count (idempotent; the basis of all KV accounting)."""
        if req.nv_compressed is not None or req.visual_embeds is None:
            return
        _, comp = self._resolve_compressor(req.compression)
        req.nv_compressed = int(
            comp.compressed_token_count(len(req.visual_embeds)))

    def compression_stats(self) -> Dict[str, Dict]:
        """Per-strategy visual-token reduction of every strategy that
        compressed a request's prefill: ``{name: {visual_tokens_in,
        visual_tokens_out, prefill_token_reduction}}``."""
        return {name: {"visual_tokens_in": vin,
                       "visual_tokens_out": vout,
                       "prefill_token_reduction":
                           (1.0 - vout / vin) if vin else 0.0}
                for name, (vin, vout) in self._comp_counts.items()}

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        self._check_served(req)
        name, _ = self._resolve_decoder(req.decoder)
        self._used_decoders.add(name)
        req._comp_name, _ = self._resolve_compressor(req.compression)
        self._stamp_compressed_nv(req)
        # (the speculative decoder's KV lookahead arrives with slice 4);
        # capacity is checked against what actually lands in the cache:
        # the POST-compression prompt length
        need = req.kv_prompt_len + req.max_new_tokens + req.lookahead
        if need > self.ec.cache_len - 1:
            raise ValueError(
                f"request {req.rid} needs {need} tokens"
                f" (incl. {req.lookahead} decode lookahead);"
                f" cache_len-1 = {self.ec.cache_len - 1} available"
                " (last position is the inactive-slot scratch)")
        req.arrival = max(req.arrival, self.clock)
        self.waiting.append(req)

    # -------------------------------------------------- kv accounting --
    @property
    def kv_capacity_tokens(self) -> int:
        if self.ec.kv_capacity_tokens is not None:
            return self.ec.kv_capacity_tokens
        return self.ec.max_batch * self.ec.cache_len

    def _kv_block(self) -> int:
        return int(getattr(self.sched, "block_size", 16))

    def kv_request_tokens(self, req: Request) -> int:
        """Block-rounded KV reservation one request commits the pool to:
        POST-compression prompt + max_new + decode lookahead (the strategy
        resolves via the request even before submit, so admission never
        over-reserves for tokens the pruner will drop)."""
        self._stamp_compressed_nv(req)
        bs = self._kv_block()
        need = req.kv_prompt_len + req.max_new_tokens + req.lookahead
        return ((need + bs - 1) // bs) * bs

    def kv_committed_tokens(self, include_waiting: bool = True) -> int:
        """Total KV reservation of live requests (returns to baseline after
        finish/abort)."""
        live = [r for r in self.running if r.state != State.DONE]
        if include_waiting:
            live += [r for r in self.waiting if r.state != State.DONE]
        return sum(self.kv_request_tokens(r) for r in live)

    # -------------------------------------------------------- lifecycle --
    # analysis: allow R001 (slice 1 holds no draft rows or prefix pins: unbinding the slot is the whole release)
    def _release_request(self, r: Request) -> None:
        """Free every resource a request holds: its slot in the pool (this
        slice has no draft-pool rows or prefix pins)."""
        slot = getattr(r, "_slot", None)
        if slot is not None and self.slot_req[slot] is r:
            self.slot_req[slot] = None

    # analysis: allow R001 (tracing is not ported yet, so there is no span to close)
    def abort(self, rid: int) -> bool:
        """Cancel a request mid-flight: frees its slot; the request is
        marked ``aborted`` and never reaches ``finished``. Returns False
        if ``rid`` is unknown or already retired."""
        for pool in (self.waiting, self.running):
            for r in pool:
                if r.rid == rid and r.state != State.DONE:
                    pool.remove(r)
                    self._release_request(r)
                    r.state = State.DONE
                    r.aborted = True
                    self.aborted.append(r)
                    return True
        return False

    # ------------------------------------------------------------ prefill --
    def _free_slot(self) -> int:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        raise RuntimeError("no free slot (scheduler overcommitted)")

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64)[None],
                               device=self.device)

    def _prompt_query_embeds(self, req: Request) -> Optional[torch.Tensor]:
        """Text-prompt embeddings [1, Q, d] for cross-modal pruners
        (sparsevlm / cdpruner rank visual tokens by instruction
        relevance), in the embedding table's dtype."""
        if not req.tokens:
            return None
        return embed_tokens(self.params["embed"], self._tokens(req.tokens))

    def _compress_visual(self, req: Request) -> Optional[torch.Tensor]:
        """dim 1: the request's compression strategy runs on its visual
        embeddings, on the engine's device, before they enter the
        backbone, in the dtype the request gave them (float32): the model
        casts them to its own dtype only after (bf16 scores would tie).
        Returns the [N', d] device tensor the prefill takes."""
        if req.visual_embeds is None:
            return None
        ve = torch.as_tensor(np.asarray(req.visual_embeds),
                             device=self.device)
        _, comp = self._resolve_compressor(req.compression)
        nv_in = ve.shape[0]
        if getattr(comp, "encoder_active", True):
            # the query embed is only built for strategies that consume it
            # (custom strategies default to yes)
            q = self._prompt_query_embeds(req) \
                if getattr(comp, "needs_query", True) else None
            ve = comp.compress_prefill(ve[None], query=q)[0][0]
        cnt = self._comp_counts.setdefault(req._comp_name, [0, 0])
        cnt[0] += nv_in
        cnt[1] += ve.shape[0]
        return ve

    def _do_prefill_chunk(self, req: Request, n: int) -> None:
        ec = self.ec
        n = min(n, len(req.tokens) - req.prefill_done)
        if n <= 0:
            return
        if req.prefill_done == 0:
            slot = self._free_slot()
            req._slot = slot
            self.slot_req[slot] = req
            req._ve = self._compress_visual(req)
            self.slot_nv[slot] = 0 if req._ve is None else req._ve.shape[0]
            # visual tokens are prefill work too (the dim-1 latency claim:
            # the virtual clock sees the post-compression count)
            self._iter_visual_tokens += int(self.slot_nv[slot])
        slot = req._slot
        nv = int(self.slot_nv[slot])
        start, end = req.prefill_done, req.prefill_done + n

        if req.prefill_done == 0:
            batch = {"tokens": self._tokens(req.tokens[:end])}
            if req._ve is not None:
                batch["visual_embeds"] = req._ve[None]
            # only the last position's logits are read (the reference
            # unembeds every position and slices the last)
            logits, one = self.model.prefill(self.params, batch,
                                             cache_len=ec.cache_len,
                                             last_only=True)
            _slot_set(self.pool, slot, one)
        else:
            # the batch-1 slot view is extended in place: no copy back
            logits, _ = self.model.extend(
                self.params, _slot_get(self.pool, slot),
                self._tokens(req.tokens[start:end]), nv + start)

        req.prefill_done = end
        self.slot_pos[slot] = nv + end
        if req.prefill_done >= len(req.tokens):
            # prompt complete: first token comes from the last logits
            _, dec = self._resolve_decoder(req.decoder)
            temp = 0.0 if getattr(dec, "greedy", False) else ec.temperature
            tok = int(sample_token(self.gen, logits[:, -1], temperature=temp,
                                   top_k=ec.top_k, top_p=ec.top_p)[0])
            req.generated.append(tok)
            req._needs_ttft = True
            self.slot_last_tok[slot] = tok
            if req.is_finished() or tok == ec.eos_id:
                req.state = State.DONE
            else:
                req.state = State.DECODE
            if req in self.waiting:
                self.waiting.remove(req)
            self.running.append(req)

    # ------------------------------------------------------------- decode --
    def _decode_iteration(self, reqs: List[Request]) -> None:
        """One decode iteration through the decoder hooks: slots grouped by
        strategy, each group charged its virtual-clock cost."""
        groups: Dict[str, List[Request]] = {}
        for r in reqs:
            name, _ = self._resolve_decoder(r.decoder)
            groups.setdefault(name, []).append(r)
        total_cost = 0.0
        emitted_all: Dict[int, List[int]] = {}
        for name, group in groups.items():
            emitted_all.update(self._decoders[name].engine_decode(self,
                                                                  group))
            # mean context after the step advanced slot_pos (as the
            # reference reads it)
            ctx = float(np.mean([self.slot_pos[r._slot] for r in group]))
            cost = self.ec.cost.decode_step_time(len(group), ctx)
            total_cost += cost
            self.group_costs[name] = self.group_costs.get(name, 0.0) + cost
        self._iter_decode_cost = total_cost
        for r in reqs:
            for tok in emitted_all.get(r._slot, ()):
                r.generated.append(tok)
                r.served_tokens += 1
                if r.is_finished() or tok == self.ec.eos_id:
                    r.state = State.DONE
                    break

    # --------------------------------------------------------------- step --
    # analysis: allow R001 (tracing is not ported yet, so there is no span to close)
    def step(self) -> bool:
        """One scheduler iteration. Returns False when fully idle."""
        self.running = [r for r in self.running if r.state != State.DONE]
        visible = [r for r in self.waiting if r.arrival <= self.clock]
        plan = self.sched.plan(visible, self.running)
        decode_reqs = [r for r in plan.decode if r.state == State.DECODE]
        if not plan.prefill and not decode_reqs:
            future = [r.arrival for r in self.waiting
                      if r.arrival > self.clock]
            if future:                  # idle until the next arrival
                self.clock = min(future)
                return True
            return False
        self._iter_visual_tokens = 0
        for req, n in plan.prefill:
            self._do_prefill_chunk(req, n)
        self._iter_decode_cost = 0.0      # summed per strategy group
        if decode_reqs:
            self._decode_iteration(decode_reqs)
        # virtual clock
        dt = self.ec.cost.prefill_time(plan.prefill_tokens
                                       + self._iter_visual_tokens)
        dt += self._iter_decode_cost
        self.clock += dt
        self.iters += 1
        # stamp times & retire
        seen, stampable = set(), []
        for r in self.running + [r for r, _ in plan.prefill]:
            if id(r) not in seen:
                seen.add(id(r))
                stampable.append(r)
        for r in stampable:
            if getattr(r, "_needs_ttft", False):
                r.first_token_time = self.clock
                r._needs_ttft = False
            if r.state == State.DONE and r.finish_time is None:
                r.finish_time = self.clock
                self.finished.append(r)
                self._release_request(r)
        self.running = [r for r in self.running if r.state != State.DONE]
        return True

    def run(self, max_iters: int = 100000) -> Dict:
        it = 0
        while self.step():
            it += 1
            if it >= max_iters:
                break
        out = summarize(self.finished)
        out["iterations"] = self.iters
        out["virtual_time_s"] = self.clock
        return out
