"""Port of ``repro.core.serving.scheduler`` (pure Python, unchanged).

Iteration-level schedulers (survey dim 2c-i): static batching (baseline),
Orca/vLLM continuous batching, FastServe skip-join MLFQ, and Sarathi-Serve
chunked prefill. Schedulers are pure control planes: each call to ``plan``
returns an IterationPlan -- which requests prefill how many tokens and which
decode one token this iteration -- so the same scheduler drives both the
real engine (engine.py) and the analytic simulator (disaggregation.py /
benchmarks).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.serving.request import Request, State


@dataclasses.dataclass
class IterationPlan:
    prefill: List[Tuple[Request, int]]      # (request, n_prompt_tokens)
    decode: List[Request]

    @property
    def prefill_tokens(self) -> int:
        return sum(n for _, n in self.prefill)

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + len(self.decode)


class StaticBatcher:
    """Baseline: admit a fixed batch, run it to completion, then the next.

    This is the head-of-line-blocking strawman the survey's continuous
    batching section (Orca) eliminates.
    """

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.current: List[Request] = []

    def plan(self, waiting: List[Request], running: List[Request]
             ) -> IterationPlan:
        # drop finished AND eos-stopped (DONE before max_new_tokens) requests
        self.current = [r for r in self.current
                        if not r.is_finished() and r.state != State.DONE]
        if not self.current:
            admit = waiting[: self.batch_size]
            for r in admit:
                r.state = State.PREFILL
            self.current = list(admit)
            return IterationPlan([(r, len(r.tokens)) for r in admit], [])
        return IterationPlan([], list(self.current))


class ContinuousBatcher:
    """Orca/vLLM iteration-level scheduling.

    Every iteration: finished requests leave immediately; waiting requests
    are admitted while decode slots AND KV blocks remain. Admission runs
    full-prompt prefill (one iteration), then the request joins the decode
    batch -- diverse-length requests coexist.
    """

    def __init__(self, max_batch: int, kv_capacity_tokens: int,
                 block_size: int = 16):
        self.max_batch = max_batch
        self.kv_capacity = kv_capacity_tokens
        self.block_size = block_size

    def _kv_used(self, running: List[Request]) -> int:
        # ``lookahead`` reserves the speculative draft/verify slack: those
        # slots write up to gamma positions past the committed stream, so
        # capacity accounting must include it or admission overcommits.
        # ``kv_total_len`` counts POST-compression visual tokens -- what
        # the pool actually holds -- so compressed requests free real
        # admission headroom instead of reserving for pruned tokens.
        bs = self.block_size
        return sum(((r.kv_total_len + r.max_new_tokens + r.lookahead
                     + bs - 1) // bs) * bs
                   for r in running)

    def plan(self, waiting: List[Request], running: List[Request]
             ) -> IterationPlan:
        running = [r for r in running if not r.is_finished()]
        prefill = []
        used = self._kv_used(running)
        for r in list(waiting):
            if len(running) + len(prefill) >= self.max_batch:
                break
            need = ((r.kv_prompt_len + r.max_new_tokens + r.lookahead
                     + self.block_size - 1)
                    // self.block_size) * self.block_size
            if used + need > self.kv_capacity:
                break
            prefill.append((r, len(r.tokens)))
            used += need
            r.state = State.PREFILL
        return IterationPlan(prefill, running)


class MLFQScheduler:
    """FastServe skip-join Multi-Level Feedback Queue.

    Requests enter at the level matching their prompt length (skip-join),
    are served shortest-first, and are demoted after exceeding the level's
    token quantum -- preempting long-running decodes to cut mean JCT.
    """

    def __init__(self, max_batch: int, kv_capacity_tokens: int,
                 levels: int = 4, base_quantum: int = 16,
                 block_size: int = 16):
        self.max_batch = max_batch
        self.kv_capacity = kv_capacity_tokens
        self.levels = levels
        self.base_quantum = base_quantum
        self.block_size = block_size

    def entry_level(self, r: Request) -> int:
        q = self.base_quantum
        for lvl in range(self.levels):
            if r.prompt_len <= q:
                return lvl
            q *= 4
        return self.levels - 1

    def quantum(self, level: int) -> int:
        return self.base_quantum * (4 ** level)

    def plan(self, waiting: List[Request], running: List[Request]
             ) -> IterationPlan:
        for r in waiting:
            if r.priority == 0 and r.served_tokens == 0:
                r.priority = self.entry_level(r)
        # demote exhausted requests
        for r in running:
            if r.served_tokens > self.quantum(r.priority) \
                    and r.priority < self.levels - 1:
                r.priority += 1
        # highest priority (lowest level) first; preempt the rest
        pool = [r for r in running if not r.is_finished()]
        pool.sort(key=lambda r: (r.priority, r.arrival))
        active = pool[: self.max_batch]
        for r in pool[self.max_batch:]:
            r.state = State.PREEMPTED
        prefill = []
        if len(active) < self.max_batch and waiting:
            cands = sorted(waiting, key=lambda r: (r.priority, r.arrival))
            for r in cands[: self.max_batch - len(active)]:
                prefill.append((r, len(r.tokens)))
                r.state = State.PREFILL
        return IterationPlan(prefill, active)


class ChunkedPrefillScheduler:
    """Sarathi-Serve: split prefills into chunks, co-schedule with decodes.

    Each iteration has a token budget; decodes (1 token each) get strict
    priority (they are latency-critical), the remaining budget is filled
    with prefill CHUNKS -- saturating compute without stalling decodes.
    """

    def __init__(self, max_batch: int, token_budget: int = 512,
                 chunk_size: int = 128):
        self.max_batch = max_batch
        self.token_budget = token_budget
        self.chunk_size = chunk_size

    def plan(self, waiting: List[Request], running: List[Request]
             ) -> IterationPlan:
        decode = [r for r in running if not r.is_finished()][: self.max_batch]
        budget = self.token_budget - len(decode)
        prefill = []
        # in-flight (partially prefilled) first, then new admissions
        partial = [r for r in waiting if 0 < r.prefill_done < len(r.tokens)]
        fresh = [r for r in waiting if r.prefill_done == 0]
        for r in partial + fresh:
            if budget <= 0 or len(decode) + len(prefill) >= self.max_batch:
                break
            n = min(self.chunk_size, len(r.tokens) - r.prefill_done, budget)
            if n <= 0:
                continue
            prefill.append((r, n))
            budget -= n
            r.state = State.PREFILL
        return IterationPlan(prefill, decode)


SCHEDULERS = {
    "static": StaticBatcher,
    "continuous": ContinuousBatcher,
    "mlfq": MLFQScheduler,
    "chunked": ChunkedPrefillScheduler,
}
