"""One run of one cell: set-up, the measured window, the drain.

Every cell drives the port's serving path: ``LVLM.serve_async`` and the
token streams of ``AsyncLVLMServer.submit``, consumed by the benchmark's
own asyncio clients (``traffic/<loop>.py``). Every time is taken on the
client, with ``time.perf_counter``, as a token comes out of its stream;
the program's virtual clock is read for nothing.

- set-up: process start to the window's opening. The weights are drawn
  on the device from the seed, the kernels built (or, after the first
  run in a checkout, loaded from ``src/repro_torch/kernels/_build/``), and
  the cell's shapes warmed by requests from a stream apart from the
  measured one: the largest and the smallest prompt of the mix. A closed
  loop's clients then run ``ramp_s`` seconds before the window opens,
  the first request of each cut to a share of its output, so that the
  clients' phases are spread as in steady state.
- the window: ``--seconds`` long. An open loop's request is timed from
  when it was due; a closed loop's from when it was sent. Requests sent
  in the window are its requests.
- the drain: every request of the window is served to its end; one that
  fails or is not done ``DRAIN_LIMIT_S`` after the window closes is
  aborted and counts as failed, entering every latency as +inf.

Decoding is greedy with ``eos_id=-1``: outputs are as long as drawn.
"""
from __future__ import annotations

import asyncio
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import probe, traffic
from harness import devtrace
from harness.devtrace import DeviceTrace
from harness.spec import loop_module
from harness.weights import (TRAFFIC, WARMUP, make_params, stream,
                             visual_bank)

WARM_RID = 1 << 40
DRAIN_LIMIT_S = 120.0       # a window's request not done by then fails


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Run:
    """State of one run (see the module docstring)."""

    def __init__(self, cell: Dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.cfg, self.mix = cell, cell["cfg"], cell["mix"]
        self.seed, self.seconds, self.trace = seed, float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.records: List[Dict] = []
        self.submit_t: Dict[int, float] = {}
        self.calls: List[Dict] = []
        self.spans: List = []
        self.logits: Dict = {}
        self.capture_s = 0.0
        self.capture_calls = 0
        self.window_cpu_s = 0.0     # the process's CPU seconds in the window
        self.ws: Optional[float] = None      # window start / end
        self.we: Optional[float] = None
        self.closed = False
        self.profiling = False
        self.devtrace: Optional[DeviceTrace] = None
        self._prof = None
        self._prof_t0 = 0.0
        self._rid = 0
        self.rounds: List[List[Dict]] = []
        self.setup_s: Optional[float] = None

    # ------------------------------------------------------------ set-up --
    def build(self) -> None:
        from repro_torch.api import GenerationConfig, LVLM
        from repro_torch.configs import get_config
        from repro_torch.core.serving import EngineConfig
        from repro_torch.models.registry import build

        port = self.cfg["port"]
        mcfg = get_config(port["arch"], smoke=port.get("smoke", False))
        if port.get("overrides"):
            mcfg = mcfg.with_(**port["overrides"])
        self.model = build(mcfg)
        self.params = make_params(self.model.param_specs(), self.seed,
                                  mcfg.dtype, self.device)
        self.lvlm = LVLM(self.model, self.params)
        t = time.perf_counter()
        log(f"set-up: weights drawn at {t - self.t_start:.3f} s")
        if self.trace and self.device.type == "cuda":
            # the profiler's first start initialises its tracer for seconds:
            # done here, in set-up, not between two steps of the window
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=self.device).add_(1)
                torch.cuda.synchronize()
        if self.device.type == "cuda":
            from repro_torch.kernels.build import build_all
            build_all(self.cfg["kernels"])
            log(f"set-up: kernels ready at "
                f"{time.perf_counter() - self.t_start:.3f} s")
        mix = self.mix
        self.vocab = self.cfg["vocab_size"]
        nv_max = traffic.largest(mix, "visual")
        self.bank = visual_bank(self.seed, 2 * nv_max,
                                self.cfg["hidden_size"], self.device)
        need = nv_max + traffic.largest(mix, "text") \
            + traffic.largest(mix, "output") + 2
        eng = self.cell["engine"]
        self.ec = EngineConfig(max_batch=eng["max_batch"],
                               cache_len=-(-need // 16) * 16,
                               scheduler="continuous")
        self.gen = GenerationConfig(decoder="greedy", temperature=0.0,
                                    eos_id=-1)
        self.traffic_seed = stream(self.seed, TRAFFIC)

    def rng(self, *key: int) -> np.random.Generator:
        """The generator of one request (or round) of the traffic: keyed
        by its place in the schedule, never by the order in which the
        clients happen to run, so one seed always gives the same inputs."""
        return np.random.default_rng([self.traffic_seed, *key])

    def make_request(self, size: Dict, rng: np.random.Generator, rid=None):
        from repro_torch.core.serving import Request
        if rid is None:
            rid, self._rid = self._rid, self._rid + 1
        tokens = rng.integers(0, self.vocab, size["text"]).tolist()
        ve = None
        if size["visual"]:
            off = int(rng.integers(0, len(self.bank) - size["visual"] + 1))
            ve = self.bank[off:off + size["visual"]]
        return Request(rid=rid, tokens=tokens,
                       max_new_tokens=int(size["output"]), visual_embeds=ve)

    async def warm(self, server) -> None:
        """The cell's largest and smallest prompts, a few tokens each."""
        rng = self.rng(WARMUP << 32)
        lens = self.mix["lengths"]
        sizes = [{d: int(lens[d][k]) if d in lens else 0
                  for d in traffic.DIMS} for k in ("hi", "lo")]
        reqs = [self.make_request(dict(s, output=3), rng, WARM_RID + i)
                for i, s in enumerate(sizes)]

        async def one(req):
            async for _ in server.submit(req):
                pass
        await asyncio.gather(*(one(r) for r in reqs))

    # ------------------------------------------------------------ window --
    def open_window(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.ws = time.perf_counter()
        self.setup_s = self.ws - self.t_start
        self._cpu0 = time.process_time()
        return self.ws

    def close_window(self) -> None:
        self.we = time.perf_counter()
        self.closed = True
        self.window_cpu_s = time.process_time() - self._cpu0
        self._stop_profiler()

    def in_window(self, t: float) -> bool:
        return self.ws is not None and t >= self.ws and (
            self.we is None or t < self.we)

    def next_size(self, client: int, n: int) -> Dict:
        """A closed loop's ``n``-th request of ``client``: round ``n`` of
        stratified sizes, dealt one a client."""
        clients = self.mix["clients"]
        while len(self.rounds) <= n:
            self.rounds.append(traffic.sizes(
                self.mix, clients, self.rng(1 << 30, len(self.rounds))))
        return dict(self.rounds[n][client])

    async def consume(self, server, req, due: Optional[float]) -> Dict:
        rec = {"rid": req.rid, "req": req, "due": due,
               "sent": time.perf_counter(), "times": [], "failed": None}
        if due is None:
            rec["due"] = rec["sent"]
        self.records.append(rec)
        try:
            async for _ in server.submit(req):
                rec["times"].append(time.perf_counter())
        except Exception as exc:                     # noqa: BLE001
            rec["failed"] = repr(exc)
        if rec["failed"] is None and len(rec["times"]) != req.max_new_tokens:
            rec["failed"] = (f"{len(rec['times'])} of {req.max_new_tokens}"
                             " tokens")
        return rec

    async def drain(self, server, tasks) -> None:
        limit = DRAIN_LIMIT_S
        if tasks:
            _, pending = await asyncio.wait(tasks, timeout=limit)
            for t in pending:
                t.cancel()
            for rec in self.window_records():
                if not rec["failed"] and len(rec["times"]) \
                        < rec["req"].max_new_tokens:
                    server.abort(rec["rid"])
                    rec["failed"] = f"not done {limit} s after the window"
            if pending:
                await asyncio.wait(pending, timeout=10)

    # --------------------------------------------------------- profiler --
    def before_step(self) -> None:
        """Start or stop the traced stretch between two engine steps."""
        if not self.trace or self.ws is None:
            return
        now = time.perf_counter()
        prof = self.cell.get("profile", {})
        if self._prof is None and not self.closed and \
                now >= self.ws + prof.get("start_s", 2.0):
            acts = [torch.profiler.ProfilerActivity.CUDA] \
                if self.device.type == "cuda" \
                else [torch.profiler.ProfilerActivity.CPU]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            # host nanoseconds -> the trace's epoch nanoseconds
            self._prof_off = time.time_ns() - time.perf_counter_ns()
            self._prof_t0 = time.perf_counter()
            self._prof_ns = [time.perf_counter_ns(), None]
            self.profiling = True
        elif self.profiling and now >= self._prof_t0 + prof.get(
                "seconds", 3.0):
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self.profiling:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self._prof_ns[1] = time.perf_counter_ns()
            self._prof.stop()
            self.profiling = False

    def reduce_trace(self) -> None:
        if self._prof is not None:
            off = self._prof_off
            spans = [(n, a + off, b + off) for n, a, b in self.spans]
            self.devtrace = DeviceTrace(devtrace.device_events(self._prof),
                                        spans, self._prof_ns[0] + off,
                                        self._prof_ns[1] + off)
            self._prof = None
            log("trace:", self.devtrace.summary())

    # ------------------------------------------------------------- drive --
    async def serve(self) -> None:
        server = self.lvlm.serve_async(self.ec, self.gen)
        self.server = server
        probe.hook_submit(self, server.engine)
        rows = int(self.cell["check"].get("logit_rows", 0))
        if rows:
            probe.capture_logits(self, server.engine, rows)
        if self.trace:
            probe.install(self, server.engine)
        loop = loop_module(self.mix["loop"])
        async with server:
            await self.warm(server)
            log(f"set-up: warm at {time.perf_counter() - self.t_start:.3f} s")
            await loop.drive(self, server)
        self.reduce_trace()

    def release(self) -> None:
        """Free the program's state (the engine and its KV pool) before
        the reference runs; the weights are the benchmark's and stay."""
        import gc
        self.server = None
        self.lvlm = None
        for rec in self.records:
            rec["generated"] = list(rec["req"].generated)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- results --
    def window_records(self) -> List[Dict]:
        return [r for r in self.records
                if r["due"] >= self.ws and r["due"] < self.we]

    def failed(self) -> List[Dict]:
        return [r for r in self.window_records() if r["failed"]]

    def ttft_s(self) -> List[float]:
        return [math.inf if r["failed"] else r["times"][0] - r["due"]
                for r in self.window_records()]

    def itl_s(self) -> List[float]:
        out: List[float] = []
        for r in self.window_records():
            if r["failed"]:
                out.append(math.inf)
            else:
                out.extend(np.diff(r["times"]).tolist())
        return out

    def tokens_in_window(self) -> int:
        return sum(1 for r in self.records for t in r["times"]
                   if self.ws <= t < self.we)
