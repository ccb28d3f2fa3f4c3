"""Serving CLI: the taxonomy engine end-to-end on synthetic requests,
through the unified ``repro_torch.api`` facade.

Port of ``repro.launch.serve``: the same flags and the same JSON report,
plus ``--device`` (the CUDA device unless told otherwise). ``--arch``
offers the configs the port has. ``--smoke`` is always on, as in the
reference (``store_true`` with ``default=True``). ``--dry-run`` traces
decode_32k under the production mesh: it runs ``python -m
repro_torch.launch.dryrun --arch A --shape decode_32k`` in a subprocess
and returns its exit code.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \
        --requests 16 --scheduler chunked --compression divprune-0.5

    # per-request compression mixing (one engine, two strategies; the
    # report includes per-strategy prefill token reduction):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --compression none,framefusion-0.25

    # decoder strategies (all batched; speculative slots share each
    # jitted draft/verify round):
    PYTHONPATH=src python -m repro_torch.launch.serve --decoder speculative

    # open-loop async serving: Poisson arrivals at --open-loop req/s
    # (virtual clock) through AsyncLVLMServer, with KV-watermark admission
    # control; the JSON report adds queue-wait and admission counters:
    PYTHONPATH=src python -m repro_torch.launch.serve --open-loop 2000

    # multi-engine routing: N async server replicas behind one Router
    # (--routing round_robin | least_kv | prefix_affinity), SLO-slack
    # deferred queues, optional wall-clock pacing; the report is the
    # fleet-wide ClusterMetrics summary:
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
        --routing prefix_affinity --prefix-cache --shared-prefix 32 \
        --open-loop 2000 --admission-order slack

    # disaggregated prefill/decode fleet: prefill replicas run the
    # vision encoder + chunked prefill, hand post-compression KV to
    # decode replicas over the modeled KV link (--roles implies the
    # replica count; the report adds a "disaggregation" block):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --roles prefill:2,decode:2 --open-loop 2000
"""
from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np

from repro_torch.api import (AdmissionConfig, EngineConfig, GenerationConfig,
                             LVLM, Request, ROUTING_POLICIES,
                             resolve_compression)
from repro_torch.configs import ARCHS
from repro_torch.launch.dryrun import delegate as dry_run


def synth_requests(cfg, n, *, seed=0, prompt_lo=16, prompt_hi=48,
                   new_tokens=16, shared_prefix=0):
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(1, cfg.vocab_size,
                              size=shared_prefix)) if shared_prefix else []
    reqs = []
    for i in range(n):
        toks = shared + list(rng.randint(
            1, cfg.vocab_size, size=rng.randint(prompt_lo, prompt_hi)))
        ve = None
        if cfg.family == "vlm":
            ve = rng.randn(cfg.num_visual_tokens, cfg.d_model).astype(
                np.float32) * 0.02
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=new_tokens,
                            visual_embeds=ve, arrival=i * 0.01))
    return reqs


def parse_roles(spec):
    """``'prefill:2,decode:2'`` (or a bare list ``'prefill,decode'``)
    into the per-replica role list ``serve_cluster`` expects."""
    roles = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        roles.extend([name.strip()] * (int(count) if count else 1))
    return roles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--scheduler", default="continuous",
                    choices=("static", "continuous", "mlfq", "chunked"))
    ap.add_argument("--decoder", default="sampling",
                    choices=("greedy", "sampling", "speculative",
                             "early_exit"))
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--compression", default="none",
                    help="preset name, e.g. none|fastv-0.5|divprune-0.5|"
                         "streaming-kv; parametric: <pruner>-<keep> or "
                         "<streaming|l2>-kv-<budget>. A comma list "
                         "(e.g. 'none,fastv-0.5') assigns strategies "
                         "PER-REQUEST round-robin -- one engine serves "
                         "the mixed-compression workload")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative draft length")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--open-loop", type=float, default=0.0, metavar="RATE",
                    help="serve via the async server with Poisson arrivals "
                         "at RATE req/s (virtual clock); 0 = closed loop")
    ap.add_argument("--high-watermark", type=float, default=0.9,
                    help="admission high KV watermark (fraction of pool)")
    ap.add_argument("--low-watermark", type=float, default=0.7,
                    help="admission low (drain) KV watermark")
    ap.add_argument("--admission-order", default="fifo",
                    choices=("fifo", "slack"),
                    help="deferred-queue order: FIFO or SLO-slack "
                         "(earliest TTFT deadline first)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="async server replicas behind a cluster Router "
                         "(>1 forces the async path)")
    ap.add_argument("--roles", default=None, metavar="SPEC",
                    help="disaggregated fleet roles, e.g. "
                         "'prefill:2,decode:2' or 'prefill,decode' "
                         "(implies the replica count and the async "
                         "cluster path; prefill replicas hand "
                         "post-compression KV to decode replicas)")
    ap.add_argument("--routing", default="round_robin",
                    choices=sorted(ROUTING_POLICIES),
                    help="cluster routing policy (with --replicas > 1)")
    ap.add_argument("--pacing", default="virtual",
                    choices=("virtual", "wall"),
                    help="'wall' sleeps each step's virtual duration in "
                         "real time; 'virtual' is deterministic")
    ap.add_argument("--pacing-scale", type=float, default=1.0,
                    help="wall-pacing multiplier on the virtual duration")
    ap.add_argument("--disconnect-timeout", type=float, default=None,
                    metavar="S", help="abort streams whose consumer "
                    "stopped reading for S wall seconds")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable repro_torch.obs tracing and profiling and "
                         "write the run as Chrome-trace/Perfetto JSON, the "
                         "profiler's host sites on a wall-clock track in "
                         "epoch microseconds (open in ui.perfetto.dev; "
                         "validate with python -m repro_torch.obs.validate)")
    ap.add_argument("--trace-events", default=None, metavar="PATH",
                    help="enable tracing and stream raw events as JSONL "
                         "(input for scripts/trace_report.py)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text-format metrics snapshot "
                         "after the run ('-' = stdout); requires the async "
                         "path (--open-loop or --replicas > 1)")
    ap.add_argument("--control", action="store_true",
                    help="enable the SLO-adaptive quality controller "
                         "(repro_torch.control): under KV pressure, degrade "
                         "deferred requests to aggressive compression "
                         "presets instead of queueing them")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace decode_32k under the production mesh "
                         "(python -m repro_torch.launch.dryrun)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    if args.dry_run:
        return dry_run(args.arch, "decode_32k")

    lvlm = LVLM.from_pretrained(args.arch, smoke=True, device=args.device)
    # comma list = per-request mixing: the FIRST preset is the engine
    # default, the rest resolve per-request against the same registry
    # (compression is configured via the facade, never by mutating
    # EngineConfig.compression -- see the repo layering rule)
    presets = [p for p in str(args.compression).split(",") if p]
    for p in presets:
        resolve_compression(p)             # fail fast on bad names
    ec = EngineConfig(
        max_batch=args.max_batch, cache_len=args.cache_len,
        scheduler=args.scheduler, temperature=args.temperature,
        prefix_cache=args.prefix_cache)
    gen = GenerationConfig(
        decoder=args.decoder, temperature=args.temperature,
        max_new_tokens=args.new_tokens, gamma=args.gamma,
        compression=presets[0] if presets else "none")
    reqs = synth_requests(lvlm.cfg, args.requests,
                          new_tokens=args.new_tokens,
                          shared_prefix=args.shared_prefix)
    if len(presets) > 1:
        for i, r in enumerate(reqs):
            r.compression = presets[i % len(presets)]
    if args.open_loop > 0:
        rng = np.random.RandomState(0)
        arrivals = np.cumsum(rng.exponential(1.0 / args.open_loop,
                                             size=len(reqs)))
        for r, t in zip(reqs, arrivals):
            r.arrival = float(t)
    adm = AdmissionConfig(high_watermark=args.high_watermark,
                          low_watermark=args.low_watermark,
                          order=args.admission_order)
    roles = parse_roles(args.roles) if args.roles else None
    if roles:
        args.replicas = len(roles)
    tracer = profiler = None
    if args.trace_out or args.trace_events:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    if args.trace_out:
        from repro_torch.obs import Profiler
        profiler = Profiler()
    if args.open_loop > 0 or args.replicas > 1:
        front = lvlm.serve_cluster(
            args.replicas, ec, gen=gen, routing=args.routing,
            roles=roles, admission=adm, pacing=args.pacing,
            pacing_scale=args.pacing_scale,
            disconnect_timeout_s=args.disconnect_timeout,
            obs=tracer, profile=profiler, control=args.control) \
            if args.replicas > 1 else lvlm.serve_async(
                ec, gen=gen, admission=adm, pacing=args.pacing,
                pacing_scale=args.pacing_scale,
                disconnect_timeout_s=args.disconnect_timeout,
                obs=tracer, profile=profiler, control=args.control)

        async def drive():
            async with front:
                await asyncio.gather(
                    *(_consume(front.submit(r)) for r in reqs))
            return front.summary()

        stats = asyncio.run(drive())
        if args.metrics_out:
            text = front.metrics_snapshot()
            if args.metrics_out == "-":
                print(text, end="")
            else:
                with open(args.metrics_out, "w", encoding="utf-8") as f:
                    f.write(text)
    else:
        if args.metrics_out:
            ap.error("--metrics-out requires the async path "
                     "(--open-loop or --replicas > 1)")
        stats = lvlm.serve(reqs, engine_cfg=ec, gen=gen, obs=tracer,
                           profile=profiler, control=args.control).stats
    if tracer is not None:
        if args.trace_out:
            from repro_torch.obs import write_chrome_trace
            write_chrome_trace(tracer.events, args.trace_out,
                               sites=profiler.intervals())
        if args.trace_events:
            tracer.write_jsonl(args.trace_events)
    print(json.dumps({k: v for k, v in stats.items()
                      if not isinstance(v, (list, dict))}, indent=1,
                     default=float))
    return 0


async def _consume(stream):
    return [tok async for tok in stream]


if __name__ == "__main__":
    raise SystemExit(main())
