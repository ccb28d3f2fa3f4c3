"""EffiVLM-BENCH-style Pareto sweep harness (the OFFLINE half of
``repro_torch.control``).

Port of ``repro.control.sweep``: the same grid, quality proxy, frontier
and schema-v1 document. Its CLI writes the document only where ``--out``
says (no default file), and the fleets run on ``--device`` (the CUDA
device unless told otherwise).

Grid-runs the facade over (compression preset x decoder strategy x
replica mix x Poisson arrival rate), reusing ``LVLM.serve_cluster`` and
the same open-loop machinery ``benchmarks/bench_serving.py`` drives: one
real smoke-model fleet per grid point, per-request visual embeds,
Poisson arrivals on the virtual clock (fully deterministic, so a rerun
re-measures the same frontier).

Each point records a QUALITY PROXY next to its latency/SLO metrics:

    quality_proxy = retained_visual_ratio * acceptance

where ``retained_visual_ratio`` is the exact fraction of visual tokens
the preset keeps (``CompressionStrategy.compressed_token_count`` -- the
same accounting admission uses) and ``acceptance`` is the speculative
acceptance rate (1.0 for non-speculative decoders). That is the
training-free stand-in EffiVLM-BENCH motivates: dropped visual evidence
and rejected drafts are the two places these methods can cost quality.

The non-dominated frontier is computed in plain code over
(quality_proxy UP, slo_goodput UP, ttft_p95_s DOWN, tpot_p95_s DOWN)
into a schema-v1 pareto document; the online ``AdaptivePolicy`` ladder
is readable against it (each rung names a preset the sweep has priced).

CLI::

    PYTHONPATH=src python -m repro_torch.control.sweep --out pareto.json
    PYTHONPATH=src python -m repro_torch.control.sweep --device cpu \\
        --presets none,fastv-0.5,fastv-0.25 --decoders greedy,speculative \\
        --mixes 2x --rates 800,4000 --requests 10
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _api():
    # lazy: repro_torch.api re-exports repro_torch.control, so a
    # module-level import here would be circular
    import repro_torch.api as api
    return api

#: (metric leaf, sign): +1 = higher is better. A point is dominated iff
#: some other point is no worse on EVERY axis and strictly better on one.
FRONTIER_AXES: Tuple[Tuple[str, float], ...] = (
    ("quality_proxy", 1.0),
    ("slo_goodput", 1.0),
    ("ttft_p95_s", -1.0),
    ("tpot_p95_s", -1.0),
)

#: replica-mix name -> serve_cluster spec (int replica count or role list)
REPLICA_MIXES: Dict[str, object] = {
    "1x": 1,
    "2x": 2,
    "disagg": [{"role": "prefill"}, {"role": "decode"}],
}


@dataclasses.dataclass
class SweepConfig:
    """The grid. Defaults give 3 x 2 x 1 x 2 = 12 points (the
    reference's committed baseline grid)."""
    presets: Sequence[str] = ("none", "fastv-0.5", "fastv-0.25")
    decoders: Sequence[str] = ("greedy", "speculative")
    mixes: Sequence[str] = ("2x",)
    rates: Sequence[float] = (800.0, 4000.0)
    n_requests: int = 10
    max_new_tokens: int = 6
    seed: int = 40
    model: str = "qwen2-vl-2b"
    # tight virtual-clock SLO so attainment actually separates the grid
    # (the facade default of 500ms/50ms is trivially met on the cost
    # model's clock)
    ttft_slo_ms: float = 20.0
    tpot_slo_ms: float = 2.0


def point_key(pt: Dict) -> str:
    return (f"{pt['compression']}|{pt['decoder']}|{pt['mix']}"
            f"|r{pt['rate_rps']:g}")


def _point_requests(vlm, cfg: SweepConfig, preset: str,
                    decoder: str, rate: float, salt: int) -> List:
    api = _api()
    rng = np.random.RandomState(cfg.seed + salt)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=cfg.n_requests))
    reqs = []
    for i in range(cfg.n_requests):
        toks = list(rng.randint(1, vlm.cfg.vocab_size,
                                size=rng.randint(6, 16)))
        r = api.Request(rid=i, tokens=toks,
                        max_new_tokens=cfg.max_new_tokens,
                        arrival=float(arrivals[i]),
                        slo=api.SLO(ttft_ms=cfg.ttft_slo_ms,
                                    tpot_ms=cfg.tpot_slo_ms))
        r.visual_embeds = rng.randn(
            vlm.cfg.num_visual_tokens, vlm.cfg.d_model
        ).astype(np.float32) * 0.02
        r.compression = preset
        r.decoder = decoder
        reqs.append(r)
    return reqs


def run_point(vlm, cfg: SweepConfig, preset: str, decoder: str,
              mix: str, rate: float, salt: int = 0) -> Dict:
    """One grid point: a fresh fleet, an open-loop Poisson run, the
    quality proxy + tail-latency/SLO record."""
    api = _api()
    reqs = _point_requests(vlm, cfg, preset, decoder, rate, salt)
    router = vlm.serve_cluster(
        REPLICA_MIXES[mix],
        api.EngineConfig(max_batch=4, cache_len=256, temperature=0.0),
        gen=api.GenerationConfig(decoder="greedy", temperature=0.0,
                                 max_new_tokens=cfg.max_new_tokens,
                                 gamma=3),
        routing="least_kv",
        admission=api.AdmissionConfig(high_watermark=0.9,
                                      low_watermark=0.7))

    async def drive():
        async def consume(r):
            return [t async for t in router.submit(r)]
        async with router:
            await asyncio.gather(*(consume(r) for r in reqs))
        return router.summary()

    out = asyncio.run(drive())
    nv = vlm.cfg.num_visual_tokens
    retained = (api.make_compressor(preset).compressed_token_count(nv)
                / float(nv)) if nv else 1.0
    acceptance = 1.0
    if decoder == "speculative":
        # fleet acceptance = accepted/proposed pooled over every replica
        # that ran the speculative strategy (the cluster summary carries
        # only latency aggregates, so read the decoders directly)
        proposed = accepted = 0
        for rep in router.replicas:
            stats = rep.server.engine.decoder_stats()
            proposed += stats.get("speculative/proposed",
                                  stats.get("proposed", 0))
            accepted += stats.get("speculative/accepted",
                                  stats.get("accepted", 0))
        if proposed:
            acceptance = accepted / float(proposed)
    pt = {
        "compression": preset,
        "decoder": decoder,
        "mix": mix,
        "rate_rps": float(rate),
        "replicas": out["replicas"],
        "quality_proxy": retained * acceptance,
        "retained_visual_ratio": retained,
        "acceptance": acceptance,
        "ttft_p50_s": out.get("ttft_p50"),
        "ttft_p95_s": out.get("ttft_p95"),
        "tpot_p95_s": out.get("tpot_p95"),
        "slo_ttft_attainment": out.get("slo_ttft_attainment"),
        "slo_tpot_attainment": out.get("slo_tpot_attainment"),
        "slo_goodput": out.get("slo_goodput"),
        "throughput_tok_per_s": out.get("fleet_throughput_tok_per_s"),
        "finished": out["finished"],
        "deferred": out["deferred"],
        "virtual_time_s": out["virtual_time_s"],
    }
    return pt


# ------------------------------------------------------------- frontier --
def dominates(a: Dict, b: Dict,
              axes: Tuple[Tuple[str, float], ...] = FRONTIER_AXES) -> bool:
    """True iff ``a`` is no worse than ``b`` on every axis and strictly
    better on at least one (missing metrics count as worst)."""
    strictly = False
    for key, sign in axes:
        av = sign * float(a.get(key) if a.get(key) is not None
                          else -1e30 * sign)
        bv = sign * float(b.get(key) if b.get(key) is not None
                          else -1e30 * sign)
        if av < bv:
            return False
        if av > bv:
            strictly = True
    return strictly


def pareto_frontier(points: List[Dict]) -> List[Dict]:
    """The non-dominated subset, in input order. O(n^2) on purpose --
    the grid is tens of points and plain code beats a dependency."""
    return [p for p in points
            if not any(dominates(q, p) for q in points if q is not p)]


# ----------------------------------------------------------------- sweep --
def run_sweep(cfg: Optional[SweepConfig] = None,
              progress=None, device=None) -> Dict:
    """Run the full grid and return the schema-v1 pareto document, on
    ``device`` (the CUDA device unless given)."""
    cfg = cfg if cfg is not None else SweepConfig()
    vlm = _api().LVLM.from_pretrained(cfg.model, smoke=True, device=device)
    points: List[Dict] = []
    salt = 0
    for preset in cfg.presets:
        for decoder in cfg.decoders:
            for mix in cfg.mixes:
                for rate in cfg.rates:
                    salt += 1
                    pt = run_point(vlm, cfg, preset, decoder, mix, rate,
                                   salt=salt)
                    points.append(pt)
                    if progress is not None:
                        progress(pt)
    frontier = pareto_frontier(points)
    frontier_keys = {point_key(p) for p in frontier}
    for p in points:
        p["on_frontier"] = point_key(p) in frontier_keys
    return {
        "schema_version": 1,
        "kind": "pareto_sweep",
        "model": cfg.model,
        "axes": [list(ax) for ax in FRONTIER_AXES],
        "slo": {"ttft_ms": cfg.ttft_slo_ms, "tpot_ms": cfg.tpot_slo_ms},
        "points": points,
        "frontier": sorted(frontier_keys),
    }


def write_pareto(doc: Dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, default=float)
        f.write("\n")


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, metavar="PATH",
                    help="where to write the schema-v1 pareto document")
    ap.add_argument("--device", default=None,
                    help="torch device of the fleets (default: cuda)")
    ap.add_argument("--presets", default=None,
                    help="comma-separated compression presets")
    ap.add_argument("--decoders", default=None,
                    help="comma-separated decoder strategies")
    ap.add_argument("--mixes", default=None,
                    help=f"comma-separated replica mixes "
                         f"({','.join(REPLICA_MIXES)})")
    ap.add_argument("--rates", default=None,
                    help="comma-separated Poisson arrival rates (req/s)")
    ap.add_argument("--requests", type=int, default=None,
                    help="open-loop requests per grid point")
    ap.add_argument("--model", default=None, help="smoke model name")
    args = ap.parse_args(argv)
    cfg = SweepConfig()
    if args.presets:
        cfg.presets = tuple(p for p in args.presets.split(",") if p)
    if args.decoders:
        cfg.decoders = tuple(d for d in args.decoders.split(",") if d)
    if args.mixes:
        cfg.mixes = tuple(m for m in args.mixes.split(",") if m)
        for m in cfg.mixes:
            if m not in REPLICA_MIXES:
                ap.error(f"unknown mix {m!r} (have "
                         f"{','.join(REPLICA_MIXES)})")
    if args.rates:
        cfg.rates = tuple(float(r) for r in args.rates.split(",") if r)
    if args.requests:
        cfg.n_requests = args.requests
    if args.model:
        cfg.model = args.model

    def progress(pt):
        print(f"# pareto_point {json.dumps(pt, default=float)}",
              flush=True)

    doc = run_sweep(cfg, progress=progress, device=args.device)
    write_pareto(doc, args.out)
    n_front = sum(1 for p in doc["points"] if p["on_frontier"])
    print(f"# pareto written to {args.out}: {len(doc['points'])} points, "
          f"{n_front} on frontier", flush=True)


if __name__ == "__main__":
    main()
