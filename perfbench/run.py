"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with ``--trace
1``), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared beside its limit, which also end standard error.

``--control 1`` puts the fp8 control in the program's place in the check,
which it has to fail (for setting the limits; the benchmark's own runs
never pass it). It exits non-zero and
prints no result without enough CUDA devices, when the program is
missing, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The program from ``src/``, the harness from here; every cache the
    run may write inside the checkout, at fixed paths."""
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name is one of
    ``FORBIDDEN`` as a whole word (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN))


def result(run, ok, checks, metrics, trace):
    import torch
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": int(run.cell["chips"]),
           "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": ok, "attempted": len(run.window_records()),
           "failed": len(run.failed()), "metrics": metrics, "device": dev}
    if trace and run.devtrace is not None and run.devtrace.has_device:
        dev["busy_s"] = run.devtrace.busy_s
        dev["window_s"] = run.devtrace.window_s
        out["breakdown"] = {"device_ops": run.devtrace.top_ops(),
                            "idle_gaps": run.devtrace.idle_gaps()}
    out["checks"] = checks
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, control: bool = False, data_dir: Path = BENCH,
             bench_json: Path = ROOT / "BENCHMARK.json",
             t_start: float = T_START):
    """One run; returns the result dict (the caller prints it).
    ``data_dir`` holds the cell, configuration and traffic files;
    ``bench_json`` lists the metrics each cell reports."""
    import torch
    from harness import check, spec
    from harness.serve import Run, log

    cell = spec.load_cell(workload, data_dir)
    run = Run(cell, seed, seconds, trace, device, t_start)
    run.build()
    asyncio.run(run.serve())
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated(run.device)
    else:
        run.memory_peak = 0
    run.release()
    ok, checks, extra = check.check(run, control)
    metrics = {}
    for m in spec.cell_metrics(workload, trace, bench_json):
        v = spec.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = result(run, ok, checks, metrics, trace)
    log("requests:", out["attempted"], "failed:", out["failed"],
        "setup_s:", run.setup_s, json.dumps(extra))
    # the process's CPU seconds against the window's: a busy host gives
    # less of them for the same wall, a slower CPU or card as many or more
    log("window host:", json.dumps(dict(
        window_s=run.we - run.ws, process_cpu_s=run.window_cpu_s,
        capture_s=run.capture_s, capture_calls=run.capture_calls)))
    for r in run.failed()[:5]:
        log("failed request", r["rid"], r["failed"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    from harness import spec

    cell = spec.load_cell(args.workload)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
