"""Find an open-loop cell's knee: the highest offered rate with no growing
backlog. Not part of a benchmark run; used once, when the cell's rate is
set (the rate is then written into its traffic file as a number).

    python3 perfbench/sweep.py --workload qwen2vl-hires-image --seed 11 \
        --seconds 20 --rates 6 8 10 12

For each rate, one window of the cell's traffic at that rate (a fresh
server each time, in this process): the requests due but not yet given a
first token at a quarter, half, three quarters and the end of the window
(the backlog), the TTFT median and 95th percentile, and the output rate.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench  # noqa: E402


def backlog(run, t: float) -> int:
    return sum(1 for r in run.records if r["due"] <= t
               and (not r["times"] or r["times"][0] > t))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    bench._paths()
    import torch
    from harness import spec
    from harness.serve import Run
    from harness.stats import percentile

    for rate in args.rates:
        cell = spec.load_cell(args.workload)
        cell["mix"]["rate_per_s"] = rate
        run = Run(cell, args.seed, args.seconds, False, "cuda",
                  time.perf_counter())
        run.build()
        asyncio.run(run.serve())
        ws, we = run.ws, run.we
        marks = [backlog(run, ws + f * (we - ws)) for f in (.25, .5, .75, 1)]
        ttft = run.ttft_s()
        print(json.dumps({
            "rate_per_s": rate, "requests": len(run.window_records()),
            "failed": len(run.failed()), "backlog_q1_q2_q3_end": marks,
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p95_ms": percentile(ttft, 95) * 1e3,
            "itl_p95_ms": percentile(run.itl_s(), 95) * 1e3,
            "output_tok_s": run.tokens_in_window() / (we - ws),
            "setup_s": run.setup_s,
            "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
        run.release()
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
