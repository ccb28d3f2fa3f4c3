"""Open loop: independent users, requests sent on a schedule.

The mix's ``rate_per_s`` sets ``round(rate * seconds)`` requests over the
window, with exponential gaps (``harness.traffic.open_schedule``). Each
request is timed from when it was due: the pump runs ``Engine.step()``
on the loop's own thread, so a long step holds the sender up, and that
wait counts. How late the sender ran is printed on standard error.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np

from harness import traffic
from harness.serve import log


async def drive(run, server) -> None:
    sched = traffic.open_schedule(run.mix, run.seed, run.seconds)
    reqs = [(s["due_s"], run.make_request(s, run.rng(i)))
            for i, s in enumerate(sched)]
    t0 = run.open_window()
    tasks = []
    for due_s, req in reqs:
        due = t0 + due_s
        wait = due - time.perf_counter()
        if wait > 0:
            await asyncio.sleep(wait)
        tasks.append(asyncio.create_task(run.consume(server, req, due)))
    await asyncio.sleep(max(0.0, t0 + run.seconds - time.perf_counter()))
    run.close_window()
    late = np.array([r["sent"] - r["due"] for r in run.records])
    if len(late):
        log(f"sender lateness s: mean {late.mean():.6f} "
            f"p95 {np.percentile(late, 95):.6f} max {late.max():.6f} "
            f"over {len(late)} requests")
    await run.drain(server, tasks)
