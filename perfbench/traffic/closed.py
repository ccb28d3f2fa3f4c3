"""Closed loop: ``clients`` callers, each sending its next request as soon
as the last one has finished (no think time).

Each client's ``n``-th request takes its size from round ``n`` of
stratified sizes (``Run.next_size``). The clients start ``ramp_s``
seconds before the window opens, each first request cut to a share of
its output (the ``c``-th of ``clients`` evenly spaced shares, in an
order drawn from the seed), so that the clients are spread over their
requests' lives as in steady state when the window opens. At the
window's close the clients stop sending; what they sent is drained.
"""
from __future__ import annotations

import asyncio
import math


async def drive(run, server) -> None:
    clients = int(run.mix["clients"])
    share = (run.rng(1 << 31).permutation(clients) + 0.5) / clients

    async def client(c: int) -> None:
        n = 0
        while not run.closed:
            size = run.next_size(c, n)
            if n == 0:
                size["output"] = max(1, math.ceil(size["output"] * share[c]))
            await run.consume(
                server, run.make_request(size, run.rng(c, n)), None)
            n += 1

    tasks = [asyncio.create_task(client(c)) for c in range(clients)]
    await asyncio.sleep(float(run.mix.get("ramp_s", 0.0)))
    run.open_window()
    await asyncio.sleep(run.seconds)
    run.close_window()
    await run.drain(server, tasks)
