"""The traced run's wrappers: the benchmark's own spans around the calls
into the model and the engine, and the profiler window.

``install(run, engine)`` replaces, on these instances only,
``Model.prefill / extend / decode_step`` (each call synchronised before
and after and timed on the host's clock, so its wall time ends when the
device finished it; its shapes recorded as ``harness.work`` counts
them), ``Engine.step`` (host interval of every step; the profiler starts
and stops between two steps) and ``Engine.submit`` (when a request
entered the engine). The untimed runs install the ``submit`` hook, which
reads the clock and nothing else, and, in a cell whose check compares
logits, ``capture_logits``, which copies a few rows on the device. While the profiler runs, each
step and model call is also kept as a host span (``run.spans``, on the
host's nanosecond clock) for ``harness.devtrace``.

A decode step runs every slot of the pool; a slot is live when its
position is not the pool's scratch row (the last one), and only live
rows are counted.
"""
from __future__ import annotations

import time

import torch


def _cache_len(cache) -> int:
    while isinstance(cache, dict):
        cache = next(iter(cache.values()))
    return int(cache.shape[2])


def hook_submit(run, engine) -> None:
    orig = engine.submit

    def submit(req):
        run.submit_t[req.rid] = time.perf_counter()
        return orig(req)
    engine.submit = submit


def capture_logits(run, engine, rows: int) -> None:
    """Keep the logits the timed path computes for every request's first
    ``rows`` tokens (``run.logits[(rid, j)]``: the row that chose served
    token ``j``), for the check. No synchronisation and no copy from the
    host: each kept row is sliced out and copied on the device, in the
    model's bf16 (the logits are bf16 products), one small copy a row.
    The host time the wrappers add inside the window is summed in
    ``run.capture_s``, over ``run.capture_calls`` model calls.

    A prefill's row belongs to the request the engine is prefilling (its
    slot is taken and nothing of it is done yet); a decode step's rows to
    the slots whose requests are decoding, keyed by the tokens each has.
    A slot prefilled in the same step is decoded by that step only on the
    scratch row; its real row comes at the next step under the same key,
    and the later copy wins."""
    model = engine.model
    prefill, decode = model.prefill, model.decode_step

    def spent(t0):
        if run.in_window(t0):
            run.capture_s += time.perf_counter() - t0
            run.capture_calls += 1

    def prefill_kept(*a, **kw):
        logits, cache = prefill(*a, **kw)
        t0 = time.perf_counter()
        cur = [r for r in engine.slot_req
               if r is not None and r.prefill_done == 0]
        if len(cur) == 1 and rows > 0:
            run.logits[(cur[0].rid, 0)] = logits[0, -1].to(
                torch.bfloat16, copy=True)
        spent(t0)
        return logits, cache

    def decode_kept(*a, **kw):
        logits, cache = decode(*a, **kw)
        t0 = time.perf_counter()
        for s, r in enumerate(engine.slot_req):
            if r is not None and len(r.generated) < rows \
                    and r.state.name == "DECODE":
                run.logits[(r.rid, len(r.generated))] = logits[s].to(
                    torch.bfloat16, copy=True)
        spent(t0)
        return logits, cache

    model.prefill = prefill_kept
    model.decode_step = decode_kept


def install(run, engine) -> None:
    """Wrap the model calls and engine steps of ``engine`` for ``run``
    (a ``harness.serve.Run``: ``calls``, ``spans``, ``before_step``)."""
    model = engine.model
    sync = torch.cuda.synchronize if engine.device.type == "cuda" \
        else (lambda: None)

    def timed(kind, fn, shape_of):
        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter_ns()
            out = fn(*a, **kw)
            sync()
            t1 = time.perf_counter_ns()
            if run.profiling:
                run.spans.append((kind, t0, t1))
            t0, t1 = t0 * 1e-9, t1 * 1e-9
            if run.in_window(t0):
                rec = shape_of(*a, **kw)
                rec.update(kind=kind, wall_s=t1 - t0,
                           profiled=run.profiling)
                run.calls.append(rec)
            return out
        return wrapper

    def prefill_shape(params, batch, **kw):
        s = int(batch["tokens"].shape[1])
        nv = 0
        if "visual_embeds" in batch:
            nv = int(batch["visual_embeds"].shape[1])
        b = int(batch["tokens"].shape[0])
        return {"q": [s + nv] * b, "ctx": [s + nv] * b, "nv": nv * b,
                "unembed": b if kw.get("last_only") else b * (s + nv)}

    def extend_shape(params, cache, tokens, start, **kw):
        b, s = tokens.shape
        st = torch.as_tensor(start).reshape(-1).tolist()
        st = st * b if len(st) == 1 else st
        return {"q": [int(s)] * b, "ctx": [int(x) + int(s) for x in st],
                "unembed": b * s}

    def decode_shape(params, cache, tokens, pos, **kw):
        scratch = _cache_len(cache) - 1
        p = torch.as_tensor(pos).reshape(-1).tolist()
        live = [int(x) + 1 for x in p if int(x) != scratch]
        return {"q": [1] * len(live), "ctx": live, "unembed": len(live),
                "batch": len(p)}

    model.prefill = timed("prefill", model.prefill, prefill_shape)
    model.extend = timed("extend", model.extend, extend_shape)
    model.decode_step = timed("decode", model.decode_step, decode_shape)

    orig_step = engine.step

    def step():
        run.before_step()
        t0 = time.perf_counter_ns()
        out = orig_step()
        if run.profiling:
            run.spans.append(("engine_step", t0, time.perf_counter_ns()))
        return out
    engine.step = step

