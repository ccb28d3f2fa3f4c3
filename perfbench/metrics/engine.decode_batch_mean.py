"""Scheduler (``core.serving.engine.Engine``): mean live rows a
``Model.decode_step`` call, over the window's calls (a count)."""


def read(run):
    rows = [len(c["q"]) for c in run.calls if c["kind"] == "decode"]
    return sum(rows) / len(rows) if rows else None
