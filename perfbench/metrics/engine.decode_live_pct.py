"""Scheduler (``core.serving.engine.Engine``): the live rows the decoder
was given over the rows the fixed-shape decode step ran (``max_batch``),
summed over the window's ``model.decode`` sites, %."""
from harness import sites


def read(run):
    return sites.decode_live_pct(run)
