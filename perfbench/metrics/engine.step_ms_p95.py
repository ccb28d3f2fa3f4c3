"""Scheduler (``core.serving.engine.Engine``): 95th percentile, ms, of
the wall of the program's ``engine.step`` sites that start in the window
(the profiler's host intervals: all of ``Engine.step``)."""
from harness import sites


def read(run):
    return sites.step_ms(run, 95)
