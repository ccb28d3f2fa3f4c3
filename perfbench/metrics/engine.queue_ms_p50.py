"""Scheduler (``core.serving.engine.Engine``): median, ms, over the
window's requests, of the tracer's wall from a request's ``Engine.submit``
(its ``request`` span begins) to its ``prefill`` begin; a request with
either missing enters as +inf."""
from harness import sites
from harness.stats import percentile


def read(run):
    if sites.recorders(run)[0] is None:
        return None
    return percentile(sites.queue_ms(run), 50)
