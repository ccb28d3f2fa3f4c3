"""Scheduler (``core.serving.engine.Engine``): median, ms, over the
window's requests, of the wall from a request's ``prefill`` end (its
first token sampled on the host) to the end of the ``engine.step`` site
that ran it, where the token leaves for its stream; a request with either
missing enters as +inf."""
from harness import sites
from harness.stats import percentile


def read(run):
    if sites.recorders(run)[0] is None:
        return None
    return percentile(sites.first_token_hold_ms(run), 50)
