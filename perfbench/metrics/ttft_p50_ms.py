"""Median time to first token, ms: every request sent in the window, from
when it was due (open loop) or sent (closed loop) to its first token on
the client; a failed request enters as +inf."""
from harness.stats import percentile


def read(run):
    v = percentile(run.ttft_s(), 50)
    return None if v is None else v * 1e3
