"""95th percentile of the time to first token, ms, over every request
sent in the window (failed requests enter as +inf)."""
from harness.stats import percentile


def read(run):
    v = percentile(run.ttft_s(), 95)
    return None if v is None else v * 1e3
