"""95th percentile, ms, over every gap between consecutive output tokens
of every request sent in the window, as the client saw them; a failed
request enters once as +inf."""
from harness.stats import percentile


def read(run):
    v = percentile(run.itl_s(), 95)
    return None if v is None else v * 1e3
