"""Front end (``serving.AsyncLVLMServer``): 95th percentile, ms, of the
wall time from a request's due time to its ``Engine.submit``, over the
window's requests; one never submitted enters as +inf."""
import math

from harness.stats import percentile


def read(run):
    waits = [run.submit_t.get(r["rid"], math.inf) - r["due"]
             for r in run.window_records()]
    v = percentile(waits, 95)
    return None if v is None else v * 1e3
