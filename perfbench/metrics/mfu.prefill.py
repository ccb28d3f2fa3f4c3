"""Model step, prompt calls only (``Model.prefill`` / ``extend``): their
FLOPs over their summed wall time as a share of the bf16 peak, %."""
from harness.work import mfu_pct


def read(run):
    return mfu_pct(run.cfg, [c for c in run.calls if c["kind"] != "decode"])
