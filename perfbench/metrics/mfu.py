"""Model step (``models.transformer.Model``): the model's FLOPs (as
published: top-k routed + shared experts) of every call in the window
over the summed wall time of those calls, each timed until the device
finished it, as a share of the bf16 peak, %."""
from harness.work import mfu_pct


def read(run):
    return mfu_pct(run.cfg, run.calls)
