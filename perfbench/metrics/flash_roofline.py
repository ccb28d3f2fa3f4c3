"""Kernel ``kernels.flash_attention``: the least time the work of the
traced stretch's prompt calls needs on the card (bytes at 3.35 TB/s or
FLOPs at 989 TFLOP/s, the larger) over the device time of the forward
kernels (``flash_fwd*``) in that stretch, %."""
from harness.work import flash_work, roofline_pct


def read(run):
    return roofline_pct(run, "flash_fwd", False, flash_work)
