"""Kernel ``kernels.paged_attention``: the least time the live rows of the
traced stretch's decode steps need (each row's keys and values read
once) over the device time of the paged kernels (``paged_*``), %."""
from harness.work import paged_work, roofline_pct


def read(run):
    return roofline_pct(run, "paged_", True, paged_work)
