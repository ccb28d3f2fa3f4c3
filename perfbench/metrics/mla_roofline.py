"""Kernel ``kernels.mla_attention``: the least time the live rows of the
traced stretch's decode steps need (each row's latent rows read once)
over the device time of the latent kernels (``mla_*``), %."""
from harness.work import mla_work, roofline_pct


def read(run):
    return roofline_pct(run, "mla_", True, mla_work)
