"""Roofline models of the port: the card's constants (``hw``), the
analytic FLOPs / bytes per (config x shape) (``analytic``), what one step
costs -- FLOPs, collectives, per-device bytes -- measured by running it
on ``meta`` stand-ins (``step_cost``, in place of the reference's
``hlo_cost``, which walks XLA's HLO), and the three-term roofline over
those costs (``analysis``: ``roofline_from_costs``, ``RooflineReport``,
``collective_bytes``, ``model_flops_estimate``)."""
from repro_torch.roofline.analysis import (RooflineReport, collective_bytes,
                                           model_flops_estimate,
                                           roofline_from_costs)
from repro_torch.roofline.hw import H100_SXM, HW

__all__ = ["HW", "H100_SXM", "RooflineReport", "collective_bytes",
           "model_flops_estimate", "roofline_from_costs"]
