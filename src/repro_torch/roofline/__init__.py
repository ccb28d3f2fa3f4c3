"""Roofline models of the port: the card's constants (``hw``) and the
analytic FLOPs / bytes per (config x shape) (``analytic``)."""
