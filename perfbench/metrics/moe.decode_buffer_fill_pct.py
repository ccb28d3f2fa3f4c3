"""Model step (``models.moe.apply_moe``): the (token, choice) pairs
dispatched over the rows of the dispatch buffers, E * (C + 1) a group,
summed over the ``model.moe`` sites inside the window's ``model.decode``
sites, %."""
from harness import sites


def read(run):
    return sites.moe_decode_fill_pct(run)
