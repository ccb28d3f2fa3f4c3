"""Process start to the window's opening: imports, weights drawn on the
device, kernels built or loaded, warm-up (and a closed loop's ramp)."""


def read(run):
    return run.setup_s
