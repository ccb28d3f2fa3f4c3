"""Device (H100): share of the time inside the traced stretch's
``Engine.step`` calls with no operation running on the device, %."""


def read(run):
    t = run.devtrace
    v = None if t is None else t.idle_share_in_steps()
    return None if v is None else 100.0 * v
