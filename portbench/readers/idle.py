"""The share of the measured window in which the device was idle: one less
the device's busy time a step, from the traced stretch (the union of its
kernels, memcpys and memsets), over the window's wall a step, timed with no
profiler running. So the profiler's cost to the host, which lengthens the
traced stretch's gaps, is not counted."""


def read(ctx, spec):
    s, w = ctx["stretch"], ctx["window"]
    if not s["steps"] or not w["steps"]:
        return None
    return 100.0 * (1.0 - (s["busy_s"] / s["steps"]) / (w["seconds"] / w["steps"]))
