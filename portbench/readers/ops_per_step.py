"""Device operations (kernels, memcpys, memsets) a training step issues,
counted in the traced stretch."""


def read(ctx, spec):
    s = ctx["stretch"]
    if not s["steps"]:
        return None
    return len(s["gpu"]) / s["steps"]
