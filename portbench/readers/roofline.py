"""A kernel's share of its roofline over the traced stretch: the least time
the stretch's work for it takes on the card (the metric file's ``work``, a
function ``module:name`` of the traced context) over the device time of
the operations whose name holds the metric file's ``kernel``. Nothing when
no such operation ran; an error when one ran and the count has no work for
it, never a share of 0."""

import importlib


def read(ctx, spec):
    kernel_us = sum(e - s for name, s, e in ctx["stretch"]["gpu"] if spec["kernel"] in name)
    if kernel_us <= 0:
        return None
    module, fn = spec["work"].split(":")
    bound_s = getattr(importlib.import_module(module), fn)(ctx)
    if bound_s <= 0:
        raise ValueError(f"{spec['kernel']} ran, but {spec['work']} counts no work for it")
    return 100.0 * bound_s / (1e-6 * kernel_us)
