"""The comparison that decides ``correct``.

Both sides hand in their readings of the first steps a run trains: the
state after the first step and after the third, as the leaves that the
configuration's family lists (``families/``) in its order, and,
where a call of the window trains more than one step, the mean loss of the
first epoch. The numbers compared, each against the cell's limit:

- ``grad``: the first step's gradient as the optimizer got it, worked out
  from the state after that step (``(p0 - p1) / lr``, SGD), by the worst
  leaf: the gap between the two sides' norms of the leaf over the larger
  of the reference's norm of that leaf and of the median leaf;
- ``change``: the same of the change of the params over the checked steps;
- ``epoch_loss``: the gap of the first epoch's mean loss over the
  reference's.

Leaves whose gradient in the reference is under a thousandth of the median
leaf's move by rounding alone and are left out of ``grad`` and ``change``.
Norms are taken in float64 of the float32 values.
"""

import statistics

import torch

# a leaf's reference gradient under this share of the median leaf's is
# rounding, not a gradient
NEGLIGIBLE = 1e-3


def _max(values):
    """The largest of ``values``; infinity where one is NaN (``max`` would
    keep or drop a NaN by its place in the list)."""
    values = list(values)
    return float("inf") if any(v != v for v in values) else max(values)


def _norms(pairs, scale=1.0):
    return [float(torch.linalg.vector_norm(b.double() - a.double()) / scale) for a, b in pairs]


def _worst_leaf(prog, ref, keep):
    mid = statistics.median(ref)
    return _max(abs(prog[i] - ref[i]) / max(ref[i], mid) for i in keep)


def compare(z0, prog, ref, lr, device):
    """The numbers compared, from the weights' leaves ``z0`` (tensors on
    ``device``, in the family's order) and each side's readings (``p1``,
    ``p3``: leaves in the same order, host or device; ``epoch_loss``: a
    float or None)."""

    def on(t):
        return torch.as_tensor(t).to(device)

    out = {}
    g_ref = _norms([(on(b), a) for a, b in zip(z0, ref["p1"])], lr)
    g_prog = _norms([(on(b), a) for a, b in zip(z0, prog["p1"])], lr)
    mid = statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= NEGLIGIBLE * mid]
    out["grad"] = _worst_leaf(g_prog, g_ref, keep)
    c_ref = _norms([(a, on(b)) for a, b in zip(z0, ref["p3"])])
    c_prog = _norms([(a, on(b)) for a, b in zip(z0, prog["p3"])])
    out["change"] = _worst_leaf(c_prog, c_ref, keep)
    if ref.get("epoch_loss") is not None:
        out["epoch_loss"] = abs(prog["epoch_loss"] - ref["epoch_loss"]) / abs(ref["epoch_loss"])
    out["leaves_compared"] = len(keep)
    return out


def judge(numbers, limits):
    """``(correct, checks)``: every number that has a limit at or under it,
    and ``{name: {"value", "limit"}}`` of those numbers."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}
    missing = [k for k in limits if k not in numbers]
    correct = not missing and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
