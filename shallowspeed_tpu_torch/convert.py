"""The carrier between the JAX package's pytrees and the port's tensors.

The JAX package keeps parameters as a per-stage list of Linear dicts,
``[[{"W": (out, in), "b": (1, out)}, ...], ...]``; checkpoints and the init
produce that layout as host numpy. ``params_from_numpy`` turns it into one
``model.Stage`` module per stage on ``device``; ``params_to_numpy`` is the
inverse. ``opt_state_from_numpy`` / ``opt_state_to_numpy`` do the same for
the optimizer state's logical form (what checkpoints store and
``opt_state_logical()`` returns), so a JAX run's state can seed the port's.
The ``stacked_*`` functions carry the same logical forms to and from the
pipeline executor's per-slot stacked layout (the JAX package's
``E.stack_params``/``E.unstack_params``). All of them copy the float32
values bit for bit.
"""

import numpy as np
import torch
from torch import nn

from shallowspeed_tpu_torch.model import Stage, param_tree
from shallowspeed_tpu_torch.optimizer import is_stateless, join_state, split_state
from shallowspeed_tpu_torch.parallel import executor as E


def _tree_from_numpy(tree, device):
    """Per-stage ``[{"W","b"}, ...]`` numpy -> the same tree of contiguous
    float32 tensors on ``device``, ``b`` as ``(1, out)``."""

    def put(a, shape=None):
        a = np.array(a, np.float32)  # a private copy: the optimizer updates in place
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(a).to(device)

    return [
        [{"W": put(l["W"]), "b": put(l["b"], (1, -1))} for l in layers]
        for layers in tree
    ]


def _tree_to_numpy(tree):
    """A tree of tensors -> the same tree of host numpy copies."""
    return [
        [
            {
                "W": l["W"].detach().cpu().numpy().copy(),
                "b": l["b"].detach().cpu().numpy().reshape(1, -1).copy(),
            }
            for l in layers
        ]
        for layers in tree
    ]


def params_from_numpy(params_list, device):
    """Per-stage ``[{"W","b"}, ...]`` lists (numpy or array-likes) ->
    ``nn.ModuleList`` of ``Stage`` modules on ``device``."""
    return nn.ModuleList(
        Stage([l["W"] for l in layers], [l["b"] for l in layers])
        for layers in _tree_from_numpy(params_list, device)
    )


def params_to_numpy(stages):
    """``Stage`` modules -> the per-stage ``[{"W","b"}, ...]`` numpy lists."""
    return _tree_to_numpy(param_tree(stages))


def opt_state_from_numpy(opt, logical, device):
    """The logical optimizer state ``{"parts": {key: per-stage [{"W","b"}]
    numpy}, "scalars": {key: float}}`` -> ``opt``'s state on ``device``
    (params mirrors as float32 tensors, scalars as 0-d float32 tensors)."""
    if is_stateless(opt):
        return ()
    parts = {k: _tree_from_numpy(v, device) for k, v in logical["parts"].items()}
    scalars = {
        k: torch.tensor(np.float32(v), dtype=torch.float32, device=device)
        for k, v in logical["scalars"].items()
    }
    return join_state(opt, parts, scalars)


def opt_state_to_numpy(opt, state):
    """``opt``'s state -> the logical form (None for a stateless optimizer)."""
    if is_stateless(opt):
        return None
    parts, scalars = split_state(opt, state)
    return {
        "parts": {k: _tree_to_numpy(v) for k, v in parts.items()},
        "scalars": {k: float(v) for k, v in scalars.items()},
    }


# ---------------------------------------------------------------------------
# The pipeline executor's stacked layout (parallel/executor.py)
# ---------------------------------------------------------------------------


def stacked_from_numpy(params_list, spec, device):
    """Per-stage ``[{"W","b"}, ...]`` numpy -> ``(stacked, flags)``: the
    JAX package's ``E.stack_params`` layout as contiguous float32 tensors on
    ``device`` (private copies), and its flags as host numpy."""
    stacked_np, flags = E.stack_params(params_list, spec)
    return E.put_stacked(stacked_np, device), flags


def stacked_to_numpy(stacked, spec):
    """Stacked tensors -> the per-stage ``[{"W","b"}, ...]`` numpy lists
    (``E.unstack_params``)."""
    return E.unstack_params(stacked, spec)


def stacked_opt_state_from_numpy(opt, logical, spec, device):
    """The logical optimizer state (per-stage params mirrors, scalars) ->
    ``opt``'s state over the stacked tree on ``device``: each part stacked
    as the params are (``E.stack_params`` per part, as the JAX session
    does), scalars as 0-d float32 tensors."""
    if is_stateless(opt):
        return ()
    parts = {k: stacked_from_numpy(v, spec, device)[0] for k, v in logical["parts"].items()}
    scalars = {
        k: torch.tensor(np.float32(v), dtype=torch.float32, device=device)
        for k, v in logical["scalars"].items()
    }
    return join_state(opt, parts, scalars)


def stacked_opt_state_to_numpy(opt, state, spec):
    """``opt``'s stacked state -> the logical form (None when stateless)."""
    if is_stateless(opt):
        return None
    parts, scalars = split_state(opt, state)
    return {
        "parts": {k: stacked_to_numpy(v, spec) for k, v in parts.items()},
        "scalars": {k: float(v) for k, v in scalars.items()},
    }
