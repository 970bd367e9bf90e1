"""The weight carrier between the JAX package's pytree and the port's modules.

The JAX package keeps parameters as a per-stage list of Linear dicts,
``[[{"W": (out, in), "b": (1, out)}, ...], ...]``; checkpoints and the init
produce that layout as host numpy. ``params_from_numpy`` turns it into one
``model.Stage`` module per stage on ``device``; ``params_to_numpy`` is the
inverse. Both copy the float32 values bit for bit.
"""

import numpy as np
import torch
from torch import nn

from shallowspeed_tpu_torch.model import Stage


def params_from_numpy(params_list, device):
    """Per-stage ``[{"W","b"}, ...]`` lists (numpy or array-likes) ->
    ``nn.ModuleList`` of ``Stage`` modules on ``device``."""
    stages = []
    for layers in params_list:
        weights = [
            torch.as_tensor(np.asarray(l["W"], np.float32)).to(device).contiguous()
            for l in layers
        ]
        biases = [
            torch.as_tensor(np.asarray(l["b"], np.float32).reshape(1, -1))
            .to(device)
            .contiguous()
            for l in layers
        ]
        stages.append(Stage(weights, biases))
    return nn.ModuleList(stages)


def params_to_numpy(stages):
    """``Stage`` modules -> the per-stage ``[{"W","b"}, ...]`` numpy lists."""
    return [
        [
            {
                "W": w.detach().cpu().numpy().copy(),
                "b": b.detach().cpu().numpy().reshape(1, -1).copy(),
            }
            for w, b in zip(stage.W, stage.b)
        ]
        for stage in stages
    ]
