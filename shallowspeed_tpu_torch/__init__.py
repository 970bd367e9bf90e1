"""shallowspeed_tpu_torch: the PyTorch/CUDA port of shallowspeed_tpu for an
NVIDIA H100.

The JAX package ``shallowspeed_tpu`` is the reference; this package mirrors
its module names (``init``, ``model``, ``ops``, ``cuda_ops`` for
``pallas_ops``, ``checkpoint``, ``trainer``, ``api``, ``serving``) and is
held to its outputs by ``tests/test_torch_*.py``. It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``shallowspeed_tpu``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; ``resolve_device`` is the one place that rule lives.
"""

import torch


def resolve_device(device=None):
    """``device`` (None = ``"cuda"``) as a ``torch.device``. Raises when a
    CUDA device is asked for and none is present — never falls back to the
    CPU. Turns TF32 off for matmuls and cuDNN: the reference computes in
    IEEE fp32 (``precision=HIGHEST``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


# public names (after resolve_device, which the modules below import)
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES, TrainingSession  # noqa: E402
from shallowspeed_tpu_torch.init import linear_init  # noqa: E402
from shallowspeed_tpu_torch.model import (  # noqa: E402
    MODEL_ZOO,
    init_model,
    make_model_spec,
    model_forward,
    resolve_model,
)

__all__ = [
    "FLAGSHIP_SIZES",
    "MODEL_ZOO",
    "TrainingSession",
    "init_model",
    "linear_init",
    "make_model_spec",
    "model_forward",
    "resolve_device",
    "resolve_model",
]
