"""Stateless ops, forward half: the counterpart of ``shallowspeed_tpu/ops.py``.

Everything is fp32 with TF32 off (``resolve_device`` sets the flags): the
reference's contract is ``precision=HIGHEST``, which is IEEE fp32. The ops
keep the reference's quirks and padding rules: zero-padded rows and columns
stay exactly zero through linear/relu/gelu, and the softmax takes the
global or per-``group_rows`` stability max, adds ``1e-7`` to the
denominator, and fills masked logits with ``-1e30``.

``linear_relu_fused`` is the kernel switch point, as in the JAX package:
on CUDA tensors it launches the hand-written kernel
(``cuda_ops.linear_relu_fwd``), on CPU tensors it runs the plain version.
The last Linear, which has no relu, stays ``torch.matmul`` + bias, as the
JAX package leaves it to XLA.

The hand-written backward (VJPs) comes with the training slice.
"""

import torch

from shallowspeed_tpu_torch import cuda_ops

# Large-negative used to mask invalid logits. Not -inf: exp(-inf - -inf) would
# produce NaN when a fully-masked row meets the global max subtraction.
_NEG_MASK = -1e30

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def relu(x):
    """max(x, 0)."""
    return torch.relu(x)


def gelu(x):
    """Exact (erf) GELU: x * Phi(x); gelu(0) == 0 keeps padding zero."""
    return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))


def gelu_grad_mult(z):
    """d gelu(z)/dz = Phi(z) + z * phi(z), from the pre-activation ``z`` —
    what the gelu family caches where relu caches its bitmask."""
    phi = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) + z * phi


def linear(x, w, b):
    """y = x @ w.T + b with w: (out, in), b: (1, out) or (out,)."""
    return torch.matmul(x, w.T) + b.reshape(1, -1)


def linear_relu_fused(x, w, b):
    """Fused y = relu(x @ w.T + b); returns (y, pre-activation bitmask as
    bool). The CUDA kernel on CUDA tensors, the plain version on CPU ones."""
    return cuda_ops.linear_relu_fwd(x, w, b)


def _stability_max(z, group_rows):
    """The max subtracted for stability: over the WHOLE array (the
    reference's quirk), or over each consecutive group of ``group_rows``
    rows, reproducing what a per-microbatch loop would compute."""
    if group_rows is None:
        return torch.max(z)
    g = z.reshape(-1, group_rows, z.shape[-1])
    m = torch.amax(g, dim=(1, 2), keepdim=True)
    return m.expand(g.shape).reshape(z.shape)


def softmax(z, valid_mask=None, group_rows=None):
    """Row softmax with the reference's quirks: global (or per-group) max
    subtracted, ``+ 1e-7`` in the denominator; ``valid_mask`` (True = real
    logit) gives masked positions probability exactly 0."""
    if valid_mask is not None:
        z = torch.where(valid_mask, z, torch.full_like(z, _NEG_MASK))
    z_exp = torch.exp(z - _stability_max(z, group_rows))
    return z_exp / (z_exp.sum(dim=1, keepdim=True) + 1e-7)


def mse_loss(p, t, batch_size):
    """sum((t - p)^2) / batch_size, ``batch_size`` the GLOBAL batch size."""
    return ((t - p) ** 2).sum() / batch_size
