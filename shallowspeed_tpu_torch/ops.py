"""Stateless ops, forward and hand-written backward: the counterpart of
``shallowspeed_tpu/ops.py``.

Everything is fp32 with TF32 off (``resolve_device`` sets the flags): the
reference's contract is ``precision=HIGHEST``, which is IEEE fp32. The ops
keep the reference's quirks and padding rules: zero-padded rows and columns
stay exactly zero through linear/relu/gelu, and the softmax takes the
global or per-``group_rows`` stability max, adds ``1e-7`` to the
denominator, and fills masked logits with ``-1e30``.

Every backward is an explicit VJP, as in the JAX package: the training path
uses no autograd (``torch.autograd`` is a test oracle only).

``linear_relu_fused`` and ``linear_relu_grad_fused`` are the kernel switch
points, as in the JAX package: on CUDA tensors they launch the hand-written
kernels (``cuda_ops.linear_relu_fwd`` / ``linear_relu_bwd``), on CPU tensors
they run the plain versions. The last Linear, which has no relu, and the
softmax-MSE head stay plain torch ops, as the JAX package leaves them to XLA.
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


def gelu_grad(g, z):
    """VJP of gelu given the cached pre-activation z."""
    return g * gelu_grad_mult(z)


def relu_grad(g, bitmask):
    """VJP of relu given the cached bitmask (pre-activation > 0): a multiply
    by the float mask, as the reference writes it, so a NaN or Inf in ``g``
    at a masked position gives NaN instead of vanishing."""
    return g * bitmask.to(g.dtype)


def linear(x, w, b):
    """y = x @ w.T + b with w: (out, in), b: (1, out) or (out,)."""
    return torch.matmul(x, w.T) + b.reshape(1, -1)


def linear_grad_input(g, w):
    """The relay-critical half of linear's VJP: dx = g @ w."""
    return torch.matmul(g, w)


def linear_grad_weight(g, x):
    """The deferrable half of linear's VJP: (dw, db) = (g.T @ x, sum_rows(g))."""
    return torch.matmul(g.T, x), g.sum(dim=0)


def linear_grad(g, x, w):
    """VJP of linear: (dx, dw, db) = (g @ w, g.T @ x, sum_rows(g)), the
    composition of the two halves so the split and combined backward can
    never disagree."""
    dx = linear_grad_input(g, w)
    dw, db = linear_grad_weight(g, x)
    return dx, dw, db


def linear_relu_grad_input(g, bitmask, w):
    """Split B-input of the linear+relu unit: dx from W and the relu mask."""
    return linear_grad_input(relu_grad(g, bitmask), w)


def linear_relu_grad_weight(g, bitmask, x):
    """Split B-weight of the linear+relu unit: (dw, db) from the stashed
    activation and the output-grad."""
    return linear_grad_weight(relu_grad(g, bitmask), x)


def linear_relu_fused(x, w, b):
    """Fused y = relu(x @ w.T + b); returns (y, pre-activation bitmask as
    bool). The CUDA kernel on CUDA tensors, the plain version on CPU ones."""
    return cuda_ops.linear_relu_fwd(x, w, b)


def linear_relu_grad_fused(g, bitmask, x, w):
    """Backward of linear_relu_fused: (dx, dw, db) in one unit, db ``(N,)``.
    The CUDA kernel on CUDA tensors (one launch), the plain version
    (``linear_grad(relu_grad(g, bitmask), x, w)``) on CPU ones."""
    return cuda_ops.linear_relu_bwd(g, bitmask, x, w)


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


def softmax_grad(g, z, valid_mask=None, group_rows=None):
    """VJP of softmax, recomputing the forward from the cached input ``z``
    (as the reference does)."""
    out = softmax(z, valid_mask, group_rows)
    gz = out * g
    return gz - out * gz.sum(dim=-1, keepdim=True)


def mse_loss_grad(p, t, batch_size):
    """dL/dp = -2 (t - p) / batch_size."""
    return -2.0 * (t - p) / batch_size


def softmax_mse_head_grad(z, t, batch_size, valid_mask=None, group_rows=None):
    """The loss head's backward: d(MSE(softmax(z), t))/dz."""
    p = softmax(z, valid_mask, group_rows)
    g = mse_loss_grad(p, t, batch_size)
    return softmax_grad(g, z, valid_mask, group_rows)
