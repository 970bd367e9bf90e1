"""ShallowSpeed's MLP training step in plain PyTorch, float32, TF32 off.

The model: Linears ``y = x @ W.T + b``, a relu after every Linear but the
last, and the softmax-MSE head with the reference's quirks: the stability
max is taken over each microbatch's whole ``(rows, classes)`` block, the
denominator adds ``1e-7``, and the loss is ``sum((t - p)^2)`` divided by
the GLOBAL batch size, so that the microbatches' gradients add up to the
batch's. One SGD step is ``p <- p - lr * g``. Gradients come from
autograd, with the stability max held constant as the reference's
hand-written backward holds it.

It imports nothing of the port and takes nothing the port made: the
benchmark hands it the seed's weights and split.
"""

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32):
    """Float32 products in IEEE fp32 (``tf32=False``) or in TF32 (the
    control), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def batch_loss(params, x, y, mubatches, batch_size):
    """The batch's loss: the sum over its ``mubatches`` microbatches (rows in
    order) of each one's softmax-MSE, scaled by ``batch_size``."""
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w.T + b
        if i < len(params) - 1:
            h = torch.relu(h)
    z = h.reshape(mubatches, -1, h.shape[-1])
    m = torch.amax(z, dim=(1, 2), keepdim=True).detach()
    e = torch.exp(z - m)
    p = e / (e.sum(dim=-1, keepdim=True) + 1e-7)
    return ((y.reshape(p.shape) - p) ** 2).sum() / batch_size


class Trainer:
    """The reference's training state: ``params`` a list of ``(W, b)``,
    copied from the weights it is given."""

    def __init__(self, weights, lr, batch_size, mubatches):
        self.params = [(w.clone(), b.clone()) for w, b in weights]
        self.lr, self.B, self.M = lr, batch_size, mubatches

    def leaves(self):
        """``W0, b0, W1, b1, ...``: the tensors of ``params`` in order."""
        return [t for wb in self.params for t in wb]

    def step(self, x, y):
        """One SGD step on the batch ``(x, y)``; returns its loss under the
        params before the update."""
        leaves = [t.requires_grad_(True) for t in self.leaves()]
        loss = batch_loss(self.params, x, y, self.M, self.B)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.requires_grad_(False)
                t.sub_(self.lr * g)
        return float(loss.detach())
