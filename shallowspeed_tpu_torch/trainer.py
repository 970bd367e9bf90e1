"""Sequential (single-device) trainer: the counterpart of
``shallowspeed_tpu/trainer.py``.

A training step is the reference's batch: M microbatch forwards and
hand-written backwards with gradient accumulation, then the optimizer
update. PyTorch runs eagerly, so the JAX package's ``lax.scan`` over
microbatches and over batches is a Python loop here, issuing the same ops
in the same order: the gradient sum starts from zeros and adds each
microbatch's gradient in turn (``zeros + g0 + g1 + ...``), the loss sum
starts from 0 in the same order, and the epoch's loss is ``loss_sum / nb``.
Eager ops in a fixed order make the port's own claims bitwise: an epoch
equals a loop of steps, and a chunked epoch equals a whole one.

Gradient ledger (as the reference): the loss gradient is scaled once by
the GLOBAL batch size, each Linear backward sums over its microbatch rows,
the loop sums over microbatches — no averaging anywhere.
``fuse_mubatches=True`` runs the whole batch in one forward/backward with
the softmax head's stability max taken per microbatch row group
(``head_group_rows``), which is the same training computation.

The whole-batch, whole-epoch and whole-run kernels of the JAX package
(``megakernel``/``epoch_kernel``/``run_kernel``, TPU kernels B9-B11) are not
ported yet and raise; nothing falls back to the loop.
"""

import torch

from shallowspeed_tpu_torch import ops
from shallowspeed_tpu_torch.model import (
    ModelSpec,
    model_backward,
    model_forward,
    param_tree,
)
from shallowspeed_tpu_torch.optimizer import clip_tree, global_norm, tree_leaves, tree_map

def refuse_kernel_paths(megakernel=False, epoch_kernel=False, run_kernel=False):
    """Raise when any of the fused train kernels' paths is asked for."""
    if megakernel or epoch_kernel or run_kernel:
        raise NotImplementedError(
            "the fused train kernels (pallas_ops.fused_train_call: megakernel, "
            "epoch_kernel, run_kernel; TPU kernels B9-B11) are not ported yet "
            "— ROADMAP.md §A item 2 / §B items 9-11"
        )


def _make_batch_step(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                     with_grad_norm=False):
    """The per-batch body shared by the step and the epoch:
    ``batch_step(params, opt_state, xb, yb) -> (params, opt_state, loss)``,
    plus the pre-clip global gradient norm as a fourth output under
    ``with_grad_norm``. ``xb``: (M, mubatch, in_dim), ``yb``: (M, mubatch,
    out_dim) one-hot; ``loss`` is the batch's global-batch-scaled MSE under
    the pre-update params (a 0-d tensor, left on the device)."""

    def finish(params, opt_state, grads, loss):
        gnorm = global_norm(grads) if with_grad_norm else None
        if clip_norm is not None:
            grads = clip_tree(grads, clip_norm)
        _, opt_state = opt.apply(param_tree(params), grads, opt_state)
        if with_grad_norm:
            return params, opt_state, loss, gnorm
        return params, opt_state, loss

    def batch_step(params, opt_state, xb, yb):
        if fuse_mubatches:
            rows = xb.shape[1]
            x = xb.reshape(-1, xb.shape[-1])
            y = yb.reshape(-1, yb.shape[-1])
            out, res = model_forward(params, spec, x, head_group_rows=rows)
            _, grads = model_backward(params, spec, res, y, head_group_rows=rows)
            loss = ops.mse_loss(out, y, spec.global_batch_size)
            return finish(params, opt_state, grads, loss)
        acc = tree_map(torch.zeros_like, param_tree(params))
        acc_leaves = tree_leaves(acc)
        loss = torch.zeros((), dtype=torch.float32, device=xb.device)
        for x, y in zip(xb, yb):
            out, res = model_forward(params, spec, x)
            _, grads = model_backward(params, spec, res, y)
            loss = loss + ops.mse_loss(out, y, spec.global_batch_size)
            for a, g in zip(acc_leaves, tree_leaves(grads)):
                a.add_(g)
        return finish(params, opt_state, acc, loss)

    return batch_step


def make_train_step(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                    megakernel=False):
    """``step(params, opt_state, xb, yb) -> (params, opt_state)``: one
    optimizer step over one global batch. ``params`` (the ``Stage``
    modules) and the state are updated in place and returned."""
    refuse_kernel_paths(megakernel)
    batch_step = _make_batch_step(spec, opt, fuse_mubatches, clip_norm)

    def step(params, opt_state, xb, yb):
        params, opt_state, _ = batch_step(params, opt_state, xb, yb)
        return params, opt_state

    return step


def _make_epoch_core(batch_step, with_grad_norm=False):
    """``epoch(params, opt_state, X, Y) -> (params, opt_state, mean_loss)``
    over X: (num_batches, M, mubatch, in_dim); with ``with_grad_norm`` a
    fourth output ``{"grad_norm": mean pre-clip global grad norm}``."""

    def epoch(params, opt_state, X, Y):
        loss_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        gn_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        for xb, yb in zip(X, Y):
            out = batch_step(params, opt_state, xb, yb)
            params, opt_state = out[0], out[1]
            loss_sum = loss_sum + out[2]
            if with_grad_norm:
                gn_sum = gn_sum + out[3]
        nb = X.shape[0]
        if with_grad_norm:
            return params, opt_state, loss_sum / nb, {"grad_norm": gn_sum / nb}
        return params, opt_state, loss_sum / nb

    return epoch


def make_train_epoch(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                     megakernel=False, epoch_kernel=False, with_grad_norm=False):
    """Whole epoch: ``epoch(params, opt_state, X, Y) -> (params, opt_state,
    mean_loss)``, ``mean_loss`` the mean batch training loss (``loss_sum /
    nb``, a 0-d tensor). ``with_grad_norm`` adds an aux dict
    ``{"grad_norm": mean pre-clip global gradient norm}``."""
    refuse_kernel_paths(megakernel, epoch_kernel)
    batch_step = _make_batch_step(
        spec, opt, fuse_mubatches, clip_norm, with_grad_norm
    )
    return _make_epoch_core(batch_step, with_grad_norm)


def make_train_run(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                   with_eval=True, megakernel=False, epoch_kernel=False,
                   run_kernel=False, with_grad_norm=False):
    """Whole run: ``run(params, opt_state, X, Y, vx, vy, n_epochs) ->
    (params, opt_state, losses[n_epochs], accs[n_epochs])``, each epoch
    followed by the full-split argmax accuracy (one forward over ``vx``).
    ``with_eval=False`` drops ``vx``/``vy`` and the accuracies:
    ``run(params, opt_state, X, Y, n_epochs) -> (params, opt_state,
    losses)``. ``with_grad_norm`` appends ``{"grad_norm": (n_epochs,)}``."""
    refuse_kernel_paths(megakernel, epoch_kernel, run_kernel)
    epoch = make_train_epoch(
        spec, opt, fuse_mubatches, clip_norm, with_grad_norm=with_grad_norm
    )

    def run(params, opt_state, X, Y, *rest):
        if with_eval:
            vx, vy, n_epochs = rest
        else:
            (n_epochs,) = rest
        losses, accs, gns = [], [], []
        for _ in range(n_epochs):
            out = epoch(params, opt_state, X, Y)
            params, opt_state = out[0], out[1]
            losses.append(out[2])
            if with_grad_norm:
                gns.append(out[3]["grad_norm"])
            if with_eval:
                preds, _ = model_forward(params, spec, vx)
                hits = torch.argmax(preds, dim=1) == torch.argmax(vy, dim=1)
                accs.append(torch.mean(hits.to(torch.float32)))
        outs = (params, opt_state, _stack(losses, X.device))
        if with_eval:
            outs += (_stack(accs, X.device),)
        if with_grad_norm:
            outs += ({"grad_norm": _stack(gns, X.device)},)
        return outs

    return run


def _stack(scalars, device):
    if not scalars:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.stack(scalars)


def make_predict(spec: ModelSpec):
    """Inference: softmax predictions for a (batch, in_dim) tensor. PyTorch
    runs eagerly, so there is nothing to compile; the returned function is
    the forward with its residuals dropped."""

    def predict(params, x):
        out, _ = model_forward(params, spec, x)
        return out

    return predict


def make_loss_fn(spec: ModelSpec):
    """Monitoring-only loss: the global-batch-scaled MSE of the forward."""

    def loss_fn(params, x, y):
        out, _ = model_forward(params, spec, x)
        return ops.mse_loss(out, y, spec.global_batch_size)

    return loss_fn


def accuracy(predict, params, X, Y, batch_size=1024):
    """Argmax accuracy over a full split, in ``batch_size``-row chunks (the
    ragged tail chunk at its natural size)."""
    correct = total = 0
    for i in range(0, len(X), batch_size):
        xb, yb = X[i : i + batch_size], Y[i : i + batch_size]
        preds = predict(params, xb)
        correct += int((torch.argmax(preds, dim=1) == torch.argmax(yb, dim=1)).sum())
        total += len(xb)
    return correct / max(total, 1)
