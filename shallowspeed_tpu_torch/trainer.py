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

The kernel paths (``fuse_mubatches`` only; SGD, momentum or Adam; relu
family; one stage; within the JAX package's budget) run the fused train
kernel ``cuda_ops.fused_train_call`` (TPU kernels B9-B11):
``megakernel=True`` one launch per batch, ``epoch_kernel=True`` one per
epoch, ``make_train_run(run_kernel=True, with_eval=False)`` one per run.
On the CPU the same calls run the kernel's plain version, which composes
the fused path's own torch ops, so there the kernel paths give the fused
path's bits. Nothing falls back from a kernel path to the loop.
"""

import torch

from shallowspeed_tpu_torch import cuda_ops, ops
from shallowspeed_tpu_torch.model import (
    ModelSpec,
    model_backward,
    model_forward,
    param_tree,
)
from shallowspeed_tpu_torch.optimizer import (
    SGD,
    Adam,
    MomentumSGD,
    clip_tree,
    global_norm,
    tree_leaves,
    tree_map,
)

_NO_STEP_AUX = (
    "with_grad_norm/with_step_stats/with_digests are unavailable on the "
    "kernel paths: the gradient never leaves the fused train kernel"
)

# the digest aux's vectors, in the JAX package's key order
DIGEST_KEYS = ("crc_w", "crc_b", "pnorm_w", "pnorm_b", "gnorm_w", "gnorm_b")


def block_crc(a):
    """The digest checksum of a float32 tensor: the uint32 wrap-around sum
    of its float32 words, as a 0-d int64 tensor on the tensor's device
    (``utils.block_checksum``'s number). torch has no uint32 sum, so the
    words are read as int32 and summed in int64: the signed and unsigned
    sums differ by a multiple of 2**32, which the final mask removes."""
    return torch.sum(a.contiguous().view(torch.int32), dtype=torch.int64) & 0xFFFFFFFF


def row_crcs(a):
    """``block_crc`` of each row ``a[r]`` of a stacked tensor: ``(S,)``."""
    return (
        torch.sum(a.contiguous().view(torch.int32).reshape(a.shape[0], -1), dim=1,
                  dtype=torch.int64)
        & 0xFFFFFFFF
    )


def _digest_aux(params, grads):
    """The sequential per-layer digest vectors (``trainer._digest_aux``):
    for every logical (W, b) block in global layer order, the checksum of
    the POST-update float32 bits (``block_crc``), the post-update L2 norm
    and the PRE-clip gradient L2 norm — each a ``(n_layers,)`` tensor left
    on the device (int64 checksums, float32 norms)."""
    cols = {k: [] for k in DIGEST_KEYS}
    for stage_p, stage_g in zip(param_tree(params), grads):
        for lay_p, lay_g in zip(stage_p, stage_g):
            for key, sfx in (("W", "w"), ("b", "b")):
                p, g = lay_p[key], lay_g[key]
                cols[f"crc_{sfx}"].append(block_crc(p))
                cols[f"pnorm_{sfx}"].append(torch.sqrt(torch.sum(p * p)))
                cols[f"gnorm_{sfx}"].append(torch.sqrt(torch.sum(g * g)))
    return {k: torch.stack(v) for k, v in cols.items()}


def _kernel_opt_descriptor(opt):
    """The fused train kernel's optimizer descriptor for ``opt``
    (``cuda_ops.fused_train_call``'s ``opt``), or None when the kernel has
    no such update. Its kind keys ``cuda_ops._OPT_GEOMETRY``."""
    if type(opt) is SGD:
        return {"kind": "sgd"}
    if type(opt) is MomentumSGD:
        return {"kind": "momentum", "mu": opt.momentum}
    if type(opt) is Adam:
        return {"kind": "adam", "b1": opt.b1, "b2": opt.b2, "eps": opt.eps}
    return None


def _validate_megakernel(spec, opt, fuse_mubatches, name="megakernel"):
    """The kernel paths' refusals, in the JAX package's order and words:
    fused microbatches, the relu family, a kernel-supported optimizer (SGD,
    momentum, Adam), a single stage, and the JAX package's budget for the
    variant (the epoch and run kernels also count a second copy of the
    streamed batch). Returns the single stage's spec."""
    if not fuse_mubatches:
        raise ValueError(f"{name} requires fuse_mubatches=True")
    if getattr(spec, "act", "relu") != "relu":
        raise ValueError(
            f"{name} supports the relu activation family only "
            f"(model act={spec.act!r})"
        )
    desc = _kernel_opt_descriptor(opt)
    if desc is None:
        raise ValueError(
            f"{name} supports the (decaying) SGD, momentum and adam "
            f"optimizers only"
        )
    if spec.n_stages != 1 or not spec.stages[0].has_head:
        raise ValueError(f"{name} runs the single-stage sequential path only")
    sspec = spec.stages[0]
    fits = (
        cuda_ops.train_epoch_kernel_fits
        if name in ("epoch_kernel", "run_kernel")
        else cuda_ops.train_step_kernel_fits
    )
    n_mirrors, _ = cuda_ops._OPT_GEOMETRY[desc["kind"]]
    if not fits(spec.global_batch_size, sspec.local_sizes, state_mirrors=n_mirrors):
        raise ValueError(f"model + batch exceed the {name} VMEM budget")
    return sspec


def _fused_kernel_call(spec, sspec, opt, params, opt_state, X, Y, *, clip_norm,
                       n_epochs=None):
    """The one bridge from the trainer to ``cuda_ops.fused_train_call``.
    ``X``/``Y``: one batch ``(M, mubatch, dim)`` (step mode) or an epoch's
    ``(nb, M, mubatch, dim)`` (epoch mode; with ``n_epochs`` the run), each
    batch fused into ``M * mubatch`` rows whose head groups are the
    microbatches. Maps the optimizer state onto the kernel's mirror groups
    and scalar slots — momentum's params mirror rides as one group, Adam's
    ``m`` and ``v`` as two and its ``t`` as the scalar slot. The kernel
    updates params and state in place; returns ``(params, opt_state,
    loss)``."""
    mb = X.shape[-2]
    x = X.reshape(*X.shape[:-3], -1, X.shape[-1])
    y = Y.reshape(*Y.shape[:-3], -1, Y.shape[-1])
    desc = _kernel_opt_descriptor(opt)
    kind = desc["kind"]
    if kind == "momentum":
        mirrors, scalars = (opt_state[0],), ()
    elif kind == "adam":
        mirrors, scalars = (opt_state["m"][0], opt_state["v"][0]), (opt_state["t"],)
    else:
        mirrors, scalars = (), ()
    _, _, _, loss = cuda_ops.fused_train_call(
        param_tree(params)[0], x, y,
        epoch_mode=X.dim() == 4,
        relu_flags=sspec.relu_flags,
        group_rows=mb,
        batch_size=spec.global_batch_size,
        lr=opt.lr,
        weight_decay=opt.weight_decay,
        opt=desc, mirrors=mirrors, scalars=scalars, clip_norm=clip_norm,
        n_epochs=n_epochs,
    )
    return params, opt_state, loss


def _make_batch_step(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                     with_grad_norm=False, megakernel=False, with_digests=False):
    """The per-batch body shared by the step and the epoch:
    ``batch_step(params, opt_state, xb, yb) -> (params, opt_state, loss)``,
    plus the pre-clip global gradient norm as a fourth output under
    ``with_grad_norm`` and the ``_digest_aux`` dict of the new params as
    the last output under ``with_digests``. ``xb``: (M, mubatch, in_dim),
    ``yb``: (M, mubatch, out_dim) one-hot; ``loss`` is the batch's
    global-batch-scaled MSE under the pre-update params (a 0-d tensor, left
    on the device). ``megakernel=True`` runs the whole batch as one launch
    of the fused train kernel."""
    if megakernel:
        if with_grad_norm or with_digests:
            raise ValueError(_NO_STEP_AUX)
        sspec = _validate_megakernel(spec, opt, fuse_mubatches)

        def mega_step(params, opt_state, xb, yb):
            return _fused_kernel_call(
                spec, sspec, opt, params, opt_state, xb, yb, clip_norm=clip_norm
            )

        return mega_step

    def finish(params, opt_state, grads, loss):
        gnorm = global_norm(grads) if with_grad_norm else None
        raw = grads
        if clip_norm is not None:
            grads = clip_tree(grads, clip_norm)
        _, opt_state = opt.apply(param_tree(params), grads, opt_state)
        outs = (params, opt_state, loss)
        if with_grad_norm:
            outs += (gnorm,)
        if with_digests:
            outs += (_digest_aux(params, raw),)
        return outs

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
    batch_step = _make_batch_step(
        spec, opt, fuse_mubatches, clip_norm, megakernel=megakernel
    )

    def step(params, opt_state, xb, yb):
        params, opt_state, _ = batch_step(params, opt_state, xb, yb)
        return params, opt_state

    return step


def _make_epoch_core(batch_step, with_grad_norm=False, with_step_stats=False,
                     with_digests=False):
    """``epoch(params, opt_state, X, Y) -> (params, opt_state, mean_loss)``
    over X: (num_batches, M, mubatch, in_dim) — plus an aux dict as a
    fourth output when instrumented (``trainer._make_epoch_core``):
    ``{"grad_norm": mean pre-clip global grad norm}`` under
    ``with_grad_norm``; per-step ``(num_batches,)`` vectors ``step_loss`` /
    ``step_grad_norm`` (pre-clip) / ``step_param_norm`` (post-update) under
    ``with_step_stats``; per-step ``(num_batches, n_layers)`` digest
    vectors under ``"digests"`` with ``with_digests``. The aux stays on the
    device, stacked once at the epoch's end: the host reads it once per
    dispatch, never per step. ``batch_step`` must return the grad norm
    under ``with_grad_norm or with_step_stats`` and the digest dict last
    under ``with_digests``."""
    track_gn = with_grad_norm or with_step_stats

    def epoch(params, opt_state, X, Y):
        loss_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        gn_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        steps = {"step_loss": [], "step_grad_norm": [], "step_param_norm": []}
        digests = []
        for xb, yb in zip(X, Y):
            out = batch_step(params, opt_state, xb, yb)
            params, opt_state = out[0], out[1]
            loss_sum = loss_sum + out[2]
            if track_gn:
                gn_sum = gn_sum + out[3]
            if with_step_stats:
                steps["step_loss"].append(out[2])
                steps["step_grad_norm"].append(out[3])
                # post-update param norm: the "did the step blow the
                # weights up" scalar the health monitor watches
                steps["step_param_norm"].append(global_norm(param_tree(params)))
            if with_digests:
                digests.append(out[-1])
        nb = X.shape[0]
        if not (with_grad_norm or with_step_stats or with_digests):
            return params, opt_state, loss_sum / nb
        return params, opt_state, loss_sum / nb, stack_epoch_aux(
            gn_sum / nb if with_grad_norm else None,
            steps if with_step_stats else None,
            digests if with_digests else None,
        )

    return epoch


def stack_epoch_aux(grad_norm, steps, digests):
    """The epoch's aux dict from its per-step lists, stacked on the device."""
    aux = {}
    if grad_norm is not None:
        aux["grad_norm"] = grad_norm
    if steps is not None:
        aux.update({k: torch.stack(v) for k, v in steps.items()})
    if digests is not None:
        aux["digests"] = {k: torch.stack([d[k] for d in digests]) for k in DIGEST_KEYS}
    return aux


def _make_epoch_kernel_core(spec, opt, fuse_mubatches, clip_norm):
    """The whole epoch as one launch of the fused train kernel (epoch mode):
    the same signature as ``_make_epoch_core``'s result, and per batch the
    same computation and loss order as a loop of ``megakernel`` steps."""
    sspec = _validate_megakernel(spec, opt, fuse_mubatches, name="epoch_kernel")

    def epoch_core(params, opt_state, X, Y):
        return _fused_kernel_call(
            spec, sspec, opt, params, opt_state, X, Y, clip_norm=clip_norm
        )

    return epoch_core


def make_train_epoch(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                     megakernel=False, epoch_kernel=False, with_grad_norm=False,
                     with_step_stats=False, with_digests=False):
    """Whole epoch: ``epoch(params, opt_state, X, Y) -> (params, opt_state,
    mean_loss)``, ``mean_loss`` the mean batch training loss (``loss_sum /
    nb``, a 0-d tensor). ``with_grad_norm``, ``with_step_stats`` and
    ``with_digests`` add the telemetry aux dict of ``_make_epoch_core`` as a
    fourth output (not on the kernel paths). ``megakernel``: one
    fused-kernel launch per batch; ``epoch_kernel``: one for the whole
    epoch."""
    if epoch_kernel:
        if megakernel:
            raise ValueError("megakernel and epoch_kernel are exclusive")
        if with_grad_norm or with_step_stats or with_digests:
            raise ValueError(_NO_STEP_AUX)
        return _make_epoch_kernel_core(spec, opt, fuse_mubatches, clip_norm)
    batch_step = _make_batch_step(
        spec, opt, fuse_mubatches, clip_norm, with_grad_norm or with_step_stats,
        megakernel, with_digests,
    )
    return _make_epoch_core(batch_step, with_grad_norm, with_step_stats, with_digests)


def make_train_run(spec: ModelSpec, opt, fuse_mubatches=False, clip_norm=None,
                   with_eval=True, megakernel=False, epoch_kernel=False,
                   run_kernel=False, with_grad_norm=False):
    """Whole run: ``run(params, opt_state, X, Y, vx, vy, n_epochs) ->
    (params, opt_state, losses[n_epochs], accs[n_epochs])``, each epoch
    followed by the full-split argmax accuracy (one forward over ``vx``).
    ``with_eval=False`` drops ``vx``/``vy`` and the accuracies:
    ``run(params, opt_state, X, Y, n_epochs) -> (params, opt_state,
    losses)``. ``with_grad_norm`` appends ``{"grad_norm": (n_epochs,)}``.
    ``megakernel``/``epoch_kernel`` run each epoch as in
    ``make_train_epoch``; ``run_kernel`` (with ``with_eval=False``) runs the
    whole run as ONE launch of the fused train kernel."""
    if with_grad_norm and (megakernel or epoch_kernel or run_kernel):
        raise ValueError(_NO_STEP_AUX)
    if run_kernel:
        if megakernel or epoch_kernel:
            raise ValueError(
                "run_kernel already subsumes the epoch/mega kernels; pass "
                "only run_kernel=True"
            )
        if with_eval:
            raise ValueError(
                "run_kernel supports with_eval=False only (per-epoch eval "
                "needs per-epoch params outside the kernel)"
            )
        sspec = _validate_megakernel(spec, opt, fuse_mubatches, name="run_kernel")

        def run_all(params, opt_state, X, Y, n_epochs):
            if n_epochs < 1:
                raise ValueError("run_kernel requires n_epochs >= 1")
            return _fused_kernel_call(
                spec, sspec, opt, params, opt_state, X, Y, clip_norm=clip_norm,
                n_epochs=n_epochs,
            )

        return run_all
    epoch = make_train_epoch(
        spec, opt, fuse_mubatches, clip_norm, megakernel=megakernel,
        epoch_kernel=epoch_kernel, with_grad_norm=with_grad_norm,
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
