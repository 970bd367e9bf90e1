"""Lockstep pipeline executor: tick programs over a virtual ``(dp, pp)`` mesh
on one device — the port's counterpart of
``shallowspeed_tpu/parallel/executor.py``.

The JAX package runs a lowered ``TickProgram`` as ONE ``shard_map`` program:
each device of the ``('dp', 'pp')`` mesh holds its stage's row of the
zero-padded stacked parameters, ``lax.scan`` walks the tick tables, every
tick ``lax.switch``es between {noop, forward, backward}, two ``ppermute``s
relay payloads between neighbouring stages and a ``psum`` over ``dp`` sums
the gradient before the optimizer tail. This module runs the same program
with every virtual rank ``(d, s)`` on one ``torch.device`` and keeps
everything but the physical placement:

- the same lowered tick tables (``parallel/lowering.py``, copied) and the
  same per-slot zero-padded stacked layout (slot ``l`` stacked to
  ``(S, max_out_l, max_in_l)``; ``stack_params``/``unstack_params`` and the
  flags ``active``/``relu``/``residual``/``head_mask`` are the JAX
  package's);
- per rank, the same mailboxes (``Kf + 1`` and ``Kb + 1`` slots, the last
  the trash slot), stash rings (``Ks + 1``) and gradient accumulators; a
  slot holds the tensor a tick wrote into it (PyTorch runs eagerly, so a
  reference is the buffer; nothing writes into a stashed tensor again);
- the same relays: ``relay`` stores a sender's payload in its neighbour's
  mailbox slot at the end of the tick (``ppermute`` on the ring perms of
  the JAX executor); a link that carries nothing lands in the receiver's
  trash slot, which nobody reads, so it moves nothing here;
- the same dp gradient SUM (``dp_sum``: a fixed-order sum over the
  replicas' accumulators) and loss (psum over dp of the head stage's tally),
  and the same optimizer tail (global-norm clip on the post-sync tree, then
  ``opt.apply`` on the stacked tree, in place).

``relay`` and ``dp_sum`` are the two data movers between ranks; the
multi-card runtime (one process per rank) replaces them with NCCL
send/recv and all-reduce and keeps the rest.

The host knows every slot's ``active`` and ``relu`` flag (``flags`` are
host numpy), so each tick's work is decided on the host: a noop cell costs
nothing, an inactive slot of an active cell skips its compute (the JAX
executor computes it and then selects ``_fit(x, o)`` forward and exact
zero gradients, which is what skipping gives), and the relu flag is a
Python bool. Per slot unit, two backends:

- ``"xla"``: plain torch — the flag kernels' plain versions
  ``cuda_ops.linear_flag_fwd_reference`` / ``linear_flag_bwd_reference``
  (the Linear, then the relu when the flag is on; the Linear's VJP of
  ``g * mask`` or of ``g``), as the JAX XLA path computes outside any
  Pallas kernel;
- ``"pallas"``: the flag kernels ``cuda_ops.linear_flag_fwd`` /
  ``linear_flag_bwd`` (TPU kernels B5-B8) with the host flag as their
  run-time ``apply_relu``: on CUDA tensors one launch each per active slot
  of a non-noop cell, on CPU tensors their plain versions, so on the CPU
  the two backends give the same bits.

Masks stay ``torch.bool`` in the stash. Not ported here, and refused by
``make_pipeline_step``: virtual stages (interleaved), the split backward,
recompute and the gelu family (``ROADMAP.md`` §A item 6b).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from shallowspeed_tpu_torch import cuda_ops, ops
from shallowspeed_tpu_torch.model import ModelSpec, init_model
from shallowspeed_tpu_torch.optimizer import clip_tree
from shallowspeed_tpu_torch.parallel.lowering import OP_BWD, OP_FWD, OP_NOOP

KERNEL_BACKENDS = ("xla", "pallas")


# ---------------------------------------------------------------------------
# The stacked layout (host numpy; the JAX package's functions at identity
# order, tp = 1)
# ---------------------------------------------------------------------------


def slot_shapes(spec: ModelSpec, tp: int = 1):
    """Static per-slot stacked dims ``[(out_l, in_l)]``, maxima over stages
    (``executor.slot_shapes``): validates that a shorter stage's output fits
    through every later slot; ``tp > 1`` rounds each dim up to a multiple of
    tp (the lowering's FLOP model asks for it; the executor runs tp = 1)."""
    L = max((s.n_linears for s in spec.stages), default=0) or 1
    dims = []
    for l in range(L):
        outs = [s.local_sizes[l + 1] for s in spec.stages if s.n_linears > l]
        ins = [s.local_sizes[l] for s in spec.stages if s.n_linears > l]
        dims.append((max(outs), max(ins)))
    for s in spec.stages:
        for l in range(s.n_linears, L):
            o, i = dims[l]
            if s.out_dim > min(o, i):
                raise ValueError(
                    f"stage with out_dim={s.out_dim} cannot pass through slot {l} "
                    f"of width {min(o, i)}; use equal-depth stages for this size list"
                )
    if tp > 1:
        for l in range(1, L, 2):  # row-parallel slots consume a rank shard
            if dims[l][1] != dims[l - 1][0]:
                raise ValueError(
                    f"tp={tp} needs chained slot widths (in_{l} == out_{l - 1}) "
                    f"but slot {l} consumes {dims[l][1]} from a slot producing "
                    f"{dims[l - 1][0]}; use a monotone-decreasing size list"
                )
        dims = [(-(-o // tp) * tp, -(-i // tp) * tp) for o, i in dims]
    return dims


def stash_slot_nbytes(spec: ModelSpec, mubatch_size: int, tp: int = 1):
    """Per-slot bytes of each stash ring (``executor.stash_slot_nbytes`` at
    tp = 1): ``"stash"`` (the slots' inputs f32, their masks, 1 byte for
    the relu family and f32 for gelu, and the head logits), ``"xin"`` (one
    stage input) and ``"gstash"`` (per-slot effective output-grads)."""
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: the port's executor runs tp = 1")
    dims = slot_shapes(spec)
    mask_bytes = 1 if spec.act == "relu" else 4
    mb = mubatch_size
    outs = sum(o for o, _ in dims)
    return {
        "stash": 4 * mb * sum(i for _, i in dims) + mask_bytes * mb * outs
        + 4 * mb * dims[-1][0],
        "xin": 4 * mb * dims[0][1],
        "gstash": 4 * mb * outs,
    }


def relay_width(spec: ModelSpec) -> int:
    """The widest inter-stage boundary (``executor.relay_width``): the
    mailbox and payload width, 127 for the flagship at PP=4."""
    return max((s.in_dim for s in spec.stages[1:]), default=1)


def stack_params(params_list, spec: ModelSpec):
    """Per-stage ragged params (host numpy) -> per-slot zero-padded stacks
    and flags, all host numpy (``executor.stack_params``):

      stacked = {"W": tuple_l of (S, out_l, in_l), "b": tuple_l of (S, out_l)}
      flags   = {"active": (S, L), "relu": (S, L), "residual": (S, L),
                 "head_mask": (S, out_last)}
    """
    dims = slot_shapes(spec)
    S = spec.n_stages
    L = len(dims)
    Ws = [np.zeros((S, o, i), np.float32) for o, i in dims]
    bs = [np.zeros((S, o), np.float32) for o, _ in dims]
    active = np.zeros((S, L), np.bool_)
    relu = np.zeros((S, L), np.bool_)
    residual = np.zeros((S, L), np.bool_)
    head_mask = np.zeros((S, dims[-1][0]), np.bool_)
    for s, (sspec, sparams) in enumerate(zip(spec.stages, params_list)):
        for l, layer in enumerate(sparams):
            out_d, in_d = np.shape(layer["W"])
            Ws[l][s, :out_d, :in_d] = np.asarray(layer["W"])
            bs[l][s, :out_d] = np.asarray(layer["b"]).reshape(-1)
            active[s, l] = True
            relu[s, l] = sspec.relu_flags[l]
            residual[s, l] = sspec.res_flags[l]
        if sspec.has_head:
            head_mask[s, : sspec.out_dim] = True
    return (
        {"W": tuple(Ws), "b": tuple(bs)},
        {"active": active, "relu": relu, "residual": residual, "head_mask": head_mask},
    )


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def unstack_params(stacked, spec: ModelSpec):
    """The logical per-stage params back out of a stacked tree (tensors or
    numpy), as host numpy with ``b`` as ``(1, out)`` (``executor.
    unstack_params``)."""
    Ws = [_host(w) for w in stacked["W"]]
    bs = [_host(b) for b in stacked["b"]]
    out = []
    for s, sspec in enumerate(spec.stages):
        layers = []
        for l in range(sspec.n_linears):
            in_d, out_d = sspec.local_sizes[l], sspec.local_sizes[l + 1]
            layers.append(
                {
                    "W": Ws[l][s, :out_d, :in_d].copy(),
                    "b": bs[l][s, :out_d].reshape(1, -1).copy(),
                }
            )
        out.append(layers)
    return out


def put_stacked(stacked_np, device):
    """A host stacked ``{"W", "b"}`` tree as contiguous float32 tensors on
    ``device`` (private copies: the optimizer updates them in place)."""
    return {
        k: tuple(torch.from_numpy(np.array(a, np.float32)).to(device) for a in stacked_np[k])
        for k in ("W", "b")
    }


def init_stacked(spec: ModelSpec, mesh):
    """The deterministic init, stacked: ``(stacked tensors on the mesh's
    device, host flags)``."""
    stacked, flags = stack_params(init_model(spec), spec)
    return put_stacked(stacked, mesh.device), flags


# ---------------------------------------------------------------------------
# The slot units
# ---------------------------------------------------------------------------


def _fit(a, width):
    """Slice or zero-pad the last dim to ``width`` (exact under the padding
    invariant: dropped columns are always zero); the result is contiguous,
    as the kernels take it."""
    cur = a.shape[-1]
    if cur == width:
        return a
    if cur > width:
        return a[..., :width].contiguous()
    return F.pad(a, (0, width - cur))


def _stage_fwd(Ws, bs, active, relu, dims, x, kernel_backend):
    """Forward of one stage through the per-slot stacks (``Ws[l]``/``bs[l]``
    its rows); ``active``/``relu`` are the stage's host flags. Returns
    ``(out, xs, masks)``; an inactive slot passes ``_fit(x, out_l)`` on and
    stashes nothing (its backward is a passthrough with zero gradients)."""
    fwd = (
        cuda_ops.linear_flag_fwd if kernel_backend == "pallas"
        else cuda_ops.linear_flag_fwd_reference
    )
    xs, masks = [], []
    for l, (o, i) in enumerate(dims):
        x_l = _fit(x, i)
        if not active[l]:
            xs.append(None)
            masks.append(None)
            x = _fit(x_l, o)
            continue
        x, mask = fwd(x_l, Ws[l], bs[l].reshape(1, -1), relu[l])
        xs.append(x_l)
        masks.append(mask)
    return x, xs, masks


def _stage_bwd(Ws, active, relu, dims, xs, masks, g, kernel_backend, gW, gb):
    """Backward of one stage through the per-slot stacks: accumulates each
    active slot's dW/db into ``gW[l]``/``gb[l]`` (the stage's rows of the
    replica's accumulators, in place) and returns the input gradient."""
    bwd = (
        cuda_ops.linear_flag_bwd if kernel_backend == "pallas"
        else cuda_ops.linear_flag_bwd_reference
    )
    for l in reversed(range(len(dims))):
        o, i = dims[l]
        g_l = _fit(g, o)
        if not active[l]:
            g = _fit(g_l, i)
            continue
        g, dw, db2 = bwd(g_l, masks[l], xs[l], Ws[l], relu[l])
        gW[l].add_(dw)
        gb[l].add_(db2.reshape(-1))
    return g


# ---------------------------------------------------------------------------
# The two data movers between virtual ranks
# ---------------------------------------------------------------------------


def relay(mailbox, slot, payload):
    """Deliver ``payload`` into slot ``slot`` of the receiving rank's
    mailbox at the end of a tick (the JAX executor's ``ppermute``)."""
    mailbox[slot] = payload


def dp_sum(trees):
    """The dp gradient SUM (the JAX executor's ``psum`` over ``dp``): the
    replicas' accumulator trees added leaf by leaf in replica order."""
    return functools.reduce(
        lambda a, b: {k: tuple(x + y for x, y in zip(a[k], b[k])) for k in a}, trees
    )


# ---------------------------------------------------------------------------
# The tick interpreter
# ---------------------------------------------------------------------------


def _check_program(mesh, spec, prog, kernel_backend):
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel_backend {kernel_backend!r}")
    if spec.act != "relu":
        raise NotImplementedError(
            f"act={spec.act!r}: the port's executor runs the relu family only "
            "(the gelu family on the mesh is ROADMAP.md §A item 6b)"
        )
    for what, on in (
        ("virtual stages (interleaved)", prog.num_chunks != 1),
        ("backward_split", prog.backward_split),
        ("recompute", prog.recompute),
    ):
        if on:
            raise NotImplementedError(
                f"{what}: not ported to the port's executor yet (ROADMAP.md §A "
                "item 6b)"
            )
    if prog.num_stages != mesh.pp or spec.n_stages != mesh.pp:
        raise ValueError(
            f"program has {prog.num_stages} stages and the model {spec.n_stages}, "
            f"the mesh pp={mesh.pp}"
        )


def make_pipeline_step(mesh, spec: ModelSpec, prog, mubatch_size, opt=None,
                       clip_norm=None, kernel_backend="xla"):
    """The step executing one ``TickProgram`` over the virtual mesh
    (``executor.make_pipeline_step`` at tp = 1, zero = 0, no buckets).

    Training (``prog.is_training``, ``opt`` required):
        ``step(stacked, flags, opt_state, x, y) -> (stacked, opt_state, loss)``
      ``x``: ``(global_batch, in_dim)``, ``y``: ``(global_batch, out_dim)``
      one-hot, split over dp into contiguous row blocks of ``M *
      mubatch_size`` rows (``P('dp')``); ``loss`` the global-batch MSE (a
      0-d tensor). ``stacked`` and ``opt_state`` are updated in place.
    Inference:
        ``step(stacked, flags, x) -> preds`` ``(global_eval_batch, out_width)``.

    ``flags``: the HOST numpy flags of ``stack_params``. ``clip_norm``: the
    global-norm clip on the post-sync gradient. ``kernel_backend``:
    ``"xla"`` (plain torch) or ``"pallas"`` (the flag kernels)."""
    _check_program(mesh, spec, prog, kernel_backend)
    training = prog.is_training
    if training and opt is None:
        raise ValueError("training program needs an optimizer")
    dims = slot_shapes(spec)
    L = len(dims)
    D_in, D_out = dims[0][1], dims[-1][0]
    W_rel = relay_width(spec)
    P, dp = mesh.pp, mesh.dp
    M, mb_sz = prog.num_micro_batches, mubatch_size
    Kf, Kb, Ks = prog.n_fwd_slots, prog.n_bwd_slots, prog.n_stash_slots
    B_global = spec.global_batch_size
    # the tick tables as host lists, read cell by cell
    tab = {
        k: np.asarray(getattr(prog, a)).tolist()
        for k, a in dict(
            op="op", mb="mb", rf="read_fwd_slot", rb="read_bwd_slot",
            inf="in_fwd_slot", inb="in_bwd_slot", sf="send_fwd", sb="send_bwd",
            sw="stash_write", sr="stash_read", li="load_in", ih="is_head",
        ).items()
    }
    head_masks = {}  # device copies of the head-mask rows, keyed by content

    def head_mask_rows(flags, device):
        hm = np.asarray(flags["head_mask"], np.bool_)
        key = (hm.tobytes(), hm.shape, str(device))
        if key not in head_masks:
            rows = torch.from_numpy(hm.copy()).to(device)
            head_masks[key] = [rows[s].reshape(1, -1) for s in range(hm.shape[0])]
        return head_masks[key]

    def run_ticks(stacked, flags, X, Y, dev):
        """Every tick of the program on every rank. Returns the replicas'
        gradient accumulators and loss tallies (training) or predictions."""
        active = np.asarray(flags["active"]).tolist()
        relu = np.asarray(flags["relu"]).tolist()
        hm = head_mask_rows(flags, dev)
        Ws = [[w[s] for w in stacked["W"]] for s in range(P)]
        bs = [[b[s] for b in stacked["b"]] for s in range(P)]
        fwd_mail = [[[None] * (Kf + 1) for _ in range(P)] for _ in range(dp)]
        bwd_mail = [[[None] * (Kb + 1) for _ in range(P)] for _ in range(dp)]
        if training:
            stash = [[[None] * (Ks + 1) for _ in range(P)] for _ in range(dp)]
            acc = [
                {k: tuple(torch.zeros_like(a) for a in stacked[k]) for k in ("W", "b")}
                for _ in range(dp)
            ]
            loss = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(dp)]
        else:
            preds = [[None] * (M + 1) for _ in range(dp)]
        for t in range(prog.num_ticks):
            op, mbt = tab["op"][t], tab["mb"][t]
            sends = []  # (mailbox, slot, payload) delivered at the tick's end
            for s in range(P):
                if op[s] == OP_NOOP:
                    continue
                mb_i = mbt[s]
                mb_r = min(mb_i, M - 1)
                is_head = tab["ih"][t][s] == 1
                for d in range(dp):
                    if op[s] == OP_FWD:
                        if tab["li"][t][s] == 1:
                            x_in = X[d, mb_r]
                        else:
                            x_in = _fit(fwd_mail[d][s][tab["rf"][t][s]], D_in)
                        out, xs_l, masks_l = _stage_fwd(
                            Ws[s], bs[s], active[s], relu[s], dims, x_in, kernel_backend
                        )
                        if training:
                            stash[d][s][tab["sw"][t][s]] = (xs_l, masks_l, out)
                            if is_head:
                                p = ops.softmax(out, valid_mask=hm[s])
                                loss[d] = loss[d] + ops.mse_loss(p, Y[d, mb_r], B_global)
                        elif is_head:
                            preds[d][mb_i] = ops.softmax(out, valid_mask=hm[s])
                        if tab["sf"][t][s] == 1:
                            r = (s + 1) % P
                            sends.append((fwd_mail[d][r], tab["inf"][t][r], _fit(out, W_rel)))
                    elif op[s] == OP_BWD:
                        xs_r, masks_r, z_r = stash[d][s][tab["sr"][t][s]]
                        if is_head:
                            g_in = ops.softmax_mse_head_grad(
                                z_r, Y[d, mb_r], B_global, valid_mask=hm[s]
                            )
                        else:
                            g_in = bwd_mail[d][s][tab["rb"][t][s]]
                        dx = _stage_bwd(
                            Ws[s], active[s], relu[s], dims, xs_r, masks_r, g_in,
                            kernel_backend,
                            [w[s] for w in acc[d]["W"]], [b[s] for b in acc[d]["b"]],
                        )
                        if tab["sb"][t][s] == 1:
                            r = (s - 1) % P
                            sends.append((bwd_mail[d][r], tab["inb"][t][r], _fit(dx, W_rel)))
                    else:
                        raise ValueError(f"tick {t} stage {s}: op code {op[s]} not ported")
            for mailbox, slot, payload in sends:
                relay(mailbox, slot, payload)
        if training:
            return acc, loss
        return preds

    def split(a, width):
        """``(global_batch, dim)`` -> ``(dp, M, mubatch, width)``: replica
        ``d`` takes rows ``[d, d + 1) * M * mubatch`` (``P('dp')``)."""
        if a.shape[0] != dp * M * mb_sz:
            raise ValueError(
                f"expected {dp} x {M} x {mb_sz} = {dp * M * mb_sz} rows, got {a.shape[0]}"
            )
        return _fit(a, width).reshape(dp, M, mb_sz, width)

    if training:

        def step(stacked, flags, opt_state, x, y):
            dev = stacked["W"][0].device
            acc, losses = run_ticks(stacked, flags, split(x, D_in), split(y, D_out), dev)
            # loss: the dp sum of the head stage's tallies (psum over dp; the
            # pmax over pp picks the head stage, the only one that tallied)
            loss = functools.reduce(torch.add, losses)
            grads = dp_sum(acc)
            if clip_norm is not None:
                grads = clip_tree(grads, clip_norm)
            stacked, opt_state = opt.apply(stacked, grads, opt_state)
            return stacked, opt_state, loss

        return step

    def infer(stacked, flags, x):
        dev = stacked["W"][0].device
        preds = run_ticks(stacked, flags, split(x, D_in), None, dev)
        return torch.cat([p for rep in preds for p in rep[:M]], dim=0)

    return infer


def make_pipeline_epoch(mesh, spec, prog, mubatch_size, opt, clip_norm=None,
                        kernel_backend="xla"):
    """The pipeline train step over every batch of an epoch
    (``executor.make_pipeline_epoch``): ``epoch(stacked, flags, opt_state,
    X, Y) -> (stacked, opt_state, mean_loss)`` over ``X``: ``(num_batches,
    global_batch, in_dim)``, the steps in order, the loss summed from zero
    in batch order and divided by the batch count (the JAX epoch scan's
    order)."""
    step = make_pipeline_step(
        mesh, spec, prog, mubatch_size, opt, clip_norm=clip_norm,
        kernel_backend=kernel_backend,
    )

    def epoch(stacked, flags, opt_state, X, Y):
        loss_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        for xb, yb in zip(X, Y):
            stacked, opt_state, loss = step(stacked, flags, opt_state, xb, yb)
            loss_sum = loss_sum + loss
        return stacked, opt_state, loss_sum / X.shape[0]

    return epoch


def make_pipeline_run(mesh, spec, prog, mubatch_size, opt, clip_norm=None,
                      eval_prog=None, eval_mubatch_size=None, kernel_backend="xla"):
    """Epochs of the pipeline epoch (``executor.make_pipeline_run``).

    Without eval: ``run(stacked, flags, opt_state, X, Y, n_epochs) ->
    (stacked, opt_state, losses[n_epochs])``. With ``eval_prog`` (an
    ``InferenceSchedule`` program of one microbatch over the padded
    validation rows): ``run(stacked, flags, opt_state, X, Y, vx_padded,
    vy_labels, n_epochs) -> (stacked, opt_state, losses, accs)``, each epoch
    followed by the whole split's argmax accuracy."""
    epoch = make_pipeline_epoch(
        mesh, spec, prog, mubatch_size, opt, clip_norm=clip_norm,
        kernel_backend=kernel_backend,
    )
    eval_step = None
    if eval_prog is not None:
        eval_step = make_pipeline_step(
            mesh, spec, eval_prog, eval_mubatch_size, kernel_backend=kernel_backend
        )
    out_dim = spec.out_dim

    def run(stacked, flags, opt_state, X, Y, *rest):
        if eval_step is not None:
            vx_padded, vy_labels, n_epochs = rest
        else:
            (n_epochs,) = rest
        losses, accs = [], []
        for _ in range(n_epochs):
            stacked, opt_state, mean_loss = epoch(stacked, flags, opt_state, X, Y)
            losses.append(mean_loss)
            if eval_step is not None:
                preds = eval_step(stacked, flags, vx_padded)[: vy_labels.shape[0], :out_dim]
                hits = torch.argmax(preds, dim=1) == vy_labels
                accs.append(torch.mean(hits.to(torch.float32)))
        out = (stacked, opt_state, _stack(losses, X.device))
        if eval_step is not None:
            out += (_stack(accs, X.device),)
        return out

    return run


def _stack(scalars, device):
    if not scalars:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.stack(scalars)
