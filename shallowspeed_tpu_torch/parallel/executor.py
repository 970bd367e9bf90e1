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

The schedule lattice, as the JAX executor runs it:

- virtual stages (``prog.num_chunks`` = V > 1, interleaved schedules): the
  stacked rows are in the device-major ``interleave_order``, so device
  ``s`` owns rows ``s*V .. s*V+V-1`` and a cell of chunk ``ck`` (the
  ``chunk`` table) computes row ``s*V + ck``; the ring relay's wrap from the
  last device to device 0 is then a stage boundary;
- the split backward (``prog.backward_split``): ``OP_BWD`` cells are
  B-inputs (``_stage_bwd_input``: the dgrad chain, peeking the activation
  stash and parking each slot's effective output-grad in the grad stash),
  ``OP_BWD_W`` cells the deferred B-weights (``_stage_bwd_weight``), whose
  wgrads the lowering orders as the B-inputs, so the accumulators see the
  unsplit run's sums in its order (bitwise the unsplit ``"xla"`` run);
- activation recompute (``prog.recompute``): a forward parks only its
  stage input (``xin``; global stage 0 reloads its microbatch instead), and
  ``OP_RECOMPUTE`` re-runs the same ``_stage_fwd`` from it into the stash
  the backward reads (bitwise the stashed run);
- the gelu family (``spec.act == "gelu"``): the mask slot holds the f32
  ``gelu_grad_mult(z)`` (None where the flag is off), residual adds go
  forward and their skip grads backward, on the ``"xla"`` backend.

Masks stay ``torch.bool`` in the stash for the relu family. Stash, grad
stash and input-stash slots are dropped when the lowering frees them, so a
tensor lives as long as the TPU program's buffer slot holds it. The JAX
executor's refusals hold: the pallas backend runs neither the split
backward, recompute nor the gelu family, and the lowering refuses virtual
stages with either of the first two.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from shallowspeed_tpu_torch import cuda_ops, ops
from shallowspeed_tpu_torch.model import ModelSpec, init_model
from shallowspeed_tpu_torch.optimizer import clip_tree, global_norm
from shallowspeed_tpu_torch.trainer import row_crcs, stack_epoch_aux
from shallowspeed_tpu_torch.parallel.lowering import (
    OP_BWD,
    OP_BWD_W,
    OP_FWD,
    OP_NOOP,
    OP_RECOMPUTE,
)

KERNEL_BACKENDS = ("xla", "pallas")


# ---------------------------------------------------------------------------
# The stacked layout (host numpy; the JAX package's functions at tp = 1)
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


def interleave_order(n_stages: int, n_devices: int):
    """Device-major stacked-row order for interleaved layouts
    (``executor.interleave_order``): stacked row ``r = device * V + chunk``
    holds model stage ``chunk * P + device``, so device ``d`` owns rows
    ``d*V .. d*V+V-1``, its V virtual chunks."""
    if n_devices < 1 or n_stages % n_devices:
        raise ValueError(
            f"{n_stages} model stages do not split over {n_devices} devices"
        )
    V = n_stages // n_devices
    return [(r % V) * n_devices + (r // V) for r in range(n_stages)]


def _order(order, S):
    order = list(range(S)) if order is None else [int(s) for s in order]
    if sorted(order) != list(range(S)):
        raise ValueError(f"order must permute 0..{S - 1}, got {order}")
    return order


def stack_params(params_list, spec: ModelSpec, order=None):
    """Per-stage ragged params (host numpy) -> per-slot zero-padded stacks
    and flags, all host numpy (``executor.stack_params``):

      stacked = {"W": tuple_l of (S, out_l, in_l), "b": tuple_l of (S, out_l)}
      flags   = {"active": (S, L), "relu": (S, L), "residual": (S, L),
                 "head_mask": (S, out_last)}

    ``relu[r, l]`` is the slot's activation flag (the spec's family, relu
    or gelu), ``residual[r, l]`` the gelu family's skip add (all False for
    the relu family). ``order[r]`` names the model stage stored at stacked
    row ``r`` (identity by default; ``interleave_order`` for virtual
    stages)."""
    dims = slot_shapes(spec)
    S = spec.n_stages
    L = len(dims)
    order = _order(order, S)
    Ws = [np.zeros((S, o, i), np.float32) for o, i in dims]
    bs = [np.zeros((S, o), np.float32) for o, _ in dims]
    active = np.zeros((S, L), np.bool_)
    relu = np.zeros((S, L), np.bool_)
    residual = np.zeros((S, L), np.bool_)
    head_mask = np.zeros((S, dims[-1][0]), np.bool_)
    for r, s in enumerate(order):
        sspec, sparams = spec.stages[s], params_list[s]
        for l, layer in enumerate(sparams):
            out_d, in_d = np.shape(layer["W"])
            Ws[l][r, :out_d, :in_d] = np.asarray(layer["W"])
            bs[l][r, :out_d] = np.asarray(layer["b"]).reshape(-1)
            active[r, l] = True
            relu[r, l] = sspec.relu_flags[l]
            residual[r, l] = sspec.res_flags[l]
        if sspec.has_head:
            head_mask[r, : sspec.out_dim] = True
    return (
        {"W": tuple(Ws), "b": tuple(bs)},
        {"active": active, "relu": relu, "residual": residual, "head_mask": head_mask},
    )


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def unstack_params(stacked, spec: ModelSpec, order=None):
    """The logical per-stage params back out of a stacked tree (tensors or
    numpy), in model-stage order (inverting ``order``), as host numpy with
    ``b`` as ``(1, out)`` (``executor.unstack_params``)."""
    Ws = [_host(w) for w in stacked["W"]]
    bs = [_host(b) for b in stacked["b"]]
    row_of = {s: r for r, s in enumerate(_order(order, spec.n_stages))}
    out = []
    for s, sspec in enumerate(spec.stages):
        r = row_of[s]
        layers = []
        for l in range(sspec.n_linears):
            in_d, out_d = sspec.local_sizes[l], sspec.local_sizes[l + 1]
            layers.append(
                {
                    "W": Ws[l][r, :out_d, :in_d].copy(),
                    "b": bs[l][r, :out_d].reshape(1, -1).copy(),
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


def init_stacked(spec: ModelSpec, mesh, order=None):
    """The deterministic init, stacked in ``order``: ``(stacked tensors on
    the mesh's device, host flags)``."""
    stacked, flags = stack_params(init_model(spec), spec, order=order)
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


def _stage_fwd(Ws, bs, active, relu, residual, dims, x, kernel_backend, act):
    """Forward of one stage through the per-slot stacks (``Ws[l]``/``bs[l]``
    its row); ``active``/``relu``/``residual`` are the row's host flags.
    Returns ``(out, xs, masks)``; an inactive slot passes ``_fit(x, out_l)``
    on and stashes nothing (its backward is a passthrough with zero
    gradients).

    The relu family runs the flag entry (``kernel_backend="pallas"``) or its
    plain version per slot. The gelu family (``act="gelu"``, plain torch,
    the JAX executor's expressions) stashes the f32 ``gelu_grad_mult(z)`` as
    the slot's mask (None where the flag is off) and adds the residual
    flags' skip connections, ``y_l += x_{l-1}``."""
    fwd = (
        cuda_ops.linear_flag_fwd if kernel_backend == "pallas"
        else cuda_ops.linear_flag_fwd_reference
    )
    xs, masks = [], []
    x_prev = None
    for l, (o, i) in enumerate(dims):
        x_l = _fit(x, i)
        if not active[l]:
            xs.append(None)
            masks.append(None)
            x = _fit(x_l, o)
        elif act == "gelu":
            z = ops.linear(x_l, Ws[l], bs[l])
            if relu[l]:
                mask, x = ops.gelu_grad_mult(z), ops.gelu(z)
            else:
                mask, x = None, z
            if l > 0 and residual[l]:
                x = x + _fit(x_prev, o)
            xs.append(x_l)
            masks.append(mask)
        else:
            x, mask = fwd(x_l, Ws[l], bs[l].reshape(1, -1), relu[l])
            xs.append(x_l)
            masks.append(mask)
        x_prev = x_l
    return x, xs, masks


def _stage_bwd(Ws, active, relu, residual, dims, xs, masks, g, kernel_backend, gW, gb):
    """Backward of one stage through the per-slot stacks: accumulates each
    active slot's dW/db into ``gW[l]``/``gb[l]`` (the row's slots of the
    replica's accumulators, in place) and returns the input gradient. A
    residual at slot ``l + 1`` adds its incoming grad to slot ``l``'s dx
    (its input fed both the Linear and the skip)."""
    bwd = (
        cuda_ops.linear_flag_bwd if kernel_backend == "pallas"
        else cuda_ops.linear_flag_bwd_reference
    )
    L = len(dims)
    g_prev = None
    for l in reversed(range(L)):
        o, i = dims[l]
        g_l = _fit(g, o)
        if not active[l]:
            g = _fit(g_l, i)
        else:
            g, dw, db2 = bwd(g_l, masks[l], xs[l], Ws[l], relu[l])
            gW[l].add_(dw)
            gb[l].add_(db2.reshape(-1))
            if l + 1 < L and residual[l + 1]:
                g = g + _fit(g_prev, i)
        g_prev = g_l
    return g


def _g_eff(g, mask, flag):
    """A slot's effective output-grad: ``cuda_ops.linear_act_bwd_reference``'s
    expression, character for character (a multiply by the mask, so NaN at
    a masked position stays NaN)."""
    return g * mask.to(g.dtype) if flag else g


def _stage_bwd_input(Ws, active, relu, residual, dims, masks, g):
    """The relay-critical half of the split backward (``executor.
    _stage_bwd_input``): the dgrad chain only. Returns ``(dx, g_effs)``, the
    input gradient and each active slot's effective output-grad, which the
    deferred B-weight consumes. ``_g_eff`` and ``ops.linear_grad_input`` are
    the plain unsplit backward's expressions and torch calls, so dx is its
    dx bit for bit."""
    L = len(dims)
    g_effs = [None] * L
    g_prev = None
    for l in reversed(range(L)):
        o, i = dims[l]
        g_l = _fit(g, o)
        if not active[l]:
            g = _fit(g_l, i)
        else:
            g_effs[l] = _g_eff(g_l, masks[l], relu[l])
            g = ops.linear_grad_input(g_effs[l], Ws[l])
            if l + 1 < L and residual[l + 1]:
                g = g + _fit(g_prev, i)
        g_prev = g_l
    return g, g_effs


def _stage_bwd_weight(active, xs, g_effs, gW, gb):
    """The deferred half of the split backward (``executor.
    _stage_bwd_weight``): each active slot's ``(dW, db)`` from the stashed
    input and effective output-grad (``ops.linear_grad_weight``, the plain
    unsplit backward's calls), accumulated in place."""
    for l, on in enumerate(active):
        if on:
            dw, db = ops.linear_grad_weight(g_effs[l], xs[l])
            gW[l].add_(dw)
            gb[l].add_(db)


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
    """The JAX executor's refusals, in its words, and the layout's shape."""
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel_backend {kernel_backend!r}")
    if kernel_backend == "pallas":
        if prog.backward_split:
            raise ValueError(
                "backward_split needs the XLA per-slot backward (the fused "
                "pallas flag kernel computes dgrad+wgrad in one unit and has "
                "no split halves); use kernel_backend='xla'"
            )
        if spec.act != "relu":
            raise ValueError(
                f"the fused pallas flag kernels implement the relu family only; "
                f"use kernel_backend='xla' for act={spec.act!r} models"
            )
        if prog.recompute:
            raise ValueError(
                "recompute re-runs the stage forward through the XLA slot "
                "functions; use kernel_backend='xla' with --recompute"
            )
    if prog.num_stages != mesh.pp or spec.n_stages != mesh.pp * prog.num_chunks:
        raise ValueError(
            f"program has {prog.num_stages} devices x {prog.num_chunks} chunks "
            f"and the model {spec.n_stages} stages, the mesh pp={mesh.pp}"
        )


def _digest_grids(new_stacked, grads):
    """The step's digest dict on the stacked layout
    (``executor.make_pipeline_step``'s ``with_digests`` contract): ``(S,
    L)`` grids, stacked row x slot, of the post-update checksums
    (``trainer.row_crcs``; padding is +0.0, whose word is 0, so a row's
    checksum is its logical block's) and L2 norms, and the post-sync
    PRE-clip gradient norms. Left on the device."""
    def grid(fn, leaves):
        return torch.stack([fn(a) for a in leaves], dim=1)

    def sq(a):
        return torch.sum((a * a).reshape(a.shape[0], -1), dim=1)

    return {
        "crc_w": grid(row_crcs, new_stacked["W"]),
        "crc_b": grid(row_crcs, new_stacked["b"]),
        "pnorm_w": torch.sqrt(grid(sq, new_stacked["W"])),
        "pnorm_b": torch.sqrt(grid(sq, new_stacked["b"])),
        "gnorm_w": torch.sqrt(grid(sq, grads["W"])),
        "gnorm_b": torch.sqrt(grid(sq, grads["b"])),
    }


def make_pipeline_step(mesh, spec: ModelSpec, prog, mubatch_size, opt=None,
                       clip_norm=None, kernel_backend="xla", with_grad_norm=False,
                       with_step_stats=False, with_digests=False):
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

    ``stacked``/``flags``: the ``stack_params`` layout, rows in
    ``interleave_order`` when ``prog.num_chunks > 1``; ``flags`` are HOST
    numpy. ``clip_norm``: the global-norm clip on the post-sync gradient.
    ``kernel_backend``: ``"xla"`` (plain torch) or ``"pallas"`` (the flag
    kernels).

    Telemetry aux (training only), the JAX executor's outputs:
    ``with_grad_norm`` appends the pre-clip global gradient norm of the
    post-sync tree; ``with_step_stats`` (implies it) then the post-update
    global parameter norm (padded entries are exactly zero, so the stacked
    norms are the logical ones); ``with_digests`` appends the
    ``_digest_grids`` dict last. All stay on the device."""
    _check_program(mesh, spec, prog, kernel_backend)
    training = prog.is_training
    if training and opt is None:
        raise ValueError("training program needs an optimizer")
    if (with_grad_norm or with_step_stats or with_digests) and not training:
        raise ValueError(
            "with_grad_norm/with_step_stats/with_digests apply to training "
            "programs only"
        )
    if with_step_stats:
        with_grad_norm = True  # step stats carry the grad norm per step
    act = spec.act
    split_bwd, rec = bool(prog.backward_split), bool(prog.recompute)
    dims = slot_shapes(spec)
    D_in, D_out = dims[0][1], dims[-1][0]
    W_rel = relay_width(spec)
    P, dp, V = mesh.pp, mesh.dp, prog.num_chunks
    M, mb_sz = prog.num_micro_batches, mubatch_size
    Kf, Kb, Ks = prog.n_fwd_slots, prog.n_bwd_slots, prog.n_stash_slots
    Kg, Kx = prog.n_gstash_slots, prog.n_xin_slots
    B_global = spec.global_batch_size
    # the tick tables as host lists, read cell by cell
    tab = {
        k: np.asarray(getattr(prog, a)).tolist()
        for k, a in dict(
            op="op", mb="mb", rf="read_fwd_slot", rb="read_bwd_slot",
            inf="in_fwd_slot", inb="in_bwd_slot", sf="send_fwd", sb="send_bwd",
            sw="stash_write", sr="stash_read", ck="chunk", li="load_in",
            ih="is_head", sp="stash_peek", gw="gstash_write", gr="gstash_read",
            xw="xin_write", xr="xin_read",
        ).items()
    }
    head_masks = {}  # device copies of the head-mask rows, keyed by content

    def head_mask_rows(flags, device):
        hm = np.asarray(flags["head_mask"], np.bool_)
        key = (hm.tobytes(), hm.shape, str(device))
        if key not in head_masks:
            rows = torch.from_numpy(hm.copy()).to(device)
            head_masks[key] = [rows[r].reshape(1, -1) for r in range(hm.shape[0])]
        return head_masks[key]

    def run_ticks(stacked, flags, X, Y, dev):
        """Every tick of the program on every rank. Returns the replicas'
        gradient accumulators and loss tallies (training) or predictions."""
        active = np.asarray(flags["active"]).tolist()
        relu = np.asarray(flags["relu"]).tolist()
        residual = np.asarray(flags["residual"]).tolist()
        hm = head_mask_rows(flags, dev)
        Ws = [[w[r] for w in stacked["W"]] for r in range(P * V)]
        bs = [[b[r] for b in stacked["b"]] for r in range(P * V)]
        fwd_mail = [[[None] * (Kf + 1) for _ in range(P)] for _ in range(dp)]
        bwd_mail = [[[None] * (Kb + 1) for _ in range(P)] for _ in range(dp)]
        if training:
            # per rank: the activation stash, the split backward's grad
            # stash and recompute's input stash (lowering-assigned slots,
            # the last one the trash slot)
            stash = [[[None] * (Ks + 1) for _ in range(P)] for _ in range(dp)]
            gstash = [[[None] * (Kg + 1) for _ in range(P)] for _ in range(dp)]
            xin = [[[None] * (Kx + 1) for _ in range(P)] for _ in range(dp)]
            acc = [
                {k: tuple(torch.zeros_like(a) for a in stacked[k]) for k in ("W", "b")}
                for _ in range(dp)
            ]
            loss = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(dp)]
        else:
            preds = [[None] * (M + 1) for _ in range(dp)]

        def fwd(r, x_in):
            return _stage_fwd(
                Ws[r], bs[r], active[r], relu[r], residual[r], dims, x_in, kernel_backend, act
            )

        def head_or_mail(d, s, t, r, z, mb_r):
            if tab["ih"][t][s] == 1:
                return ops.softmax_mse_head_grad(z, Y[d, mb_r], B_global, valid_mask=hm[r])
            return bwd_mail[d][s][tab["rb"][t][s]]

        for t in range(prog.num_ticks):
            op, mbt = tab["op"][t], tab["mb"][t]
            sends = []  # (mailbox, slot, payload) delivered at the tick's end
            for s in range(P):
                if op[s] == OP_NOOP:
                    continue
                mb_i = mbt[s]
                mb_r = min(mb_i, M - 1)
                r = s * V + tab["ck"][t][s]  # the active chunk's stacked row
                is_head = tab["ih"][t][s] == 1
                load_in = tab["li"][t][s] == 1
                for d in range(dp):
                    if op[s] == OP_FWD:
                        if load_in:
                            x_in = X[d, mb_r]
                        else:
                            x_in = _fit(fwd_mail[d][s][tab["rf"][t][s]], D_in)
                        out, xs_l, masks_l = fwd(r, x_in)
                        if training:
                            if rec:
                                # park the stage input only (global stage 0
                                # reloads its microbatch; its slot is trash)
                                xin[d][s][tab["xw"][t][s]] = x_in
                            else:
                                stash[d][s][tab["sw"][t][s]] = (xs_l, masks_l, out)
                            if is_head:
                                p = ops.softmax(out, valid_mask=hm[r])
                                loss[d] = loss[d] + ops.mse_loss(p, Y[d, mb_r], B_global)
                        elif is_head:
                            preds[d][mb_i] = ops.softmax(out, valid_mask=hm[r])
                        if tab["sf"][t][s] == 1:
                            n = (s + 1) % P
                            sends.append((fwd_mail[d][n], tab["inf"][t][n], _fit(out, W_rel)))
                    elif op[s] == OP_RECOMPUTE:
                        # the forward again, from the same input bits through
                        # the same _stage_fwd: the stashed run's residuals
                        xr = tab["xr"][t][s]
                        x_in = X[d, mb_r] if load_in else _fit(xin[d][s][xr], D_in)
                        xin[d][s][xr] = None
                        out, xs_l, masks_l = fwd(r, x_in)
                        stash[d][s][tab["sw"][t][s]] = (xs_l, masks_l, out)
                    elif op[s] == OP_BWD:
                        if split_bwd:
                            # B-input: peek the stash (the B-weight frees it)
                            _, masks_r, z_r = stash[d][s][tab["sp"][t][s]]
                            dx, g_effs = _stage_bwd_input(
                                Ws[r], active[r], relu[r], residual[r], dims, masks_r,
                                head_or_mail(d, s, t, r, z_r, mb_r),
                            )
                            gstash[d][s][tab["gw"][t][s]] = g_effs
                        else:
                            sr = tab["sr"][t][s]
                            xs_r, masks_r, z_r = stash[d][s][sr]
                            stash[d][s][sr] = None
                            dx = _stage_bwd(
                                Ws[r], active[r], relu[r], residual[r], dims, xs_r, masks_r,
                                head_or_mail(d, s, t, r, z_r, mb_r), kernel_backend,
                                [w[r] for w in acc[d]["W"]], [b[r] for b in acc[d]["b"]],
                            )
                        if tab["sb"][t][s] == 1:
                            n = (s - 1) % P
                            sends.append((bwd_mail[d][n], tab["inb"][t][n], _fit(dx, W_rel)))
                    elif op[s] == OP_BWD_W:
                        sr, gr = tab["sr"][t][s], tab["gr"][t][s]
                        _stage_bwd_weight(
                            active[r], stash[d][s][sr][0], gstash[d][s][gr],
                            [w[r] for w in acc[d]["W"]], [b[r] for b in acc[d]["b"]],
                        )
                        stash[d][s][sr] = gstash[d][s][gr] = None
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
            raw = grads
            if with_grad_norm:
                gnorm = global_norm(grads)
            if clip_norm is not None:
                grads = clip_tree(grads, clip_norm)
            stacked, opt_state = opt.apply(stacked, grads, opt_state)
            outs = (stacked, opt_state, loss)
            if with_grad_norm:
                outs += (gnorm,)
            if with_step_stats:
                outs += (global_norm(stacked),)
            if with_digests:
                outs += (_digest_grids(stacked, raw),)
            return outs

        return step

    def infer(stacked, flags, x):
        dev = stacked["W"][0].device
        preds = run_ticks(stacked, flags, split(x, D_in), None, dev)
        return torch.cat([p for rep in preds for p in rep[:M]], dim=0)

    return infer


def make_pipeline_epoch(mesh, spec, prog, mubatch_size, opt, clip_norm=None,
                        kernel_backend="xla", with_grad_norm=False,
                        with_step_stats=False, with_digests=False):
    """The pipeline train step over every batch of an epoch
    (``executor.make_pipeline_epoch``): ``epoch(stacked, flags, opt_state,
    X, Y) -> (stacked, opt_state, mean_loss)`` over ``X``: ``(num_batches,
    global_batch, in_dim)``, the steps in order, the loss summed from zero
    in batch order and divided by the batch count (the JAX epoch scan's
    order). ``with_grad_norm``/``with_step_stats``/``with_digests`` add the
    sequential trainer's aux dict as a fourth output (``trainer.
    _make_epoch_core``), the digests as ``(num_batches, S, L)`` grids in
    stacked-row order."""
    step = make_pipeline_step(
        mesh, spec, prog, mubatch_size, opt, clip_norm=clip_norm,
        kernel_backend=kernel_backend, with_grad_norm=with_grad_norm,
        with_step_stats=with_step_stats, with_digests=with_digests,
    )
    track_gn = with_grad_norm or with_step_stats

    def epoch(stacked, flags, opt_state, X, Y):
        loss_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        gn_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        steps = {"step_loss": [], "step_grad_norm": [], "step_param_norm": []}
        digests = []
        for xb, yb in zip(X, Y):
            out = step(stacked, flags, opt_state, xb, yb)
            stacked, opt_state, loss = out[0], out[1], out[2]
            loss_sum = loss_sum + loss
            if track_gn:
                gn_sum = gn_sum + out[3]
            if with_step_stats:
                steps["step_loss"].append(loss)
                steps["step_grad_norm"].append(out[3])
                steps["step_param_norm"].append(out[4])
            if with_digests:
                digests.append(out[-1])
        nb = X.shape[0]
        if not (with_grad_norm or with_step_stats or with_digests):
            return stacked, opt_state, loss_sum / nb
        return stacked, opt_state, loss_sum / nb, stack_epoch_aux(
            gn_sum / nb if with_grad_norm else None,
            steps if with_step_stats else None,
            digests if with_digests else None,
        )

    return epoch


def make_pipeline_run(mesh, spec, prog, mubatch_size, opt, clip_norm=None,
                      eval_prog=None, eval_mubatch_size=None, kernel_backend="xla",
                      with_grad_norm=False):
    """Epochs of the pipeline epoch (``executor.make_pipeline_run``).

    Without eval: ``run(stacked, flags, opt_state, X, Y, n_epochs) ->
    (stacked, opt_state, losses[n_epochs])``. With ``eval_prog`` (an
    ``InferenceSchedule`` program, or ``InterleavedInferenceSchedule`` on an
    interleaved layout, of one microbatch over the padded validation
    rows): ``run(stacked, flags, opt_state, X, Y, vx_padded,
    vy_labels, n_epochs) -> (stacked, opt_state, losses, accs)``, each epoch
    followed by the whole split's argmax accuracy. ``with_grad_norm``
    appends ``{"grad_norm": (n_epochs,)}``, each epoch's mean pre-clip
    global gradient norm."""
    epoch = make_pipeline_epoch(
        mesh, spec, prog, mubatch_size, opt, clip_norm=clip_norm,
        kernel_backend=kernel_backend, with_grad_norm=with_grad_norm,
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
        losses, accs, gns = [], [], []
        for _ in range(n_epochs):
            out = epoch(stacked, flags, opt_state, X, Y)
            stacked, opt_state = out[0], out[1]
            losses.append(out[2])
            if with_grad_norm:
                gns.append(out[3]["grad_norm"])
            if eval_step is not None:
                preds = eval_step(stacked, flags, vx_padded)[: vy_labels.shape[0], :out_dim]
                hits = torch.argmax(preds, dim=1) == vy_labels
                accs.append(torch.mean(hits.to(torch.float32)))
        out = (stacked, opt_state, _stack(losses, X.device))
        if eval_step is not None:
            out += (_stack(accs, X.device),)
        if with_grad_norm:
            out += ({"grad_norm": _stack(gns, X.device)},)
        return out

    return run


def _stack(scalars, device):
    if not scalars:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.stack(scalars)
