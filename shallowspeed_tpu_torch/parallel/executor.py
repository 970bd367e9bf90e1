"""Lockstep pipeline executor: tick programs over a virtual ``(dp, pp[, tp])``
mesh on one device — the port's counterpart of
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

``relay`` and ``dp_sum`` are the two data movers between ranks. The MPMD
runtime (``parallel/mpmd.py``) reuses the stage functions and ``dp_sum``
per stage, each stage on its own CUDA stream of the one device. On a
``ProcessMesh`` (``parallel/multihost.py``) each process runs only its own
ranks over only its stages' rows and its tp ranks' bands (a Megatron pass
multiplies only the held bands), and a mover whose ends sit in two
processes becomes a ``torch.distributed`` collective of the mesh's
``ProcessComm`` (below ``_shard_sum``): a tick's cross-process relays in
one ``batch_isend_irecv``, the dp sum an ``all_reduce`` (one a bucket with
``grad_bucket_bytes``), ZeRO-1's and bucketed ZeRO-2's sum a
``reduce_scatter_tensor`` (one a bucket) and their gather an
``all_gather_into_tensor``, ZeRO-2's and ZeRO-3's per-tick sum one
``reduce_scatter_tensor`` a slot and ZeRO-3's per-tick parameter gather
one ``all_gather_into_tensor`` a stage, over the dp group; each Megatron
sum an ``all_reduce`` over the tp group; the loss and the inference head's
predictions a ``broadcast`` from the head stage's process; every global
norm an ``all_reduce`` of per-process squares; the digest grids an
``all_reduce`` of zero grids filled at each process's rows; the fused
run's eval an ``all_reduce`` of the correct predictions' count. Each
process sums its own replicas (and tp ranks) in order first, so at dp = 2
without a norm, and with tp inside a process, the result is bitwise the
one-process run; where tp crosses processes a product batched over the
held ranks has another shape than the one-process run's batch over every
rank and may reduce otherwise, so it is held to the cross-layout class.

No collective waits on a process that is not yet issuing it: every
process walks the same tick tables, and between two ticks' relays (the
one exchange every process reaches at a tick's end) a process issues
collectives only over its dp and tp groups, whose members run the same
cells in the same order — a dp group holds the same stages and tp ranks,
a tp group the same dp rows and stages — so they issue the same
collectives in the same order: a cell's Megatron sums in stage-pass order
per replica, then the tick's per-slot scatters (its gathers before the
cell). Every collective is bounded by the group's timeout
(``multihost.DEFAULT_TIMEOUT_S``), so a mismatch fails instead of
hanging.

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

ZeRO on the dp axis, as the JAX executor runs it (``zero``; the layouts
and their host converters are below ``init_stacked``): stage 1 sums the
replicas' slabs into the padded flat layout and updates each rank's chunk
with its state shard; stage 2 keeps the state in the block-cyclic per-slot
layout and, without a bucket plan, sums each tick's slot gradients over the
replicas into a persistent shard carry instead of full-slab accumulators;
stage 3 also keeps the params at rest in that layout and rebuilds a chunk's
slot rows per tick. ``grad_bucket_bytes`` (``parallel/gradsync.py`` plans
its buckets) runs the unbucketed sum: on one device a bucket has nothing
to overlap, and the per-bucket sum is the same elementwise adds; at stage 2
it keeps stage 1's full-slab accumulators, as the JAX bucketed program does.

Tensor parallelism on the mesh's ``tp`` axis (``mesh_tp(mesh) > 1``), as the
JAX executor runs it: every slot's W is Megatron-sharded over the tp ranks
of a ``(d, s)`` position — even slots column-parallel (rank t holds the row
band ``W[t*o/tp:(t+1)*o/tp, :]``), odd slots row-parallel (the column band
``W[:, t*i/tp:(t+1)*i/tp]``), every bias its ``out/tp`` band — with slot dims
rounded up to tp multiples (``slot_shapes(spec, tp)``). The stacked slabs
stay the full global layout (on a process mesh each process holds its tp
ranks' bands of them), and a rank's params and gradients are views of
them, so ``dp_sum``, the optimizer tail and the checkpoints see the same
layout at any tp; the ZeRO layouts hold ``pp * tp`` rows of rank-local
shards, as the JAX package's. The ``_stage_*_tp`` functions compute every
tp rank of a position together, slot by slot (one batched product over the
rank views per slot), and each of the JAX executor's ``psum`` over ``tp``
is a sum over the ranks in rank order (``_rank_sum``; across processes
then an all-reduce over the tp group); the sums that reassemble a sharded
value add exact zeros. At tp = 1 none of them runs.

The data movers between virtual ranks (``relay``, ``dp_sum``, the ZeRO
sums, scatters and gathers, ``_rank_sum`` and the inference head's
predictions) note what they move on the program audit's census when one
is recording (``observability/program_audit.py``: one ``is None`` check
otherwise); the tick loop names each tick's branch for it.

Masks stay ``torch.bool`` in the stash for the relu family. Stash, grad
stash and input-stash slots are dropped when the lowering frees them, so a
tensor lives as long as the TPU program's buffer slot holds it. The JAX
executor's refusals hold: the pallas backend runs neither the split
backward, recompute, the gelu family nor tp > 1, and the lowering refuses
virtual stages with either of the first two.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from shallowspeed_tpu_torch import cuda_ops, ops
from shallowspeed_tpu_torch.model import ModelSpec, init_model
from shallowspeed_tpu_torch.observability import program_audit as A
from shallowspeed_tpu_torch.observability.spans import spanned
from shallowspeed_tpu_torch.optimizer import (
    clip_scale,
    clip_tree,
    global_norm,
    is_stateless,
    join_state,
    split_state,
    tree_map,
    tree_sq_sum,
)
from shallowspeed_tpu_torch.trainer import row_crcs, stack_epoch_aux
from shallowspeed_tpu_torch.parallel.lowering import (
    OP_BWD,
    OP_BWD_W,
    OP_FWD,
    OP_NOOP,
    OP_RECOMPUTE,
)
from shallowspeed_tpu_torch.parallel.mesh import ProcessMesh, mesh_tp

KERNEL_BACKENDS = ("xla", "pallas")

# a tick op's branch name on the census (an XLA tick branch holds its own
# copy of the ops inside it)
_BRANCH = {OP_FWD: "fwd", OP_BWD: "bwd", OP_RECOMPUTE: "recompute", OP_BWD_W: "bwd_w"}


# ---------------------------------------------------------------------------
# The stacked layout (host numpy; the JAX package's functions)
# ---------------------------------------------------------------------------


def slot_shapes(spec: ModelSpec, tp: int = 1):
    """Static per-slot stacked dims ``[(out_l, in_l)]``, maxima over stages
    (``executor.slot_shapes``): validates that a shorter stage's output fits
    through every later slot; ``tp > 1`` rounds each dim up to a multiple of
    tp and needs the chained widths ``in_l == out_{l-1}`` at every
    row-parallel (odd) slot, whose input is a column slot's rank shard."""
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


def tp_local_dims(dims, tp: int):
    """One tp rank's slot geometry from the (tp-rounded) global dims
    (``executor.tp_local_dims``): ``(w_dims, b_widths, xs_widths,
    mask_widths)`` — its W band (``(o/tp, i)`` at even, column-parallel
    slots, ``(o, i/tp)`` at odd, row-parallel ones), its bias band
    (``o/tp`` everywhere: row biases are scattered, never replicated), and
    the widths of the stashed inputs (full at column slots, a shard at row
    slots) and masks (a shard at column slots, full at row slots). At tp = 1
    the global dims."""
    w_dims = [(o // tp, i) if l % 2 == 0 else (o, i // tp) for l, (o, i) in enumerate(dims)]
    b_widths = [o // tp for o, _ in dims]
    xs_widths = [i if l % 2 == 0 else i // tp for l, (_, i) in enumerate(dims)]
    mask_widths = [o // tp if l % 2 == 0 else o for l, (o, _) in enumerate(dims)]
    return w_dims, b_widths, xs_widths, mask_widths


def tp_allreduce_sites(spec: ModelSpec, tp: int, training: bool = True):
    """The Megatron sums over the tp ranks of one stage pass
    (``executor.tp_allreduce_sites``): ``(fwd_widths, bwd_widths)``, the
    payload widths in execution order — forward, one per row-parallel slot
    plus the closing gather when the last slot is column-parallel;
    backward (training only), one per column-parallel slot. The tp stage
    functions place their ``_rank_sum`` calls at exactly these slots."""
    dims = slot_shapes(spec, tp)
    L = len(dims)
    fwd = [dims[l][0] for l in range(1, L, 2)]
    if (L - 1) % 2 == 0:
        fwd.append(dims[-1][0])
    bwd = [dims[l][1] for l in range(0, L, 2)] if training else []
    return fwd, bwd


def stash_slot_nbytes(spec: ModelSpec, mubatch_size: int, tp: int = 1):
    """Per-slot bytes of each stash ring of one rank
    (``executor.stash_slot_nbytes``): ``"stash"`` (the slots' inputs f32
    and their masks, 1 byte for the relu family and f32 for gelu, at the
    ``tp_local_dims`` widths, and the head logits), ``"xin"`` (one stage
    input) and ``"gstash"`` (per-slot effective output-grads, at the mask
    widths)."""
    dims = slot_shapes(spec, tp)
    _, _, xs_widths, mask_widths = tp_local_dims(dims, tp)
    mask_bytes = 1 if spec.act == "relu" else 4
    mb = mubatch_size
    return {
        "stash": 4 * mb * sum(xs_widths) + mask_bytes * mb * sum(mask_widths)
        + 4 * mb * dims[-1][0],
        "xin": 4 * mb * dims[0][1],
        "gstash": 4 * mb * sum(mask_widths),
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


def stack_params(params_list, spec: ModelSpec, order=None, tp: int = 1):
    """Per-stage ragged params (host numpy) -> per-slot zero-padded stacks
    and flags, all host numpy (``executor.stack_params``):

      stacked = {"W": tuple_l of (S, out_l, in_l), "b": tuple_l of (S, out_l)}
      flags   = {"active": (S, L), "relu": (S, L), "residual": (S, L),
                 "head_mask": (S, out_last)}

    ``relu[r, l]`` is the slot's activation flag (the spec's family, relu
    or gelu), ``residual[r, l]`` the gelu family's skip add (all False for
    the relu family). ``order[r]`` names the model stage stored at stacked
    row ``r`` (identity by default; ``interleave_order`` for virtual
    stages). ``tp`` pads the slot dims to tp multiples; the host layout is
    the full global stack at any tp, so checkpoints do not depend on it."""
    dims = slot_shapes(spec, tp)
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


def tp_band_axis(kind, l):
    """The axis of a stacked ``(S, ...)`` leaf that tp splits into rank
    bands: the rows of a column-parallel (even) slot's W and every bias's
    outputs (1), the columns of a row-parallel (odd) slot's W (2)."""
    return 2 if kind == "W" and l % 2 else 1


def _band_index(mesh, q, shape, kind, l, V):
    """Process ``q``'s index (this one's by default) into a full stacked
    leaf of ``shape`` on a ``ProcessMesh``: its stages' ``V`` rows each
    and, at tp > 1, its tp ranks' band of the leaf's band axis."""
    _, s, t = mesh.ranks(q)
    idx = [slice(s.start * V, s.stop * V)] + [slice(None)] * (len(shape) - 1)
    if mesh.tp > 1:
        ax = tp_band_axis(kind, l)
        w = shape[ax] // mesh.tp
        idx[ax] = slice(t.start * w, t.stop * w)
    return tuple(idx)


def _full_leaf_shape(share_shape, kind, l, mesh, S):
    """The full stacked leaf's shape (``S`` rows) of a process's share
    (every process holds as many tp ranks)."""
    shape = [S] + list(share_shape[1:])
    if mesh.tp > 1:
        ax = tp_band_axis(kind, l)
        shape[ax] = share_shape[ax] * mesh.tp // len(mesh.local_tp)
    return tuple(shape)


def local_leaf(a, kind, l, spec: ModelSpec, mesh):
    """This process's share of one full host stacked leaf on a
    ``ProcessMesh``: its stages' rows and, at tp > 1, its tp ranks' band
    (``local_stacked``)."""
    a = np.asarray(a)
    V = spec.n_stages // mesh.pp
    return np.ascontiguousarray(a[_band_index(mesh, None, a.shape, kind, l, V)])


def local_chunks(full, mesh, q=None):
    """Process ``q``'s share (this one's by default) of a ``(pp*tp,
    dp*chunk)`` ZeRO tensor (the flat or block-cyclic params, gradient or
    state) on a ``ProcessMesh``: its device rows and its dp ranks'
    columns. The whole tensor on any other mesh."""
    if not isinstance(mesh, ProcessMesh):
        return full
    r, d = mesh.device_rows_of(q), mesh.ranks(q)[0]
    csz = full.shape[1] // mesh.dp
    return full[r.start:r.stop, d.start * csz:d.stop * csz]


def stacked_from_shares(shares, mesh, num_chunks=1, spec=None):
    """The inverse of ``local_stacked`` and ``local_chunks``: the full host
    stacked ``{W, b}`` tree from every process's share of it (host numpy,
    in process order) — each a ``{W, b}`` tree of its rows and bands, or
    at ZeRO 3 its ``{"P": ...}`` chunks, which are placed in the
    ``(pp*tp, dp*csz3)`` block-cyclic rows and unflattened (``spec``)."""
    if "P" in shares[0]:
        if spec is None:
            raise ValueError("unflattening ZeRO-3 shards needs the model spec")
        _, csz3 = zero_block_len(spec, mesh)
        full = np.zeros((mesh.pp * mesh.tp, mesh.dp * csz3), np.float32)
        for q, share in enumerate(shares):
            local_chunks(full, mesh, q)[...] = share["P"]
        return zero_block_unflatten_rows(full, spec, mesh)
    full = {}
    for k, l, a in _tree_leaves(shares[0]):
        shape = _full_leaf_shape(a.shape, k, l, mesh, mesh.pp * num_chunks)
        dst = np.zeros(shape, np.float32)
        for q, share in enumerate(shares):
            dst[_band_index(mesh, q, shape, k, l, num_chunks)] = share[k][l]
        full.setdefault(k, []).append(dst)
    return {k: tuple(v) for k, v in full.items()}


def local_stacked(stacked_np, spec: ModelSpec, mesh):
    """This process's share of a full host stacked ``{W, b}`` tree on a
    ``ProcessMesh``: its stages' rows and, at tp > 1, its tp ranks' bands
    of them (the rows of a column slot's W, the columns of a row slot's,
    the outputs of every bias: what a JAX device holds under
    ``stacked_param_specs``). The whole tree on any other mesh."""
    if not isinstance(mesh, ProcessMesh):
        return stacked_np
    out = {"W": [], "b": []}
    for k, l, a in _tree_leaves(stacked_np):
        out[k].append(local_leaf(a, k, l, spec, mesh))
    return {k: tuple(v) for k, v in out.items()}


def init_stacked(spec: ModelSpec, mesh, order=None):
    """The deterministic init, stacked in ``order`` at the mesh's tp:
    ``(stacked tensors on the mesh's device, host flags)``. On a
    ``ProcessMesh`` the tensors are this process's share
    (``local_stacked``; every process builds the same init); the flags
    stay whole."""
    stacked, flags = stack_params(init_model(spec), spec, order=order, tp=mesh_tp(mesh))
    return put_stacked(local_stacked(stacked, spec, mesh), mesh.device), flags


# ---------------------------------------------------------------------------
# ZeRO-1: the flat layout (host numpy; the JAX package's helpers)
# ---------------------------------------------------------------------------
#
# ZeRO-1 shards the optimizer update over dp: the replicas' gradients are
# summed into the padded flat layout, dp rank d updates columns [d*csz,
# (d+1)*csz) with its state shard, and the updated chunks are gathered back
# into the stacked params. Flat layout per device row: every W slot (V, o,
# i) then every b slot (V, o), each the device's tp shard, flattened and
# zero-padded to a dp multiple. The rows are the (pp, tp) devices in
# pp-major, tp-minor order: row s*tp + t is pp rank s's tp rank t (one row
# per pp rank at tp = 1). Each 'params' state part (momentum's velocity,
# Adam's m and v) is one (pp*tp, dp*csz) tensor — the JAX global array's
# shape: column block d is dp rank d's shard; 'scalar' parts (Adam's t)
# stay 0-d.


def stacked_flat_len(spec: ModelSpec, pp: int, tp: int = 1) -> int:
    """Per-device flattened param count of the stacked layout (every W slot
    then every b slot, V virtual rows each, the device's tp shard of each)
    — the one definition of the flat layout's size
    (``executor.stacked_flat_len``); it shrinks by exactly tp."""
    dims = slot_shapes(spec, tp)
    V = spec.n_stages // pp
    return sum(V * o * i // tp for o, i in dims) + sum(V * (o // tp) for o, _ in dims)


def zero1_flat_len(spec: ModelSpec, mesh):
    """(flat_len, chunk_size): the per-device flattened param count and
    the padded per-dp-rank chunk size."""
    flat = stacked_flat_len(spec, mesh.pp, mesh_tp(mesh))
    return flat, -(-flat // mesh.dp)


def _zero1_device_rows(spec, mesh):
    """The flat layout's row iteration: ``(row_index, stage_slice,
    tp_rank)`` per (pp, tp) device in pp-major, tp-minor order, the V
    stacked rows of its pp rank."""
    tp = mesh_tp(mesh)
    V = spec.n_stages // mesh.pp
    for d in range(mesh.pp):
        for t in range(tp):
            yield d * tp + t, slice(d * V, (d + 1) * V), t


def _zero1_flatten_rows(stacked_np, spec, mesh):
    """Host: stacked ``{W, b}`` (numpy, leading axis S) -> ``(pp*tp,
    flat_len)``, each row one device's flat view: its V stage rows and, at
    tp > 1, its column or row band of each W slot and its band of each b
    slot."""
    tp = mesh_tp(mesh)
    dims = slot_shapes(spec, tp)
    rows = [None] * (mesh.pp * tp)
    for r, sl, t in _zero1_device_rows(spec, mesh):
        parts = []
        for l, (o, i) in enumerate(dims):
            w = np.asarray(stacked_np["W"][l][sl])
            if tp > 1:
                o_s, i_s = o // tp, i // tp
                if l % 2 == 0:
                    w = w[:, t * o_s : (t + 1) * o_s, :]
                else:
                    w = w[:, :, t * i_s : (t + 1) * i_s]
            parts.append(np.ascontiguousarray(w).reshape(-1))
        for l, (o, _) in enumerate(dims):
            b = np.asarray(stacked_np["b"][l][sl])
            if tp > 1:
                o_s = o // tp
                b = b[:, t * o_s : (t + 1) * o_s]
            parts.append(np.ascontiguousarray(b).reshape(-1))
        rows[r] = np.concatenate(parts)
    return np.stack(rows)


def _zero1_unflatten_rows(arr, spec, mesh):
    """Host inverse of ``_zero1_flatten_rows``: ``(pp*tp, >= flat_len)`` ->
    stacked ``{W, b}`` numpy, the full global slabs (every device row
    writes its shard back)."""
    tp = mesh_tp(mesh)
    dims = slot_shapes(spec, tp)
    V = spec.n_stages // mesh.pp
    Ws = [np.zeros((spec.n_stages, o, i), np.float32) for o, i in dims]
    bs = [np.zeros((spec.n_stages, o), np.float32) for o, _ in dims]
    for r, sl, t in _zero1_device_rows(spec, mesh):
        off = 0
        for l, (o, i) in enumerate(dims):
            o_s, i_s = o // tp, i // tp
            if tp == 1:
                n = V * o * i
                Ws[l][sl] = arr[r, off : off + n].reshape(V, o, i)
            elif l % 2 == 0:
                n = V * o_s * i
                Ws[l][sl, t * o_s : (t + 1) * o_s, :] = arr[r, off : off + n].reshape(V, o_s, i)
            else:
                n = V * o * i_s
                Ws[l][sl, :, t * i_s : (t + 1) * i_s] = arr[r, off : off + n].reshape(V, o, i_s)
            off += n
        for l, (o, _) in enumerate(dims):
            o_s = o // tp
            n = V * o_s
            bs[l][sl, t * o_s : (t + 1) * o_s] = arr[r, off : off + n].reshape(V, o_s)
            off += n
    return {"W": tuple(Ws), "b": tuple(bs)}


def _zero1_check_state(opt, csz):
    """The flat layout needs each 'params' state part to come out of
    ``opt.init(chunk)`` as one chunk-shaped zeros tensor and each 'scalar'
    part 0-d; anything the ``state_layout()`` protocol does not describe is
    refused in the JAX package's words."""
    probe = opt.init(torch.zeros((csz,), dtype=torch.float32))
    parts, scalars = split_state(opt, probe)
    for key, leaf in parts.items():
        if not (
            isinstance(leaf, torch.Tensor)
            and tuple(leaf.shape) == (csz,)
            and not bool(torch.any(leaf != 0))
        ):
            raise ValueError(
                f"zero1: state part {key!r} of {type(opt).__name__} is not a "
                "zeros-initialized chunk mirror — its state_layout() does "
                "not match its init()"
            )
    for key, leaf in scalars.items():
        if leaf.dim() != 0:
            raise ValueError(
                f"zero1: state part {key!r} of {type(opt).__name__} is "
                "declared 'scalar' but is not 0-d"
            )
    return parts, scalars


def _zero_state(opt, mesh, width, rows_of=None):
    """A ZeRO state dict on the mesh's device: one ``(pp*tp, width)``
    float32 tensor per 'params' part (``rows_of(key)`` gives its host rows,
    zeros otherwise) and a 0-d tensor per 'scalar' part (``rows_of(key)``
    its value, the init's otherwise); ``()`` for a stateless optimizer."""
    if is_stateless(opt):
        return ()
    parts, scalars = _zero1_check_state(opt, width // mesh.dp)
    n_rows = mesh.pp * mesh_tp(mesh)
    if isinstance(mesh, ProcessMesh):
        if rows_of is not None:
            raise ValueError(
                "a ZeRO state from the logical form on a process mesh: slice "
                "this process's device rows and dp ranks' columns of the full "
                "state instead"
            )
        # this process's chunks: its (stage, tp) device rows, its dp ranks'
        # columns
        n_rows = len(mesh.device_rows)
        width = len(mesh.local_dp) * (width // mesh.dp)
    state = {}
    for key in parts:
        host = np.zeros((n_rows, width), np.float32)
        if rows_of is not None:
            host[:, : rows_of(key).shape[1]] = rows_of(key)
        state[key] = torch.from_numpy(host).to(mesh.device)
    for key, leaf in scalars.items():
        value = np.float32(rows_of(key) if rows_of is not None else float(leaf))
        state[key] = torch.tensor(value, dtype=torch.float32, device=mesh.device)
    return state


def zero1_init_state(opt, spec: ModelSpec, mesh):
    """The initial ZeRO-1 optimizer state: one ``(pp*tp, dp*chunk)`` zeros
    tensor per 'params' state part, a 0-d tensor per 'scalar' part; ``()``
    for a stateless optimizer. On a ``ProcessMesh``, this process's chunks
    only: ``(its device rows, its dp ranks * chunk)``."""
    _, csz = zero1_flat_len(spec, mesh)
    return _zero_state(opt, mesh, mesh.dp * csz)


def _logical_state(state, opt, spec, mesh, order, unflatten):
    """A ZeRO state dict -> the logical ``{"parts", "scalars"}`` form
    (``unflatten``: host rows -> stacked ``{W, b}``); None when stateless."""
    if isinstance(state, tuple) and state == ():
        return None
    parts, scalars = {}, {}
    for key, kind in opt.state_layout().items():
        if kind == "params":
            stacked = unflatten(_host(state[key]))
            parts[key] = unstack_params(stacked, spec, order=order)
        else:
            scalars[key] = float(state[key])
    return {"parts": parts, "scalars": scalars}


def zero1_state_to_logical(state, opt, spec: ModelSpec, mesh, order=None):
    """ZeRO-1 state dict -> ``{"parts": {key: ragged per-stage list},
    "scalars": {key: float}}`` mirroring params (the layout-independent
    checkpoint form); None for stateless state."""
    flat, _ = zero1_flat_len(spec, mesh)
    return _logical_state(
        state, opt, spec, mesh, order,
        lambda a: _zero1_unflatten_rows(a[:, :flat], spec, mesh),
    )


def _zero1_state_rows(logical_part, spec, mesh, order):
    """Stack one logical state part and flatten it into the flat rows."""
    stacked, _ = stack_params(logical_part, spec, order=order, tp=mesh_tp(mesh))
    return _zero1_flatten_rows(stacked, spec, mesh)


def zero1_state_from_logical(logical, opt, spec: ModelSpec, mesh, order=None):
    """Inverse of ``zero1_state_to_logical``: the logical form -> the ZeRO-1
    state dict on the mesh's device (None -> the initial state)."""
    if logical is None:
        return zero1_init_state(opt, spec, mesh)
    _, csz = zero1_flat_len(spec, mesh)

    def rows_of(key):
        if key in logical["parts"]:
            return _zero1_state_rows(logical["parts"][key], spec, mesh, order)
        return logical["scalars"][key]

    return _zero_state(opt, mesh, mesh.dp * csz, rows_of)


# ---------------------------------------------------------------------------
# ZeRO-2/3: the block-cyclic per-slot shard layout over dp (host numpy)
# ---------------------------------------------------------------------------
#
# The higher stages make the shard layout PER LAYER SLOT instead of per flat
# vector: every slot (V rows of sz elements, the device's tp-local shard;
# W slots then b slots, the flat layout's order) pads each row to dp*k
# columns (k = ceil(sz/dp)) and deals column block d to dp rank d. Rank d's
# shard is the concatenation over slots of its (V, k) blocks, v-major: csz3
# = sum over slots of V*k. One row's gradient then lands in ONE (k,) segment
# of every rank's shard, which is what lets the sync run per tick.
#
# ZeRO-2: params replicated (the stacked {W, b}), gradients reduce-scattered
# into this layout, optimizer state sharded in it. The anchor program sums
# each tick's slot gradients over the replicas and adds them into a
# persistent shard carry (microbatch-outer: bitwise ZeRO-1 only at
# mubatches = 1); a bucketed run keeps the replicas' full-slab accumulators
# and scatters their sum at the tail (bitwise ZeRO-1 at any microbatch
# count). ZeRO-3: params AT REST in this layout ({"P": (pp*tp, dp*csz3)});
# each tick rebuilds the active chunk's slot rows from the shards (at tp > 1
# every tp rank's, into the chunk's global rows), uses them and drops them;
# its sync is the anchor ZeRO-2 tree, so it is bitwise it.


class ZeroSlot(NamedTuple):
    """One layer slot's geometry in the block-cyclic dp-shard layout."""

    kind: str  # "W" | "b"
    layer: int  # slot index within its kind
    rows: int  # V virtual chunk rows
    shape: tuple  # per-row tp-local shape: (o, i) W band or (o,) b band
    sz: int  # elements per row = prod(shape)
    k: int  # per-dp-rank columns = ceil(sz / dp)
    off: int  # start within a rank's csz3 block (cumulative V*k)
    flat_off: int  # start within the flat layout (cumulative V*sz)


def zero_block_slots(spec: ModelSpec, pp: int, dp: int, tp: int = 1):
    """(slots, csz3): the per-slot block-cyclic geometry and the per-rank
    shard length, over each slot's tp-local shape (``tp_local_dims``); slot
    order is the flat layout's, so ``flat_off`` walks ``stacked_flat_len``
    exactly."""
    w_dims, b_widths, _, _ = tp_local_dims(slot_shapes(spec, tp), tp)
    V = spec.n_stages // pp
    slots = []
    off = flat_off = 0
    for kind, shapes in (("W", w_dims), ("b", [(w,) for w in b_widths])):
        for l, shape in enumerate(shapes):
            sz = int(np.prod(shape))
            k = -(-sz // dp)
            slots.append(ZeroSlot(kind, l, V, tuple(shape), sz, k, off, flat_off))
            off += V * k
            flat_off += V * sz
    return tuple(slots), off


def zero_block_len(spec: ModelSpec, mesh):
    """(flat_len, csz3): the flat per-pp-row param count and the
    block-cyclic per-dp-rank shard length."""
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp, mesh_tp(mesh))
    return slots[-1].flat_off + slots[-1].rows * slots[-1].sz, csz3


def _zb_scatter_rows(g2d, dp, k):
    """(V, sz) slot rows -> the (dp, V*k) per-rank column-block deal: pad
    each row to dp*k, deal column block d to output row d."""
    V, sz = g2d.shape
    pad = np.pad(g2d, ((0, 0), (0, dp * k - sz)))
    return pad.reshape(V, dp, k).transpose(1, 0, 2).reshape(dp, V * k)


def _zb_unscatter_rows(mat, V, k, sz):
    """(dp, V*k) -> (V, sz): the inverse of ``_zb_scatter_rows``."""
    dp = mat.shape[0]
    return mat.reshape(dp, V, k).transpose(1, 0, 2).reshape(V, dp * k)[:, :sz]


def _zero_block_rows_from_flat(flat_rows, slots, dp, csz3):
    """Host: flat rows (n_rows, >= flat_len) -> block-cyclic rows (n_rows,
    dp*csz3); columns [d*csz3, (d+1)*csz3) are rank d's shard."""
    n_rows = flat_rows.shape[0]
    out = np.zeros((n_rows, dp * csz3), np.float32)
    for s in slots:
        seg = flat_rows[:, s.flat_off : s.flat_off + s.rows * s.sz]
        for r in range(n_rows):
            mat = _zb_scatter_rows(np.asarray(seg[r], np.float32).reshape(s.rows, s.sz), dp, s.k)
            for d in range(dp):
                a = d * csz3 + s.off
                out[r, a : a + s.rows * s.k] = mat[d]
    return out


def _zero_flat_from_block_rows(block_rows, slots, dp, csz3, flat):
    """Host inverse of ``_zero_block_rows_from_flat``."""
    n_rows = block_rows.shape[0]
    out = np.zeros((n_rows, flat), np.float32)
    for s in slots:
        for r in range(n_rows):
            mat = np.stack(
                [block_rows[r, d * csz3 + s.off : d * csz3 + s.off + s.rows * s.k] for d in range(dp)]
            )
            full = _zb_unscatter_rows(mat, s.rows, s.k, s.sz)
            out[r, s.flat_off : s.flat_off + s.rows * s.sz] = full.reshape(-1)
    return out


def zero_block_flatten_rows(stacked_np, spec, mesh):
    """Host: stacked ``{W, b}`` (numpy) -> ``(pp*tp, dp*csz3)``
    block-cyclic rows, the ZeRO-3 at-rest param layout."""
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp, mesh_tp(mesh))
    return _zero_block_rows_from_flat(
        _zero1_flatten_rows(stacked_np, spec, mesh), slots, mesh.dp, csz3
    )


def zero_block_unflatten_rows(arr, spec, mesh):
    """Host inverse: ``(pp*tp, dp*csz3)`` -> stacked ``{W, b}`` numpy."""
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp, mesh_tp(mesh))
    flat = stacked_flat_len(spec, mesh.pp, mesh_tp(mesh))
    return _zero1_unflatten_rows(
        _zero_flat_from_block_rows(np.asarray(arr, np.float32), slots, mesh.dp, csz3, flat),
        spec, mesh,
    )


def zero_block_init_state(opt, spec: ModelSpec, mesh):
    """The initial ZeRO-2/3 optimizer state: ``zero1_init_state`` with the
    block-cyclic ``dp*csz3`` columns (on a ``ProcessMesh`` this process's
    device rows and dp ranks' columns)."""
    _, csz3 = zero_block_len(spec, mesh)
    return _zero_state(opt, mesh, mesh.dp * csz3)


def zero_block_state_to_logical(state, opt, spec: ModelSpec, mesh, order=None):
    """ZeRO-2/3 state dict -> the logical ``{"parts", "scalars"}`` form;
    None for stateless state."""
    return _logical_state(
        state, opt, spec, mesh, order, lambda a: zero_block_unflatten_rows(a, spec, mesh)
    )


def zero_block_state_from_logical(logical, opt, spec: ModelSpec, mesh, order=None):
    """Inverse: the logical form -> the ZeRO-2/3 state dict on the mesh's
    device (None -> the initial state)."""
    if logical is None:
        return zero_block_init_state(opt, spec, mesh)
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp, mesh_tp(mesh))

    def rows_of(key):
        if key in logical["parts"]:
            rows = _zero1_state_rows(logical["parts"][key], spec, mesh, order)
            return _zero_block_rows_from_flat(rows, slots, mesh.dp, csz3)
        return logical["scalars"][key]

    return _zero_state(opt, mesh, mesh.dp * csz3, rows_of)


def zero_params_at_rest(stacked_np, spec, mesh):
    """The ZeRO-3 params at rest on the mesh's device: ``{"P": (pp*tp,
    dp*csz3)}`` from a full host stacked ``{W, b}`` tree; on a
    ``ProcessMesh`` this process's shard, its device rows and its dp ranks'
    columns."""
    rows = local_chunks(zero_block_flatten_rows(stacked_np, spec, mesh), mesh)
    return {"P": torch.from_numpy(np.ascontiguousarray(rows)).to(mesh.device)}


# ---------------------------------------------------------------------------
# The ZeRO data movers on the device (every rank's shard at once)
# ---------------------------------------------------------------------------


def _tree_leaves(tree):
    """``(kind, slot, leaf)`` of a stacked ``{W, b}`` tree: every W slot
    then every b slot, the flat layout's order."""
    return [("W", l, a) for l, a in enumerate(tree["W"])] + [
        ("b", l, a) for l, a in enumerate(tree["b"])
    ]


def _rank_view(a, kind, l, P, tp):
    """A stacked leaf ``(P*V, o[, i])`` as every (pp, tp) device's shard: a
    ``(P, tp, V) + local shape`` view (strided at tp > 1; a column slot's
    rank t holds rows ``t*o/tp..``, a row slot's columns ``t*i/tp..``, a
    bias its ``o/tp`` band)."""
    V = a.shape[0] // P
    if kind == "b":
        return a.view(P, V, tp, a.shape[1] // tp).permute(0, 2, 1, 3)
    o, i = a.shape[1:]
    if l % 2 == 0:
        return a.view(P, V, tp, o // tp, i).permute(0, 2, 1, 3, 4)
    return a.view(P, V, o, tp, i // tp).permute(0, 3, 1, 2, 4)


def _global_shape(s, tp):
    """A ZeRO slot's global per-row shape from its tp-local one."""
    if s.kind == "b":
        return (s.shape[0] * tp,)
    o, i = s.shape
    return (o * tp, i) if s.layer % 2 == 0 else (o, i * tp)


def _flat_rows(tree, P, width, tp=1):
    """A stacked ``{W, b}`` tree -> its ``(pp*tp, width)`` flat rows on the
    device (every W slot then every b slot per device row, each its tp
    shard, zero-padded)."""
    vec = torch.cat(
        [_rank_view(a, k, l, P, tp).reshape(P * tp, -1) for k, l, a in _tree_leaves(tree)], dim=1
    )
    return _fit(vec, width)


def _unflat_rows(vec, like, tp=1):
    """Flat rows -> stacked tensors shaped as ``like``'s leaves (at tp = 1
    views of ``vec`` where the layout allows, else new tensors)."""
    P, out, off = vec.shape[0] // tp, {"W": [], "b": []}, 0
    for k, l, a in _tree_leaves(like):
        n = a.numel() // (P * tp)
        seg = vec[:, off : off + n]
        if tp == 1:
            new = seg.reshape(a.shape)
        else:
            new = torch.empty_like(a)
            view = _rank_view(new, k, l, P, tp)
            view.copy_(seg.reshape(view.shape))
        out[k].append(new)
        off += n
    return {k: tuple(v) for k, v in out.items()}


def _unflat_rows_into(vec, tree, tp=1):
    """The all-gather of ZeRO-1: flat rows copied back into ``tree``'s
    stacked tensors, in place (a device row's gathered flat vector on the
    census)."""
    if A.active is not None:
        A.active.note("all_gather", "zero1_gather", A.nbytes(vec) // vec.shape[0])
    P, off = vec.shape[0] // tp, 0
    for k, l, a in _tree_leaves(tree):
        n = a.numel() // (P * tp)
        view = _rank_view(a, k, l, P, tp)
        view.copy_(vec[:, off : off + n].reshape(view.shape))
        off += n


def _deal(tree, slots, P, dp, tp=1):
    """A stacked ``{W, b}`` tree -> its block-cyclic ``(pp*tp, dp*csz3)``
    rows: per slot, each device row's shard padded to dp*k and its column
    block d dealt to rank d (column block d of the result is rank d's
    shard). Each slot is copied straight into its strided place: the only
    full-size tensor made is the result (and, at tp > 1, one slot's rank
    shards at a time)."""
    R = P * tp
    csz3 = slots[-1].off + slots[-1].rows * slots[-1].k
    leaves = _tree_leaves(tree)
    a0 = leaves[0][2]
    out = torch.empty((R, dp, csz3), dtype=a0.dtype, device=a0.device)
    for s, (k, l, a) in zip(slots, leaves):
        rows = _fit(_rank_view(a, k, l, P, tp).reshape(R, s.rows, s.sz), dp * s.k)
        dst = out[:, :, s.off : s.off + s.rows * s.k].view(R, dp, s.rows, s.k)
        dst.copy_(rows.view(R, s.rows, dp, s.k).transpose(1, 2))
    return out.view(R, -1)


def _undeal_slot(rows, s, R, dp):
    """One slot's ``(pp*tp, V, sz)`` values out of block-cyclic rows (a
    strided view of a fresh gather)."""
    seg = rows.view(R, dp, -1)[:, :, s.off : s.off + s.rows * s.k]
    full = seg.reshape(R, dp, s.rows, s.k).transpose(1, 2).reshape(R, s.rows, dp * s.k)
    return full[:, :, : s.sz]


def _undeal(rows, slots, P, dp, tp=1):
    """Block-cyclic rows -> a new stacked ``{W, b}`` tree (the ZeRO-3 eval
    view)."""
    out = {"W": [], "b": []}
    for s in slots:
        new = rows.new_empty((P * s.rows,) + _global_shape(s, tp))
        view = _rank_view(new, s.kind, s.layer, P, tp)
        view.copy_(_undeal_slot(rows, s, P * tp, dp).reshape(view.shape))
        out[s.kind].append(new)
    return {k: tuple(v) for k, v in out.items()}


def _undeal_into(rows, slots, tree, P, dp, tp=1):
    """The all-gather of ZeRO-2: block-cyclic rows copied back into
    ``tree``'s stacked tensors, in place (a device row's gathered rows on
    the census)."""
    if A.active is not None:
        A.active.note("all_gather", "zero2_gather", A.nbytes(rows) // (P * tp))
    for s, (k, l, a) in zip(slots, _tree_leaves(tree)):
        view = _rank_view(a, k, l, P, tp)
        view.copy_(_undeal_slot(rows, s, P * tp, dp).reshape(view.shape))


def _gather_chunk(pv, slots, s, ck, L, tp=1, comm=None):
    """ZeRO-3's per-tick gather: pp rank ``s``'s chunk ``ck`` slot rows
    rebuilt from every dp rank's shard (``pv``: the ``(rows, dl, csz3)``
    view of the shards held here, ``s`` the stage's index among the held
    stages, ``tp`` the held tp ranks a stage), once for all replicas, at
    tp > 1 every held tp rank's shard placed in the chunk's rows (on a
    process mesh the held ranks' bands). With ``comm`` (a process mesh
    whose dp group spans processes) the held dp ranks' segments of every
    slot go out in one ``all_gather`` over the dp group. Returns ``(Ws,
    bs)`` (one site per tick branch on the census, a rank's gathered chunk
    its bytes)."""
    if A.active is not None:
        A.active.note(
            "all_gather", A.active.here("zero3_gather"),
            4 * sum(sl.sz for sl in slots),
        )
    segs = [pv[s * tp:(s + 1) * tp, :, sl.off + ck * sl.k:sl.off + (ck + 1) * sl.k]
            for sl in slots]
    if comm is not None and comm.size("dp") > 1:
        held = torch.cat(segs, dim=2)  # (tp, dl, sum k)
        full = comm.all_gather(held, "dp").permute(1, 0, 2, 3).reshape(tp, -1, held.shape[2])
        offs = np.cumsum([0] + [sl.k for sl in slots]).tolist()
        segs = [full[:, :, o:o + sl.k] for o, sl in zip(offs, slots)]
    out = []
    for sl, seg in zip(slots, segs):
        if tp == 1:
            out.append(seg.reshape(-1)[: sl.sz].view(sl.shape))
            continue
        shards = seg.reshape(tp, -1)[:, : sl.sz]
        row = seg.new_empty((1,) + _global_shape(sl, tp))
        view = _rank_view(row, sl.kind, sl.layer, 1, tp)
        view.copy_(shards.reshape(view.shape))
        out.append(row[0])
    return out[:L], out[L:]


def _scatter_tick(gzv, slots, L, s, ck, dp, pending, tp=1, comm=None):
    """The per-tick reduce-scatter of ZeRO-2 (anchor) and ZeRO-3: each
    slot's gradient of this tick, already summed over the held replicas in
    replica order (``pending``: slot -> (dW, db), at tp > 1 each stacked
    over the held tp ranks), every device row's shard padded to dp*k and
    added into its dp ranks' segments of the shard carry (``gzv``: the
    ``(rows, dl, csz3)`` view of the carry held here, ``s`` the stage's
    index among the held stages). With ``comm`` (a process mesh whose dp
    group spans processes) each slot's sum is one ``reduce_scatter`` over
    the dp group, this process keeping its dp ranks' segments. One site
    per slot and tick branch on the census, a rank's shard segment its
    bytes."""
    c = A.active
    G = 1 if comm is None else comm.size("dp")
    for l, grads in pending.items():
        for si, g in zip((l, L + l), grads):
            sl = slots[si]
            if c is not None:
                c.note("reduce_scatter", c.here(f"zero_scatter.{si}"), 4 * sl.k)
            a = sl.off + ck * sl.k
            g = _fit(g.reshape(tp, -1), dp * sl.k)
            if G > 1:
                g = comm.reduce_scatter(g.view(tp, G, -1).transpose(0, 1), "dp")
            gzv[s * tp:(s + 1) * tp, :, a:a + sl.k].add_(g.view(tp, -1, sl.k))


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


def _stage_bwd(Ws, active, relu, residual, dims, xs, masks, g, kernel_backend, sink):
    """Backward of one stage through the per-slot stacks: hands each active
    slot's ``(l, dW, db)`` to ``sink`` (which accumulates it into the
    replica's gradient slabs, or holds it for the tick's shard scatter) and
    returns the input gradient. A residual at slot ``l + 1`` adds its
    incoming grad to slot ``l``'s dx (its input fed both the Linear and the
    skip)."""
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
            sink(l, dw, db2)
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


def _stage_bwd_weight(active, xs, g_effs, sink):
    """The deferred half of the split backward (``executor.
    _stage_bwd_weight``): each active slot's ``(dW, db)`` from the stashed
    input and effective output-grad (``ops.linear_grad_weight``, the plain
    unsplit backward's calls), handed to ``sink`` as ``_stage_bwd`` does."""
    for l, on in enumerate(active):
        if on:
            dw, db = ops.linear_grad_weight(g_effs[l], xs[l])
            sink(l, dw, db)


# ---------------------------------------------------------------------------
# The Megatron stage functions (tp > 1)
# ---------------------------------------------------------------------------
#
# The JAX executor's ``_stage_fwd_tp`` .. ``_stage_bwd_tp`` with every tp rank
# of one (d, s) position computed together, slot by slot: a value each rank
# holds a band of is a ``(tp, rows, w/tp)`` stack (rank t at index t), a
# value every rank holds whole (the JAX package's replicated values, the
# same bits on every rank) is one ``(rows, w)`` tensor, and a rank's weights
# are views of the chunk's global slot rows (``_tp_w``/``_tp_b``). Each slot
# runs one batched product over the rank views; each ``psum`` over 'tp' is
# ``_rank_sum``. The ranks a pass computes are a ``TpRanks``: every rank on
# a virtual mesh, and on a process mesh whose tp group spans processes
# only this process's block, whose bands it holds — its products batch over
# those ranks alone, and a sum adds them then all-reduces over the tp group.
# Exactness, as in the JAX package: the sums that reassemble a sharded value
# (an inactive slot's passthrough, the closing gather, the scattered row
# bias) add exact zeros, while the row-parallel forward and the
# column-parallel dx split a contraction over the ranks and so reassociate
# it — the cross-layout class against tp = 1, bitwise only across
# same-layout knobs. The split and combined backward make the same calls
# (``_stage_bwd_tp`` is the literal composition of its halves).


def _tp_w(W, l, tp):
    """Slot ``l``'s rank views of a W row whose bands are ``tp`` ranks'
    (the global row, or a process's held bands): ``(tp, o/tp, i)`` row
    bands at a column-parallel (even) slot, ``(tp, o, i/tp)`` column bands
    at a row-parallel (odd) one."""
    o, i = W.shape
    if l % 2 == 0:
        return W.view(tp, o // tp, i)
    return W.view(o, tp, i // tp).transpose(0, 1)


def _tp_b(b, tp):
    """The rank bands ``(tp, o/tp)`` of a bias row ``(o,)`` of ``tp``
    ranks' bands."""
    return b.view(tp, -1)


class TpRanks(NamedTuple):
    """The tp ranks a Megatron stage pass computes: ``tp`` the mesh's
    degree, ``ranks`` the ranks held here (every rank on a virtual mesh; on
    a ``ProcessMesh`` this process's block), ``comm`` the ``ProcessComm``
    whose tp group holds the others (None when every rank is here)."""

    tp: int
    ranks: range
    comm: object = None

    @property
    def n(self):
        return len(self.ranks)


def _tp_shard(a, tr):
    """The held ranks' width-``w/tp`` slices of a full-width ``(rows, w)``
    value, stacked ``(n, rows, w/tp)`` (exact: column selection)."""
    rows, w = a.shape
    sh = a.reshape(rows, tr.tp, w // tr.tp).transpose(0, 1)
    return sh if tr.n == tr.tp else sh[tr.ranks.start:tr.ranks.stop]


def _tp_scatter(a_sh, full_w, tr):
    """Each held rank's shard at its column offset in a zero full-width
    value: ``(n, rows, w)`` -> ``(n, rows, full_w)``; the rank sum of it
    is the all-gather (each column written by one rank, the others add
    0.0)."""
    n, rows, w = a_sh.shape
    if full_w != tr.tp * w:
        raise ValueError(f"tp scatter of {tr.tp} x {w} columns into {full_w}")
    z = a_sh.new_zeros((n, rows, tr.tp, w))
    held = z[:, :, tr.ranks.start:tr.ranks.stop]
    held.diagonal(dim1=0, dim2=2).copy_(a_sh.permute(1, 2, 0))
    return z.view(n, rows, full_w)


def _rank_sum(parts, site, tr):
    """The psum over 'tp': the held ranks' ``(n, ...)`` values added in
    rank order, ((p_0 + p_1) + p_2) + ..., then, when the group spans
    processes (``tr.comm``), one ``all_reduce`` over the tp group.
    ``site``: its place in the stage pass, for the census (one rank's
    value its bytes)."""
    c = A.active
    if c is not None:
        c.note("all_reduce", c.here(site), A.nbytes(parts) // parts.shape[0])
    out = functools.reduce(torch.add, parts.unbind(0))
    if tr.comm is not None:
        out = tr.comm.all_reduce(out, "tp")
    return out


def _stage_fwd_tp(Ws, bs, active, relu, residual, dims, x, act, tr):
    """The Megatron forward of one stage (``executor._stage_fwd_tp``) over
    the ranks ``tr`` holds (``Ws``/``bs``: their bands of the slot rows).
    Returns ``(out, xs, masks)``: the stage output at full width, and per
    active slot its input as the wgrad contracts it (full at column slots,
    the rank stack at row slots) and its mask as the dgrad masks it (the
    rank stack at column slots, full after the sum at row slots); None at
    inactive slots. An inactive column slot passes the ranks' shards of the
    fitted activation on, an inactive row slot scatters them back through
    its sum; a trailing column slot (odd slot count) closes with the
    full-width gather. Gelu family: the residual adds sit at row slots,
    after the sum."""
    n = tr.n
    L = len(dims)
    xs, masks = [None] * L, [None] * L
    x_prev = None
    for l, (o, i) in enumerate(dims):
        if l % 2 == 0:  # column-parallel: full input, every rank's band out
            x_l = _fit(x, i)
            x_prev = x_l
            if not active[l]:
                x = _tp_shard(_fit(x_l, o), tr)
                continue
            z = torch.matmul(x_l, _tp_w(Ws[l], l, n).transpose(1, 2))
            z = z + _tp_b(bs[l], n).unsqueeze(1)
            xs[l] = x_l
        else:  # row-parallel: the rank stack in, one rank sum, full out
            if not active[l]:
                x = _rank_sum(_fit(_tp_scatter(x, i, tr), o), f"tp.fwd.{l}", tr)
                continue
            part = torch.matmul(x, _tp_w(Ws[l], l, n).transpose(1, 2))
            bias = _tp_scatter(_tp_b(bs[l], n).unsqueeze(1), o, tr)
            z = _rank_sum(part + bias, f"tp.fwd.{l}", tr)
            xs[l] = x
        if act == "gelu":
            masks[l] = ops.gelu_grad_mult(z) if relu[l] else None
            y = ops.gelu(z) if relu[l] else z
            if l % 2 == 1 and residual[l]:
                y = y + _fit(x_prev, o)
        else:
            masks[l] = z > 0
            y = ops.relu(z) if relu[l] else z
        x = y
    if L % 2 == 1:
        # the trailing column slot left the output as rank bands
        x = _rank_sum(_tp_scatter(x, dims[-1][0], tr), f"tp.fwd.{L}", tr)
    return x, xs, masks


def _stage_bwd_input_tp(Ws, active, relu, residual, dims, masks, g, tr):
    """The dgrad chain of the Megatron backward
    (``executor._stage_bwd_input_tp``): the split B-input, and the first
    half of the combined backward. Returns ``(dx, g_effs)``, the full input
    gradient and each active slot's effective output-grad in its mask's
    representation. Column slots sum their rank partials of dx; gelu's
    residual grads land there, after the sum."""
    n = tr.n
    L = len(dims)
    g_effs = [None] * L
    g_prev = None
    if L % 2 == 1:
        # the trailing column slot consumes each rank's band of the grad
        g = _tp_shard(_fit(g, dims[-1][0]), tr)
    for l in reversed(range(L)):
        o, i = dims[l]
        if l % 2 == 0:  # column-parallel: rank-stack g, summed full dx
            if active[l]:
                g_effs[l] = _g_eff(g, masks[l], relu[l])
                part = torch.matmul(g_effs[l], _tp_w(Ws[l], l, n))
            else:
                part = _fit(_tp_scatter(g, o, tr), i)
            g = _rank_sum(part, f"tp.bwd.{l}", tr)
            if l + 1 < L and residual[l + 1]:
                g = g + _fit(g_prev, i)
        else:  # row-parallel: full g, each rank's dx band
            g_l = _fit(g, o)
            if active[l]:
                g_effs[l] = _g_eff(g_l, masks[l], relu[l])
                g = torch.matmul(g_effs[l], _tp_w(Ws[l], l, n))
            else:
                g = _tp_shard(_fit(g_l, i), tr)
            g_prev = g_l
    return g, g_effs


def _stage_bwd_weight_tp(active, xs, g_effs, tr, sink):
    """The wgrad half of the Megatron backward
    (``executor._stage_bwd_weight_tp``): every product contracts the
    microbatch rows, so it is rank-local. Hands each active slot's ``(l,
    dW, db)`` to ``sink`` as the held ranks' stacks, ``(n,) + w_dims[l]``
    and ``(n, o/tp)``; a row slot's db is each rank's band of the full row
    sum."""
    for l, on in enumerate(active):
        if not on:
            continue
        if l % 2 == 0:
            dw = torch.matmul(g_effs[l].transpose(1, 2), xs[l])
            db = g_effs[l].sum(dim=1)
        else:
            dw = torch.matmul(g_effs[l].T, xs[l])
            db = _tp_shard(g_effs[l].sum(dim=0).unsqueeze(0), tr)[:, 0]
        sink(l, dw, db)


def _stage_bwd_tp(Ws, active, relu, residual, dims, xs, masks, g, tr, sink):
    """The combined Megatron backward: the literal composition of the two
    halves, so the split and combined schedules make the same calls."""
    dx, g_effs = _stage_bwd_input_tp(Ws, active, relu, residual, dims, masks, g, tr)
    _stage_bwd_weight_tp(active, xs, g_effs, tr, sink)
    return dx


# ---------------------------------------------------------------------------
# The two data movers between virtual ranks
# ---------------------------------------------------------------------------


def relay(mailbox, slot, payload, direction):
    """Deliver ``payload`` into slot ``slot`` of the receiving rank's
    mailbox at the end of a tick (the JAX executor's ``ppermute``);
    ``direction`` (``"fwd"``/``"bwd"``) is its census site."""
    if A.active is not None:
        A.active.note("collective_permute", f"relay.{direction}", A.nbytes(payload))
    mailbox[slot] = payload


def dp_sum(trees, ranks=1):
    """The dp gradient SUM (the JAX executor's ``psum`` over ``dp``): the
    replicas' accumulator trees added leaf by leaf in replica order.
    ``ranks``: the (pp, tp) device ranks a tree spans, so the census notes
    one rank's gradient bytes."""
    if A.active is not None:
        A.active.note("all_reduce", "dp_sum", A.tree_nbytes(trees[0]) // ranks)
    return _add_trees(trees)


def _add_trees(trees):
    """Stacked trees added leaf by leaf in list order."""
    return functools.reduce(
        lambda a, b: {k: tuple(x + y for x, y in zip(a[k], b[k])) for k in a}, trees
    )


def _shard_sum(parts, dp):
    """The reduce-scatter of ZeRO-1 and bucketed ZeRO-2: the replicas'
    ``(pp*tp, dp*chunk)`` rows added in replica order; rank ``(row, d)``
    keeps chunk ``d`` (its shard's bytes on the census)."""
    if A.active is not None:
        p0 = parts[0]
        A.active.note("reduce_scatter", "zero_sum", A.nbytes(p0) // (p0.shape[0] * dp))
    return functools.reduce(torch.add, parts)


# ---------------------------------------------------------------------------
# The movers across processes (a ProcessMesh, parallel/multihost.py)
# ---------------------------------------------------------------------------
#
# On a process mesh each process runs its own ranks. A mover whose ends sit
# in one process stays the in-memory mover above; one that crosses becomes
# a collective of the mesh's ``ProcessComm``, each summing this process's
# replicas in replica order first. Every process builds the same lists from
# the same tick tables, so sends and receives pair up by tag.


def _tick_transfers(tab, num_ticks, P, dp):
    """Every relay the tick tables make: per tick, ``[(d, s, n, slot,
    direction)]``, rank ``(d, s)``'s payload into slot ``slot`` of ``(d,
    n)``'s mailbox (the sends ``run_ticks`` makes, in its order)."""
    out = []
    for t in range(num_ticks):
        xs = []
        for s in range(P):
            op = tab["op"][t][s]
            if op == OP_FWD and tab["sf"][t][s] == 1:
                n = (s + 1) % P
                xs += [(d, s, n, tab["inf"][t][n], "fwd") for d in range(dp)]
            elif op == OP_BWD and tab["sb"][t][s] == 1:
                n = (s - 1) % P
                xs += [(d, s, n, tab["inb"][t][n], "bwd") for d in range(dp)]
        out.append(xs)
    return out


def _relay_tag(d, s, direction, P):
    """The point-to-point tag of rank ``(d, s)``'s relay in ``direction``:
    unique among a tick's relays."""
    return 2 * (d * P + s) + (direction == "bwd")


def _relay_across(mesh, sends, incoming, mail, shape):
    """A tick's relays on a process mesh: ``sends`` ``[(d, s, n, slot,
    payload, direction)]`` from this process's ranks (delivered in memory
    when ``(d, n)`` is its own, else sent), ``incoming`` the tick's ``[(d,
    s, n, slot, direction)]`` from other processes' ranks into its own, all
    in one ``batch_isend_irecv`` (``ProcessComm.exchange``). At tp > 1 a
    relay runs between the same tp ranks of two stages (every tp rank holds
    the stage output whole). ``mail``: direction -> mailboxes; ``shape``:
    a payload's."""
    P, t0 = mesh.pp, mesh.local_tp.start
    out = []
    for d, s, n, slot, payload, direction in sends:
        q = mesh.owner(d, n, t0)
        if q == mesh.process:
            relay(mail[direction][d][n], slot, payload, direction)
            continue
        if A.active is not None:
            A.active.note("collective_permute", f"relay.{direction}", A.nbytes(payload))
        out.append((q, _relay_tag(d, s, direction, P), payload))
    if not out and not incoming:
        return
    recvs = []
    for d, s, n, slot, direction in incoming:
        # the receiving end takes part in the permute, as every device of
        # the JAX executor's ppermute does
        if A.active is not None:
            A.active.note("collective_permute", f"relay.{direction}", 4 * shape[0] * shape[1])
        recvs.append((mesh.owner(d, s, t0), _relay_tag(d, s, direction, P), shape))
    got = mesh.comm.exchange(out, recvs)
    for (d, s, n, slot, direction), payload in zip(incoming, got):
        mail[direction][d][n][slot] = payload


def _all_reduce_tree(tree, comm, axis="dp"):
    """A stacked ``{W, b}`` tree summed over ``axis``'s processes, flattened
    into one payload (elementwise: the bits of a sum per leaf)."""
    if comm.size(axis) == 1:
        return tree
    leaves = [a for k in ("W", "b") for a in tree[k]]
    flat = comm.all_reduce(torch.cat([a.reshape(-1) for a in leaves]), axis)
    out, off = {"W": [], "b": []}, 0
    for k in ("W", "b"):
        for a in tree[k]:
            out[k].append(flat[off:off + a.numel()].view(a.shape))
            off += a.numel()
    return {k: tuple(v) for k, v in out.items()}


def _shard_sum_across(parts, comm, dp):
    """ZeRO-1's reduce-scatter on a process mesh: this process's replicas'
    ``(rows, dp*chunk)`` flat rows added in replica order (``_shard_sum``,
    with its census note), then ``reduce_scatter_tensor`` over the dp
    group, its ``i``-th process receiving the columns of its dp ranks:
    ``(rows, dl*chunk)``."""
    local = _shard_sum(parts, dp)
    G = comm.size("dp")
    return comm.reduce_scatter(local.view(local.shape[0], G, -1).transpose(0, 1), "dp")


def _sq_across(sq, comm, axis, site):
    """A partial sum of squares summed over ``axis``'s processes (the
    global norm's ``psum``; a 0-d payload on the census)."""
    if comm.size(axis) == 1:
        return sq
    if A.active is not None:
        A.active.note("all_reduce", site, 4)
    return comm.all_reduce(sq, axis)


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


def _digest_grids(new_stacked, grads, mesh=None, V=1):
    """The step's digest dict on the stacked layout
    (``executor.make_pipeline_step``'s ``with_digests`` contract): ``(S,
    L)`` grids, stacked row x slot, of the post-update checksums
    (``trainer.row_crcs``; padding is +0.0, whose word is 0, so a row's
    checksum is its logical block's) and L2 norms, and the post-sync
    PRE-clip gradient norms. On a ``ProcessMesh`` of more than one process
    (``V`` chunks a stage; the JAX executor's ``_digest_scatter``) each
    leaf this process holds is first placed in a zero leaf of the full
    stacked shape, so every grid is the one-process grid's reduction over
    the same shape, and the grids are summed by one ``all_reduce`` over
    the pp group and one over the tp group: the exact zeros keep a whole
    row's bits, and a row split into tp bands sums its bands' checksums
    (int64, wrapped mod 2^32 as the row's own) and squares. Left on the
    device."""
    across = isinstance(mesh, ProcessMesh) and mesh.world > 1

    def full(tree):
        if not across:
            return tree
        out = {"W": [], "b": []}
        for k, l, a in _tree_leaves(tree):
            shape = _full_leaf_shape(a.shape, k, l, mesh, mesh.pp * V)
            dst = a.new_zeros(shape)
            dst[_band_index(mesh, None, shape, k, l, V)] = a
            out[k].append(dst)
        return out

    def grid(fn, leaves):
        return torch.stack([fn(a) for a in leaves], dim=1)

    def sq(a):
        return torch.sum((a * a).reshape(a.shape[0], -1), dim=1)

    new_stacked, grads = full(new_stacked), full(grads)
    parts = {
        "crc_w": grid(row_crcs, new_stacked["W"]),
        "crc_b": grid(row_crcs, new_stacked["b"]),
        "pnorm_w": grid(sq, new_stacked["W"]),
        "pnorm_b": grid(sq, new_stacked["b"]),
        "gnorm_w": grid(sq, grads["W"]),
        "gnorm_b": grid(sq, grads["b"]),
    }
    if across:
        comm = mesh.comm
        for key, part in parts.items():
            if A.active is not None and comm.size("pp") * comm.size("tp") > 1:
                A.active.note("all_reduce", "digests", A.nbytes(part))
            part = comm.all_reduce(comm.all_reduce(part, "pp"), "tp")
            parts[key] = part & 0xFFFFFFFF if key.startswith("crc") else part
    return {k: v if k.startswith("crc") else torch.sqrt(v) for k, v in parts.items()}


def _resolve_zero(zero, zero1):
    """The dp stage from ``zero`` and its stage-1 alias ``zero1``, with the
    JAX session's refusals: the one place the alias is resolved (the session
    calls it; the executor and the planners take the stage)."""
    if zero is None:
        return 1 if zero1 else 0
    zero = int(zero)
    if zero not in (0, 1, 2, 3):
        raise ValueError(f"zero must be one of 0/1/2/3, got {zero}")
    if zero1 and zero != 1:
        raise ValueError(
            f"conflicting dp-stage selectors: zero1=True but zero={zero} "
            "— pass only --zero"
        )
    return zero


def _device_of(stacked):
    return stacked["P"].device if "P" in stacked else stacked["W"][0].device


def _apply_sharded(opt, params, grads, opt_state, R, dp):
    """The ZeRO update: ``opt.apply`` on each ``(row, d)`` rank's chunk
    with its state shard (``params``/``grads`` and each 'params' state part
    are ``(R, dp*chunk)`` rows, ``R = pp*tp`` devices; a chunk is a view,
    updated in place). Every rank reads the same 'scalar' parts (Adam's t)
    and writes the same new values back, as the JAX package's replicated
    scalars. Returns the new state (``()`` stays ``()``)."""
    layout = opt.state_layout()
    pv, gv = params.view(R, dp, -1), grads.view(R, dp, -1)
    parts = {k: opt_state[k].view(R, dp, -1) for k, kd in layout.items() if kd == "params"}
    scalars = {k: opt_state[k] for k, kd in layout.items() if kd == "scalar"}
    new_scalars = scalars
    for s in range(R):
        for d in range(dp):
            state = join_state(opt, {k: v[s, d] for k, v in parts.items()}, dict(scalars))
            _, state = opt.apply(pv[s, d], gv[s, d], state)
            new_scalars = split_state(opt, state)[1]
    if not layout:
        return opt_state
    return {**{k: opt_state[k] for k in parts}, **new_scalars}


def make_pipeline_step(mesh, spec: ModelSpec, prog, mubatch_size, opt=None,
                       clip_norm=None, kernel_backend="xla", with_grad_norm=False,
                       with_step_stats=False, with_digests=False, zero=0,
                       grad_bucket_bytes=0):
    """The step executing one ``TickProgram`` over the virtual mesh
    (``executor.make_pipeline_step``).

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
    kernels). A mesh with a tp axis (``mesh_tp(mesh) > 1``) runs the
    Megatron stage functions on the plain backend (pallas is refused, in
    the JAX package's words) over the ``stack_params(..., tp)`` layout; the
    ZeRO layouts then hold ``pp * tp`` device rows.

    ``zero``: the dp-axis ZeRO stage (0-3), the JAX package's tails on the
    virtual mesh. 0: the replicas' full-slab
    accumulators summed by ``dp_sum``. 1: the same accumulators flattened
    per pp row into the padded flat layout, summed over the replicas in
    replica order, each rank's chunk updated with its state shard
    (``zero1_init_state`` layout) and gathered back. 2: the state in the
    block-cyclic layout (``zero_block_init_state``); without a bucket plan
    each backward tick sums its slot gradients over the replicas and adds
    them into a persistent ``(pp, dp*csz3)`` shard carry (no full-slab
    accumulators); bucketed, the zero-1 accumulators are summed at the tail
    and dealt into the shard. 3: stage 2's per-tick sync with
    ``stacked`` at rest as ``{"P": (pp, dp*csz3)}``, each tick rebuilding
    the active chunk's slot rows from it (plain backend only).
    ``grad_bucket_bytes`` > 0: the bucketed sync. On the virtual mesh it is
    the unbucketed replica-order sum (a bucket has no communication to
    overlap; ``gradsync`` keeps the plans), so it is bitwise the anchor at
    stages 0 and 1; at stage 2 it selects the full-slab tail, bitwise
    stage 1.

    Telemetry aux (training only), the JAX executor's outputs:
    ``with_grad_norm`` appends the pre-clip global gradient norm of the
    post-sync gradient (over the shards at zero >= 1); ``with_step_stats``
    (implies it) then the post-update global parameter norm (padded
    entries are exactly zero, so the stacked norms are the logical ones);
    ``with_digests`` (zero <= 1) appends the ``_digest_grids`` dict last.
    All stay on the device.

    On a ``ProcessMesh`` of more than one process (``parallel/
    multihost.py``): ``stacked``/``opt_state`` are this process's rows,
    bands and chunks (``init_stacked``, ``zero1_init_state``,
    ``zero_block_init_state``; at zero 3 its shard, ``zero_params_at_rest``),
    ``x``/``y`` its dp rows (``multihost.shard_batch_for_process``), and
    ``loss``, the norms and the digest grids the mesh's, the same on every
    process; an inference step returns this process's dp rows of the
    predictions."""
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel_backend {kernel_backend!r}")
    zero = int(zero)
    if zero not in (0, 1, 2, 3):
        raise ValueError(f"zero must be one of 0/1/2/3, got {zero}")
    zero1 = zero == 1
    if zero == 3 and kernel_backend == "pallas":
        raise ValueError(
            "zero=3 all-gathers parameter segments inside every tick "
            "branch; the fused pallas flag kernels take whole resident "
            "slots — use kernel_backend='xla' with --zero 3"
        )
    if zero == 3 and grad_bucket_bytes:
        raise ValueError(
            "zero=3 syncs gradients per tick (one reduce-scatter per layer "
            "slot inside the scan); the grad_bucket_bytes knob shapes the "
            "tail sync only and has nothing to bucket at stage 3"
        )
    tp_n = mesh_tp(mesh)
    if tp_n > 1 and kernel_backend == "pallas":
        raise ValueError(
            "tensor parallelism shards each slot's W across the tp axis; "
            "the fused pallas flag kernels compute whole slots — use "
            "kernel_backend='xla' with --tp"
        )
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
    pm = mesh if isinstance(mesh, ProcessMesh) else None
    if pm is not None and pm.world == 1:
        pm = None  # one process owns every rank: the in-memory movers
    P, dp, V = mesh.pp, mesh.dp, prog.num_chunks
    # this process's dp rows, stages and tp ranks (every rank on a virtual
    # mesh)
    local_d = range(dp) if pm is None else pm.local_dp
    local_s = range(P) if pm is None else pm.local_stages
    local_t = range(tp_n) if pm is None else pm.local_tp
    d0, s0, t0 = local_d.start, local_s.start, local_t.start
    dl, pl, ntp = len(local_d), len(local_s), len(local_t)
    Rl = pl * ntp  # the ZeRO layouts' device rows held here, (pp, tp) pp-major
    comm = None if pm is None else pm.comm
    tpr = TpRanks(tp_n, local_t, comm)
    if zero >= 2 and with_digests:
        raise ValueError(
            "with_digests reads the zero1 flat-chunk segment map; the "
            "block-cyclic shard layout of zero>=2 has no flat chunk — "
            "run digests at --zero 1 or below"
        )
    zb_slots = None  # the block-cyclic layout's slots (zero >= 2)
    if zero >= 1:
        if not training:
            if zero1:
                raise ValueError("zero1 applies to training programs only")
            raise ValueError(f"zero={zero} applies to training programs only")
        # a rank's chunk: of the flat layout (stage 1) or its block-cyclic
        # shard (stages 2-3)
        if zero1:
            _, csz = zero1_flat_len(spec, mesh)
        else:
            zb_slots, csz = zero_block_slots(spec, P, dp, tp_n)
        if not is_stateless(opt):
            _zero1_check_state(opt, csz)
    # anchor ZeRO-2 and ZeRO-3 sum each tick's gradients into the persistent
    # per-rank shard carry; every other program keeps the replicas' slabs
    shard_grads = zero == 3 or (zero == 2 and not grad_bucket_bytes)
    act = spec.act
    split_bwd, rec = bool(prog.backward_split), bool(prog.recompute)
    dims = slot_shapes(spec, tp_n)
    L = len(dims)
    D_in, D_out = dims[0][1], dims[-1][0]
    W_rel = relay_width(spec)
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
    if pm is not None:
        # the relays from other processes' ranks into this one's, per tick
        # (between the same tp ranks of two stages), and the head stage (its
        # processes tally the loss)
        incoming = [
            [x for x in xs
             if pm.owner(x[0], x[2], t0) == pm.process != pm.owner(x[0], x[1], t0)]
            for xs in _tick_transfers(tab, prog.num_ticks, P, dp)
        ]
        (head_s,) = {s for row in tab["ih"] for s, h in enumerate(row) if h == 1}
        bucket_plan = None
        if grad_bucket_bytes:
            from shallowspeed_tpu_torch.parallel import gradsync

            bucket_plan = gradsync.plan_buckets(spec, dp, P, grad_bucket_bytes, zero=zero,
                                                tp=tp_n)

    def head_mask_rows(flags, device):
        hm = np.asarray(flags["head_mask"], np.bool_)
        key = (hm.tobytes(), hm.shape, str(device))
        if key not in head_masks:
            rows = torch.from_numpy(hm.copy()).to(device)
            head_masks[key] = [rows[r].reshape(1, -1) for r in range(hm.shape[0])]
        return head_masks[key]

    def run_ticks(stacked, flags, X, Y, dev):
        """Every tick of the program on every rank. Returns the replicas'
        gradient accumulators (or the shard carry) and loss tallies
        (training) or predictions."""
        active = np.asarray(flags["active"]).tolist()
        relu = np.asarray(flags["relu"]).tolist()
        residual = np.asarray(flags["residual"]).tolist()
        hm = head_mask_rows(flags, dev)
        if zero == 3:
            pv = stacked["P"].view(Rl, dl, csz)

            def chunk_weights(s, ck):
                return _gather_chunk(pv, zb_slots, s - s0, ck, L, ntp, comm)
        else:
            Ws = [[w[r] for w in stacked["W"]] for r in range(pl * V)]
            bs = [[b[r] for b in stacked["b"]] for r in range(pl * V)]

            def chunk_weights(s, ck):
                return Ws[(s - s0) * V + ck], bs[(s - s0) * V + ck]
        fwd_mail = [[[None] * (Kf + 1) for _ in range(P)] for _ in range(dp)]
        bwd_mail = [[[None] * (Kb + 1) for _ in range(P)] for _ in range(dp)]
        mail = {"fwd": fwd_mail, "bwd": bwd_mail}
        if training:
            # per rank: the activation stash, the split backward's grad
            # stash and recompute's input stash (lowering-assigned slots,
            # the last one the trash slot)
            stash = [[[None] * (Ks + 1) for _ in range(P)] for _ in range(dp)]
            gstash = [[[None] * (Kg + 1) for _ in range(P)] for _ in range(dp)]
            xin = [[[None] * (Kx + 1) for _ in range(P)] for _ in range(dp)]
            if shard_grads:
                gz = torch.zeros((Rl, dl * csz), dtype=torch.float32, device=dev)
                gzv = gz.view(Rl, dl, csz)
            else:
                acc = [
                    {k: tuple(torch.zeros_like(a) for a in stacked[k]) for k in ("W", "b")}
                    for _ in range(dl)
                ]
            loss = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(dl)]
        else:
            preds = [[None] * (M + 1) for _ in range(dl)]

        def grad_sink(d, r, pending):
            """Where replica ``d``'s slot gradients of row ``r`` go: into
            its slabs, through the rank views (one view of the whole row
            at tp = 1), or into the tick's running sum over the replicas
            (replica order: ((g_0 + g_1) + g_2) ...) for the shard
            scatter."""
            if shard_grads:
                def sink(l, dw, db):
                    db = db.reshape(ntp, -1)
                    if l in pending:
                        dw, db = pending[l][0] + dw, pending[l][1] + db
                    pending[l] = (dw, db)
            else:
                gW = [_tp_w(w[r - s0 * V], l, ntp) for l, w in enumerate(acc[d - d0]["W"])]
                gb = [_tp_b(b[r - s0 * V], ntp) for b in acc[d - d0]["b"]]

                def sink(l, dw, db):
                    gW[l].add_(dw)
                    gb[l].add_(db.reshape(ntp, -1))
            return sink

        def head_or_mail(d, s, t, r, z, mb_r):
            if tab["ih"][t][s] == 1:
                return ops.softmax_mse_head_grad(z, Y[d - d0, mb_r], B_global, valid_mask=hm[r])
            return bwd_mail[d][s][tab["rb"][t][s]]

        for t in range(prog.num_ticks):
            op, mbt = tab["op"][t], tab["mb"][t]
            sends = []  # (d, s, n, slot, payload, direction), delivered at the tick's end
            for s in range(P):
                if op[s] == OP_NOOP or s not in local_s:
                    continue
                if A.active is not None:
                    A.active.branch = _BRANCH.get(op[s])
                mb_i = mbt[s]
                mb_r = min(mb_i, M - 1)
                ck = tab["ck"][t][s]
                r = s * V + ck  # the active chunk's stacked row
                is_head = tab["ih"][t][s] == 1
                load_in = tab["li"][t][s] == 1
                # the chunk's weights, once for every replica (at zero 3 a
                # gather from the shards, dropped after the tick); the
                # split B-weight reads none
                if op[s] != OP_BWD_W:
                    W_r, b_r = chunk_weights(s, ck)
                pending = {}  # slot -> the replicas' summed gradients (shard sync)

                def fwd(x_in):
                    """The one stage-forward call of the forward and the
                    recompute tick (the same calls: recompute's bitwise
                    contract)."""
                    if tp_n > 1:
                        return _stage_fwd_tp(
                            W_r, b_r, active[r], relu[r], residual[r], dims, x_in, act, tpr,
                        )
                    return _stage_fwd(
                        W_r, b_r, active[r], relu[r], residual[r], dims, x_in,
                        kernel_backend, act,
                    )

                for d in local_d:
                    if op[s] == OP_FWD:
                        if load_in:
                            x_in = X[d - d0, mb_r]
                        else:
                            x_in = _fit(fwd_mail[d][s][tab["rf"][t][s]], D_in)
                        out, xs_l, masks_l = fwd(x_in)
                        if training:
                            if rec:
                                # park the stage input only (global stage 0
                                # reloads its microbatch; its slot is trash)
                                xin[d][s][tab["xw"][t][s]] = x_in
                            else:
                                stash[d][s][tab["sw"][t][s]] = (xs_l, masks_l, out)
                            if is_head:
                                p = ops.softmax(out, valid_mask=hm[r])
                                loss[d - d0] = loss[d - d0] + ops.mse_loss(p, Y[d - d0, mb_r], B_global)
                        elif is_head:
                            preds[d - d0][mb_i] = ops.softmax(out, valid_mask=hm[r])
                        if tab["sf"][t][s] == 1:
                            n = (s + 1) % P
                            sends.append((d, s, n, tab["inf"][t][n], _fit(out, W_rel), "fwd"))
                    elif op[s] == OP_RECOMPUTE:
                        # the forward again, from the same input bits through
                        # the same _stage_fwd: the stashed run's residuals
                        xr = tab["xr"][t][s]
                        x_in = X[d - d0, mb_r] if load_in else _fit(xin[d][s][xr], D_in)
                        xin[d][s][xr] = None
                        out, xs_l, masks_l = fwd(x_in)
                        stash[d][s][tab["sw"][t][s]] = (xs_l, masks_l, out)
                    elif op[s] == OP_BWD:
                        if split_bwd:
                            # B-input: peek the stash (the B-weight frees it)
                            _, masks_r, z_r = stash[d][s][tab["sp"][t][s]]
                            g_in = head_or_mail(d, s, t, r, z_r, mb_r)
                            if tp_n > 1:
                                dx, g_effs = _stage_bwd_input_tp(
                                    W_r, active[r], relu[r], residual[r], dims, masks_r,
                                    g_in, tpr,
                                )
                            else:
                                dx, g_effs = _stage_bwd_input(
                                    W_r, active[r], relu[r], residual[r], dims, masks_r, g_in,
                                )
                            gstash[d][s][tab["gw"][t][s]] = g_effs
                        else:
                            sr = tab["sr"][t][s]
                            xs_r, masks_r, z_r = stash[d][s][sr]
                            stash[d][s][sr] = None
                            g_in = head_or_mail(d, s, t, r, z_r, mb_r)
                            if tp_n > 1:
                                dx = _stage_bwd_tp(
                                    W_r, active[r], relu[r], residual[r], dims, xs_r,
                                    masks_r, g_in, tpr, grad_sink(d, r, pending),
                                )
                            else:
                                dx = _stage_bwd(
                                    W_r, active[r], relu[r], residual[r], dims, xs_r,
                                    masks_r, g_in, kernel_backend, grad_sink(d, r, pending),
                                )
                        if tab["sb"][t][s] == 1:
                            n = (s - 1) % P
                            sends.append((d, s, n, tab["inb"][t][n], _fit(dx, W_rel), "bwd"))
                    elif op[s] == OP_BWD_W:
                        sr, gr = tab["sr"][t][s], tab["gr"][t][s]
                        sink = grad_sink(d, r, pending)
                        if tp_n > 1:
                            _stage_bwd_weight_tp(
                                active[r], stash[d][s][sr][0], gstash[d][s][gr], tpr, sink,
                            )
                        else:
                            _stage_bwd_weight(
                                active[r], stash[d][s][sr][0], gstash[d][s][gr], sink,
                            )
                        stash[d][s][sr] = gstash[d][s][gr] = None
                    else:
                        raise ValueError(f"tick {t} stage {s}: op code {op[s]} not ported")
                if pending:
                    _scatter_tick(gzv, zb_slots, L, s - s0, ck, dp, pending, ntp, comm)
            if A.active is not None:
                A.active.branch = None
            if pm is None:
                for d, s, n, slot, payload, direction in sends:
                    relay(mail[direction][d][n], slot, payload, direction)
            else:
                _relay_across(pm, sends, incoming[t], mail, (mb_sz, W_rel))
        if training:
            return (gz if shard_grads else acc), loss
        return preds

    def split(a, width):
        """``(global_batch, dim)`` -> ``(dp, M, mubatch, width)``: replica
        ``d`` takes rows ``[d, d + 1) * M * mubatch`` (``P('dp')``)."""
        if a.shape[0] != dl * M * mb_sz:
            raise ValueError(
                f"expected {dl} x {M} x {mb_sz} = {dl * M * mb_sz} rows, got {a.shape[0]}"
            )
        return _fit(a, width).reshape(dl, M, mb_sz, width)

    def sharded_tail(stacked, opt_state, gsh):
        """ZeRO-1/2/3 after the sync: the norms over the shards, the clip,
        every rank's chunk update and the gather back. Returns (stacked,
        opt_state, gnorm or None)."""
        if pm is not None:
            return _sharded_tail_across(stacked, opt_state, gsh)
        gnorm = None
        if with_grad_norm:
            # the shards partition the dp-summed gradient; padding is zero
            gnorm = torch.sqrt(torch.sum(gsh * gsh))
        if clip_norm is not None:
            gsh = clip_tree(gsh, clip_norm)
        if zero == 3:
            pch = stacked["P"]
        elif zero1:
            pch = _flat_rows(stacked, P, dp * csz, tp_n)
        else:
            pch = _deal(stacked, zb_slots, P, dp, tp_n)
        opt_state = _apply_sharded(opt, pch, gsh, opt_state, Rl, dp)
        if zero1:
            _unflat_rows_into(pch, stacked, tp_n)
        elif zero == 2:
            _undeal_into(pch, zb_slots, stacked, P, dp, tp_n)
        return stacked, opt_state, gnorm

    def _sharded_tail_across(stacked, opt_state, gsh):
        """ZeRO-1/2/3's tail on a process mesh: ``gsh`` holds this
        process's ranks' chunks ``(device rows, dl*chunk)``; the norm's
        squares are summed over every process of the mesh (the processes'
        chunks partition the gradient), each rank's chunk updated with its
        state shard, and at zero 1 and 2 the chunks all-gathered over the
        dp group back into the stacked rows (the flat layout, or the
        block-cyclic one undealt). At zero 3 the params stay at rest as
        this process's shard, updated in place."""
        gnorm = None
        if with_grad_norm or clip_norm is not None:
            sq = _sq_across(torch.sum(gsh * gsh), comm, "mesh", "grad_norm")
            if with_grad_norm:
                gnorm = torch.sqrt(sq)
            if clip_norm is not None:
                gsh = gsh * clip_scale(sq, clip_norm)
        if zero == 3:
            pch = stacked["P"]
        else:
            rows = (_flat_rows(stacked, pl, dp * csz, ntp) if zero1
                    else _deal(stacked, zb_slots, pl, dp, ntp))
            pch = rows.view(Rl, dp, csz)[:, d0:d0 + dl].reshape(Rl, dl * csz)
        opt_state = _apply_sharded(opt, pch, gsh, opt_state, Rl, dl)
        if zero == 3:
            return stacked, opt_state, gnorm
        rows = comm.all_gather(pch, "dp").transpose(0, 1).reshape(Rl, dp * csz)
        if zero1:
            _unflat_rows_into(rows, stacked, ntp)
        else:
            _undeal_into(rows, zb_slots, stacked, pl, dp, ntp)
        return stacked, opt_state, gnorm

    def mesh_loss(loss):
        """The loss on a process mesh: the head stage's processes sum their
        tallies over dp (every tp rank's process holds the same tally), and
        each hands its sum to its pp group."""
        if head_s in local_s:
            if A.active is not None and comm.size("dp") > 1:
                A.active.note("all_reduce", "loss", A.nbytes(loss))
            loss = comm.all_reduce(loss, "dp")
        return comm.broadcast(loss, pm.owner(d0, head_s, t0), "pp")

    def dp_sum_across(acc):
        """Zero 0's sync on a process mesh: this process's replicas summed
        in replica order, then one all-reduce over the dp group, or one a
        planned bucket (``gradsync.psum_bucketed``)."""
        if bucket_plan is None:
            return _all_reduce_tree(dp_sum(acc, ranks=Rl), comm)
        return gradsync.psum_bucketed(_add_trees(acc), bucket_plan, comm)

    def sq_across_model(sq, site):
        """A process's squares summed over one replica's model on a
        process mesh: its pp group, then its tp group (the bands)."""
        return _sq_across(_sq_across(sq, comm, "pp", site), comm, "tp", site)

    def tree_norm_sq(tree):
        """The squares of a stacked tree over every stage and tp band on a
        process mesh (this process's rows and bands, summed over its pp and
        tp groups)."""
        return sq_across_model(tree_sq_sum(tree), "norm")

    if training:

        @spanned("executor.step")
        def step(stacked, flags, opt_state, x, y):
            dev = _device_of(stacked)
            acc, losses = run_ticks(stacked, flags, split(x, D_in), split(y, D_out), dev)
            # loss: the dp sum of the head stage's tallies (psum over dp; the
            # pmax over pp picks the head stage, the only one that tallied)
            loss = functools.reduce(torch.add, losses)
            if pm is not None:
                loss = mesh_loss(loss)
            raw = None
            if zero == 0 and pm is not None:
                grads = dp_sum_across(acc)
                del acc
                raw = grads
                sq = tree_norm_sq(grads) if (with_grad_norm or clip_norm is not None) else None
                gnorm = torch.sqrt(sq) if with_grad_norm else None
                if clip_norm is not None:
                    scale = clip_scale(sq, clip_norm)
                    grads = tree_map(lambda g: g * scale, grads)
                stacked, opt_state = opt.apply(stacked, grads, opt_state)
            elif zero == 0:
                grads = dp_sum(acc, ranks=Rl)
                del acc
                raw = grads
                gnorm = global_norm(grads) if with_grad_norm else None
                if clip_norm is not None:
                    grads = clip_tree(grads, clip_norm)
                stacked, opt_state = opt.apply(stacked, grads, opt_state)
            else:
                if shard_grads:
                    gsh = acc
                else:
                    # each replica's slabs flattened per device row (zero
                    # 1) or dealt into the block-cyclic layout (bucketed
                    # zero 2), then summed in replica order
                    if zero1:
                        parts = [_flat_rows(acc.pop(0), pl, dp * csz, ntp) for _ in range(dl)]
                    else:
                        parts = [_deal(acc.pop(0), zb_slots, pl, dp, ntp) for _ in range(dl)]
                    if pm is None:
                        gsh = _shard_sum(parts, dp)
                    elif bucket_plan is not None:
                        gsh = gradsync.psum_scatter_bucketed(parts, bucket_plan, comm, zb_slots)
                    else:
                        gsh = _shard_sum_across(parts, comm, dp)
                    del parts
                    if with_digests:
                        full = gsh
                        if pm is not None and comm.size("dp") > 1:
                            # the post-sync gradient whole: its norms by row
                            if A.active is not None:
                                A.active.note("all_gather", "digest_gather",
                                              A.nbytes(gsh) // Rl * comm.size("dp"))
                            full = comm.all_gather(gsh, "dp").transpose(0, 1).reshape(Rl, -1)
                        raw = _unflat_rows(full, stacked, ntp)
                stacked, opt_state, gnorm = sharded_tail(stacked, opt_state, gsh)
                del gsh
            outs = (stacked, opt_state, loss)
            if with_grad_norm:
                outs += (gnorm,)
            if with_step_stats:
                if zero == 3:
                    pch = stacked["P"]
                    sq = torch.sum(pch * pch)
                    if pm is not None:
                        sq = _sq_across(sq, comm, "mesh", "norm")
                    outs += (torch.sqrt(sq),)
                elif pm is not None:
                    outs += (torch.sqrt(tree_norm_sq(stacked)),)
                else:
                    outs += (global_norm(stacked),)
            if with_digests:
                outs += (_digest_grids(stacked, raw, pm, V),)
            return outs

        return step

    def infer(stacked, flags, x):
        dev = _device_of(stacked)
        preds = run_ticks(stacked, flags, split(x, D_in), None, dev)
        if pm is None or head_s in local_s:
            out = torch.cat([p for rep in preds for p in rep[:M]], dim=0)
        else:
            out = torch.empty((dl * M * mb_sz, D_out), dtype=torch.float32, device=dev)
        if P > 1 and A.active is not None:
            # the head stage's predictions handed to every pp rank (the JAX
            # executor's psum of preds over pp): one replica's rows
            A.active.note("all_reduce", "preds", A.nbytes(out) // dl)
        if pm is not None:
            # this process's dp rows, from the head stage's process
            out = comm.broadcast(out, pm.owner(d0, head_s, t0), "pp")
        return out

    return infer


def make_pipeline_epoch(mesh, spec, prog, mubatch_size, opt, clip_norm=None,
                        kernel_backend="xla", with_grad_norm=False,
                        with_step_stats=False, with_digests=False, zero=0,
                        grad_bucket_bytes=0):
    """The pipeline train step over every batch of an epoch
    (``executor.make_pipeline_epoch``): ``epoch(stacked, flags, opt_state,
    X, Y) -> (stacked, opt_state, mean_loss)`` over ``X``: ``(num_batches,
    global_batch, in_dim)``, the steps in order, the loss summed from zero
    in batch order and divided by the batch count (the JAX epoch scan's
    order). ``with_grad_norm``/``with_step_stats``/``with_digests`` add the
    sequential trainer's aux dict as a fourth output (``trainer.
    _make_epoch_core``), the digests as ``(num_batches, S, L)`` grids in
    stacked-row order. ``zero``/``grad_bucket_bytes``: the dp
    stage and the sync (``make_pipeline_step``; at stage 3 ``stacked`` is
    the ``{"P"}`` shard layout throughout)."""
    step = make_pipeline_step(
        mesh, spec, prog, mubatch_size, opt, clip_norm=clip_norm,
        kernel_backend=kernel_backend, with_grad_norm=with_grad_norm,
        with_step_stats=with_step_stats, with_digests=with_digests,
        zero=zero, grad_bucket_bytes=grad_bucket_bytes,
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
                      with_grad_norm=False, zero=0, grad_bucket_bytes=0):
    """Epochs of the pipeline epoch (``executor.make_pipeline_run``).

    Without eval: ``run(stacked, flags, opt_state, X, Y, n_epochs) ->
    (stacked, opt_state, losses[n_epochs])``. With ``eval_prog`` (an
    ``InferenceSchedule`` program, or ``InterleavedInferenceSchedule`` on an
    interleaved layout, of one microbatch over the padded validation
    rows): ``run(stacked, flags, opt_state, X, Y, vx_padded,
    vy_labels, n_epochs) -> (stacked, opt_state, losses, accs)``, each epoch
    followed by the whole split's argmax accuracy, the count of correct
    predictions over the split's size. ``with_grad_norm`` appends
    ``{"grad_norm": (n_epochs,)}``, each epoch's mean pre-clip global
    gradient norm. ZeRO stages 0-2 and the bucketed sync as
    ``make_pipeline_epoch``; stage 3 is refused, as in the JAX package.

    On a ``ProcessMesh`` of more than one process, ``vx_padded`` is this
    process's dp rows of the padded split (``multihost.
    shard_batch_for_process``) and ``vy_labels`` the whole split's labels:
    each process counts the correct predictions of its dp rows that fall
    inside the split, and one ``all_reduce`` of the count over its dp group
    makes the mesh's count (exact in fp32), the same on every process."""
    if zero == 3:
        raise ValueError(
            "the fused multi-epoch run cannot shard params at rest: its "
            "eval step consumes the full stacked layout every epoch — "
            "use --zero 3 without --fused-run (per-epoch dispatch)"
        )
    epoch = make_pipeline_epoch(
        mesh, spec, prog, mubatch_size, opt, clip_norm=clip_norm,
        kernel_backend=kernel_backend, with_grad_norm=with_grad_norm,
        zero=zero, grad_bucket_bytes=grad_bucket_bytes,
    )
    eval_step = None
    if eval_prog is not None:
        eval_step = make_pipeline_step(
            mesh, spec, eval_prog, eval_mubatch_size, kernel_backend=kernel_backend
        )
    out_dim = spec.out_dim
    pm = mesh if isinstance(mesh, ProcessMesh) and mesh.world > 1 else None

    def accuracy(stacked, flags, vx, vy):
        """The split's accuracy after an epoch: the correct predictions
        counted, over the split's size."""
        preds = eval_step(stacked, flags, vx)[:, :out_dim]
        a = 0
        if pm is not None:
            # this process's dp rows: its block of the padded split
            a = pm.local_dp.start * (vx.shape[0] // len(pm.local_dp))
        m = max(0, min(vy.shape[0] - a, preds.shape[0]))
        hits = torch.argmax(preds[:m], dim=1) == vy[a:a + m]
        count = torch.sum(hits.to(torch.float32))
        if pm is not None:
            if A.active is not None and pm.comm.size("dp") > 1:
                A.active.note("all_reduce", "eval_count", A.nbytes(count))
            count = pm.comm.all_reduce(count, "dp")
        return count / vy.shape[0]

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
                accs.append(accuracy(stacked, flags, vx_padded, vy_labels))
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
