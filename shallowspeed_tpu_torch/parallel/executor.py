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

Masks stay ``torch.bool`` in the stash for the relu family. Stash, grad
stash and input-stash slots are dropped when the lowering frees them, so a
tensor lives as long as the TPU program's buffer slot holds it. The JAX
executor's refusals hold: the pallas backend runs neither the split
backward, recompute nor the gelu family, and the lowering refuses virtual
stages with either of the first two.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from shallowspeed_tpu_torch import cuda_ops, ops
from shallowspeed_tpu_torch.model import ModelSpec, init_model
from shallowspeed_tpu_torch.optimizer import (
    clip_tree,
    global_norm,
    is_stateless,
    join_state,
    split_state,
)
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
# ZeRO-1: the flat layout (host numpy; the JAX package's helpers at tp = 1)
# ---------------------------------------------------------------------------
#
# ZeRO-1 shards the optimizer update over dp: the replicas' gradients are
# summed into the padded flat layout, dp rank d updates columns [d*csz,
# (d+1)*csz) with its state shard, and the updated chunks are gathered back
# into the stacked params. Flat layout per pp row: every W slot (V, o, i)
# then every b slot (V, o), flattened and zero-padded to a dp multiple. Each
# 'params' state part (momentum's velocity, Adam's m and v) is one (pp,
# dp*csz) tensor — the JAX global array's shape: row s is pp rank s, column
# block d dp rank d's shard; 'scalar' parts (Adam's t) stay 0-d.


def _tp1(tp):
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: tensor parallelism is not ported yet; the port's "
            "executor runs a (dp, pp) mesh (ROADMAP.md §A item 3, tp)"
        )


def stacked_flat_len(spec: ModelSpec, pp: int, tp: int = 1) -> int:
    """Per-pp-row flattened param count of the stacked layout (every W slot
    then every b slot, V virtual rows each) — the one definition of the
    flat layout's size (``executor.stacked_flat_len``)."""
    _tp1(tp)
    dims = slot_shapes(spec)
    V = spec.n_stages // pp
    return sum(V * o * i for o, i in dims) + sum(V * o for o, _ in dims)


def zero1_flat_len(spec: ModelSpec, mesh):
    """(flat_len, chunk_size): the per-pp-row flattened param count and
    the padded per-dp-rank chunk size."""
    flat = stacked_flat_len(spec, mesh.pp)
    return flat, -(-flat // mesh.dp)


def _zero1_device_rows(spec, mesh):
    """The flat layout's row iteration: ``(row_index, stage_slice)`` per pp
    rank, its V stacked rows."""
    V = spec.n_stages // mesh.pp
    for d in range(mesh.pp):
        yield d, slice(d * V, (d + 1) * V)


def _zero1_flatten_rows(stacked_np, spec, mesh):
    """Host: stacked ``{W, b}`` (numpy, leading axis S) -> ``(pp,
    flat_len)``, each row one pp rank's flat view."""
    rows = [None] * mesh.pp
    for r, sl in _zero1_device_rows(spec, mesh):
        parts = [np.ascontiguousarray(np.asarray(w)[sl]).reshape(-1) for w in stacked_np["W"]]
        parts += [np.ascontiguousarray(np.asarray(b)[sl]).reshape(-1) for b in stacked_np["b"]]
        rows[r] = np.concatenate(parts)
    return np.stack(rows)


def _zero1_unflatten_rows(arr, spec, mesh):
    """Host inverse of ``_zero1_flatten_rows``: ``(pp, >= flat_len)`` ->
    stacked ``{W, b}`` numpy."""
    dims = slot_shapes(spec)
    V = spec.n_stages // mesh.pp
    Ws = [np.zeros((spec.n_stages, o, i), np.float32) for o, i in dims]
    bs = [np.zeros((spec.n_stages, o), np.float32) for o, _ in dims]
    for r, sl in _zero1_device_rows(spec, mesh):
        off = 0
        for l, (o, i) in enumerate(dims):
            n = V * o * i
            Ws[l][sl] = arr[r, off : off + n].reshape(V, o, i)
            off += n
        for l, (o, _) in enumerate(dims):
            n = V * o
            bs[l][sl] = arr[r, off : off + n].reshape(V, o)
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
    """A ZeRO state dict on the mesh's device: one ``(pp, width)`` float32
    tensor per 'params' part (``rows_of(key)`` gives its host rows, zeros
    otherwise) and a 0-d tensor per 'scalar' part (``rows_of(key)`` its
    value, the init's otherwise); ``()`` for a stateless optimizer."""
    if is_stateless(opt):
        return ()
    parts, scalars = _zero1_check_state(opt, width // mesh.dp)
    state = {}
    for key in parts:
        host = np.zeros((mesh.pp, width), np.float32)
        if rows_of is not None:
            host[:, : rows_of(key).shape[1]] = rows_of(key)
        state[key] = torch.from_numpy(host).to(mesh.device)
    for key, leaf in scalars.items():
        value = np.float32(rows_of(key) if rows_of is not None else float(leaf))
        state[key] = torch.tensor(value, dtype=torch.float32, device=mesh.device)
    return state


def zero1_init_state(opt, spec: ModelSpec, mesh):
    """The initial ZeRO-1 optimizer state: one ``(pp, dp*chunk)`` zeros
    tensor per 'params' state part, a 0-d tensor per 'scalar' part; ``()``
    for a stateless optimizer."""
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
    stacked, _ = stack_params(logical_part, spec, order=order)
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
# vector: every slot (V rows of sz elements; W slots then b slots, the flat
# layout's order) pads each row to dp*k columns (k = ceil(sz/dp)) and deals
# column block d to dp rank d. Rank d's shard is the concatenation over
# slots of its (V, k) blocks, v-major: csz3 = sum over slots of V*k. One
# row's gradient then lands in ONE (k,) segment of every rank's shard, which
# is what lets the sync run per tick.
#
# ZeRO-2: params replicated (the stacked {W, b}), gradients reduce-scattered
# into this layout, optimizer state sharded in it. The anchor program sums
# each tick's slot gradients over the replicas and adds them into a
# persistent shard carry (microbatch-outer: bitwise ZeRO-1 only at
# mubatches = 1); a bucketed run keeps the replicas' full-slab accumulators
# and scatters their sum at the tail (bitwise ZeRO-1 at any microbatch
# count). ZeRO-3: params AT REST in this layout ({"P": (pp, dp*csz3)}); each
# tick rebuilds the active chunk's slot rows from the shard, uses them and
# drops them; its sync is the anchor ZeRO-2 tree, so it is bitwise it.


class ZeroSlot(NamedTuple):
    """One layer slot's geometry in the block-cyclic dp-shard layout."""

    kind: str  # "W" | "b"
    layer: int  # slot index within its kind
    rows: int  # V virtual chunk rows
    shape: tuple  # per-row shape: (o, i) for W, (o,) for b
    sz: int  # elements per row = prod(shape)
    k: int  # per-dp-rank columns = ceil(sz / dp)
    off: int  # start within a rank's csz3 block (cumulative V*k)
    flat_off: int  # start within the flat layout (cumulative V*sz)


def zero_block_slots(spec: ModelSpec, pp: int, dp: int, tp: int = 1):
    """(slots, csz3): the per-slot block-cyclic geometry and the per-rank
    shard length; slot order is the flat layout's, so ``flat_off`` walks
    ``stacked_flat_len`` exactly."""
    _tp1(tp)
    dims = slot_shapes(spec)
    V = spec.n_stages // pp
    slots = []
    off = flat_off = 0
    for kind, shapes in (("W", dims), ("b", [(o,) for o, _ in dims])):
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
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp)
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
    """Host: stacked ``{W, b}`` (numpy) -> ``(pp, dp*csz3)`` block-cyclic
    rows, the ZeRO-3 at-rest param layout."""
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp)
    return _zero_block_rows_from_flat(
        _zero1_flatten_rows(stacked_np, spec, mesh), slots, mesh.dp, csz3
    )


def zero_block_unflatten_rows(arr, spec, mesh):
    """Host inverse: ``(pp, dp*csz3)`` -> stacked ``{W, b}`` numpy."""
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp)
    flat = stacked_flat_len(spec, mesh.pp)
    return _zero1_unflatten_rows(
        _zero_flat_from_block_rows(np.asarray(arr, np.float32), slots, mesh.dp, csz3, flat),
        spec, mesh,
    )


def zero_block_init_state(opt, spec: ModelSpec, mesh):
    """The initial ZeRO-2/3 optimizer state: ``zero1_init_state`` with the
    block-cyclic ``dp*csz3`` columns."""
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
    slots, csz3 = zero_block_slots(spec, mesh.pp, mesh.dp)

    def rows_of(key):
        if key in logical["parts"]:
            rows = _zero1_state_rows(logical["parts"][key], spec, mesh, order)
            return _zero_block_rows_from_flat(rows, slots, mesh.dp, csz3)
        return logical["scalars"][key]

    return _zero_state(opt, mesh, mesh.dp * csz3, rows_of)


def zero_params_at_rest(stacked_np, spec, mesh):
    """The ZeRO-3 params at rest on the mesh's device: ``{"P": (pp,
    dp*csz3)}`` from a host stacked ``{W, b}`` tree."""
    rows = zero_block_flatten_rows(stacked_np, spec, mesh)
    return {"P": torch.from_numpy(rows).to(mesh.device)}


# ---------------------------------------------------------------------------
# The ZeRO data movers on the device (every rank's shard at once)
# ---------------------------------------------------------------------------


def _flat_rows(tree, P, width):
    """A stacked ``{W, b}`` tree -> its ``(pp, width)`` flat rows on the
    device (every W slot then every b slot per pp row, zero-padded)."""
    vec = torch.cat([w.reshape(P, -1) for w in tree["W"]] + [b.reshape(P, -1) for b in tree["b"]], dim=1)
    return _fit(vec, width)


def _unflat_rows(vec, like):
    """Flat rows -> new stacked tensors shaped as ``like``'s leaves."""
    P, out, off = vec.shape[0], {}, 0
    for key in ("W", "b"):
        leaves = []
        for a in like[key]:
            n = a.numel() // P
            leaves.append(vec[:, off : off + n].reshape(a.shape))
            off += n
        out[key] = tuple(leaves)
    return out


def _unflat_rows_into(vec, tree):
    """The all-gather of ZeRO-1: flat rows copied back into ``tree``'s
    stacked tensors, in place."""
    P, off = vec.shape[0], 0
    for key in ("W", "b"):
        for a in tree[key]:
            n = a.numel() // P
            a.view(P, n).copy_(vec[:, off : off + n])
            off += n


def _deal(tree, slots, P, dp):
    """A stacked ``{W, b}`` tree -> its block-cyclic ``(pp, dp*csz3)`` rows:
    per slot, each row padded to dp*k and its column block d dealt to rank
    d (column block d of the result is rank d's shard). Each slot is copied
    straight into its strided place: the only full-size tensor made is the
    result."""
    leaves = list(tree["W"]) + list(tree["b"])
    csz3 = slots[-1].off + slots[-1].rows * slots[-1].k
    out = torch.empty((P, dp, csz3), dtype=leaves[0].dtype, device=leaves[0].device)
    for s, a in zip(slots, leaves):
        rows = _fit(a.reshape(P, s.rows, s.sz), dp * s.k)
        dst = out[:, :, s.off : s.off + s.rows * s.k].view(P, dp, s.rows, s.k)
        dst.copy_(rows.view(P, s.rows, dp, s.k).transpose(1, 2))
    return out.view(P, -1)


def _undeal_slot(rows, s, P, dp):
    """One slot's ``(pp, V, sz)`` values out of block-cyclic rows (a
    strided view of a fresh gather)."""
    seg = rows.view(P, dp, -1)[:, :, s.off : s.off + s.rows * s.k]
    full = seg.reshape(P, dp, s.rows, s.k).transpose(1, 2).reshape(P, s.rows, dp * s.k)
    return full[:, :, : s.sz]


def _undeal(rows, slots, P, dp):
    """Block-cyclic rows -> a new stacked ``{W, b}`` tree (the ZeRO-3 eval
    view)."""
    out = {"W": [], "b": []}
    for s in slots:
        out[s.kind].append(_undeal_slot(rows, s, P, dp).reshape((P * s.rows,) + s.shape))
    return {k: tuple(v) for k, v in out.items()}


def _undeal_into(rows, slots, tree, P, dp):
    """The all-gather of ZeRO-2: block-cyclic rows copied back into
    ``tree``'s stacked tensors, in place."""
    for s, a in zip(slots, list(tree["W"]) + list(tree["b"])):
        a.view(P, s.rows, s.sz).copy_(_undeal_slot(rows, s, P, dp))


def _gather_chunk(pv, slots, s, ck, L):
    """ZeRO-3's per-tick gather: pp rank ``s``'s chunk ``ck`` slot rows
    rebuilt from every dp rank's shard (``pv``: the ``(pp, dp, csz3)``
    view), once for all replicas; returns ``(Ws, bs)``."""
    out = []
    for sl in slots:
        a = sl.off + ck * sl.k
        full = pv[s, :, a : a + sl.k].reshape(-1)
        out.append(full[: sl.sz].view(sl.shape))
    return out[:L], out[L:]


def _scatter_tick(gzv, slots, L, s, ck, dp, pending):
    """The per-tick reduce-scatter of ZeRO-2 (anchor) and ZeRO-3: each
    slot's gradient of this tick, already summed over the replicas in
    replica order (``pending``: slot -> (dW, db)), padded to dp*k and added
    into every rank's segment of the shard carry (``gzv``: the ``(pp, dp,
    csz3)`` view)."""
    for l, grads in pending.items():
        for sl, g in zip((slots[l], slots[L + l]), grads):
            a = sl.off + ck * sl.k
            gzv[s, :, a : a + sl.k].add_(_fit(g.reshape(-1), dp * sl.k).view(dp, sl.k))


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


def _apply_sharded(opt, params, grads, opt_state, P, dp):
    """The ZeRO update: ``opt.apply`` on each ``(s, d)`` rank's chunk with
    its state shard (``params``/``grads`` and each 'params' state part are
    ``(pp, dp*chunk)`` rows; a chunk is a view, updated in place). Every
    rank reads the same 'scalar' parts (Adam's t) and writes the same new
    values back, as the JAX package's replicated scalars. Returns the new
    state (``()`` stays ``()``)."""
    layout = opt.state_layout()
    pv, gv = params.view(P, dp, -1), grads.view(P, dp, -1)
    parts = {k: opt_state[k].view(P, dp, -1) for k, kd in layout.items() if kd == "params"}
    scalars = {k: opt_state[k] for k, kd in layout.items() if kd == "scalar"}
    new_scalars = scalars
    for s in range(P):
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
    (``executor.make_pipeline_step`` at tp = 1).

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
    All stay on the device."""
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
    P, dp, V = mesh.pp, mesh.dp, prog.num_chunks
    if zero >= 2 and with_digests:
        raise ValueError(
            "with_digests reads the zero1 flat-chunk segment map; the "
            "block-cyclic shard layout of zero>=2 has no flat chunk — "
            "run digests at --zero 1 or below"
        )
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
            zb_slots, csz = zero_block_slots(spec, P, dp)
        if not is_stateless(opt):
            _zero1_check_state(opt, csz)
    # anchor ZeRO-2 and ZeRO-3 sum each tick's gradients into the persistent
    # per-rank shard carry; every other program keeps the replicas' slabs
    shard_grads = zero == 3 or (zero == 2 and not grad_bucket_bytes)
    act = spec.act
    split_bwd, rec = bool(prog.backward_split), bool(prog.recompute)
    dims = slot_shapes(spec)
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
            pv = stacked["P"].view(P, dp, csz)

            def chunk_weights(s, ck):
                return _gather_chunk(pv, zb_slots, s, ck, L)
        else:
            Ws = [[w[r] for w in stacked["W"]] for r in range(P * V)]
            bs = [[b[r] for b in stacked["b"]] for r in range(P * V)]

            def chunk_weights(s, ck):
                return Ws[s * V + ck], bs[s * V + ck]
        fwd_mail = [[[None] * (Kf + 1) for _ in range(P)] for _ in range(dp)]
        bwd_mail = [[[None] * (Kb + 1) for _ in range(P)] for _ in range(dp)]
        if training:
            # per rank: the activation stash, the split backward's grad
            # stash and recompute's input stash (lowering-assigned slots,
            # the last one the trash slot)
            stash = [[[None] * (Ks + 1) for _ in range(P)] for _ in range(dp)]
            gstash = [[[None] * (Kg + 1) for _ in range(P)] for _ in range(dp)]
            xin = [[[None] * (Kx + 1) for _ in range(P)] for _ in range(dp)]
            if shard_grads:
                gz = torch.zeros((P, dp * csz), dtype=torch.float32, device=dev)
                gzv = gz.view(P, dp, csz)
            else:
                acc = [
                    {k: tuple(torch.zeros_like(a) for a in stacked[k]) for k in ("W", "b")}
                    for _ in range(dp)
                ]
            loss = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(dp)]
        else:
            preds = [[None] * (M + 1) for _ in range(dp)]

        def grad_sink(d, r, pending):
            """Where replica ``d``'s slot gradients of row ``r`` go: into
            its slabs, or into the tick's running sum over the replicas
            (replica order: ((g_0 + g_1) + g_2) ...) for the shard scatter."""
            if shard_grads:
                def sink(l, dw, db):
                    db = db.reshape(-1)
                    if l in pending:
                        dw, db = pending[l][0] + dw, pending[l][1] + db
                    pending[l] = (dw, db)
            else:
                gW = [w[r] for w in acc[d]["W"]]
                gb = [b[r] for b in acc[d]["b"]]

                def sink(l, dw, db):
                    gW[l].add_(dw)
                    gb[l].add_(db.reshape(-1))
            return sink

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
                    return _stage_fwd(
                        W_r, b_r, active[r], relu[r], residual[r], dims, x_in,
                        kernel_backend, act,
                    )

                for d in range(dp):
                    if op[s] == OP_FWD:
                        if load_in:
                            x_in = X[d, mb_r]
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
                        out, xs_l, masks_l = fwd(x_in)
                        stash[d][s][tab["sw"][t][s]] = (xs_l, masks_l, out)
                    elif op[s] == OP_BWD:
                        if split_bwd:
                            # B-input: peek the stash (the B-weight frees it)
                            _, masks_r, z_r = stash[d][s][tab["sp"][t][s]]
                            dx, g_effs = _stage_bwd_input(
                                W_r, active[r], relu[r], residual[r], dims, masks_r,
                                head_or_mail(d, s, t, r, z_r, mb_r),
                            )
                            gstash[d][s][tab["gw"][t][s]] = g_effs
                        else:
                            sr = tab["sr"][t][s]
                            xs_r, masks_r, z_r = stash[d][s][sr]
                            stash[d][s][sr] = None
                            dx = _stage_bwd(
                                W_r, active[r], relu[r], residual[r], dims, xs_r, masks_r,
                                head_or_mail(d, s, t, r, z_r, mb_r), kernel_backend,
                                grad_sink(d, r, pending),
                            )
                        if tab["sb"][t][s] == 1:
                            n = (s - 1) % P
                            sends.append((bwd_mail[d][n], tab["inb"][t][n], _fit(dx, W_rel)))
                    elif op[s] == OP_BWD_W:
                        sr, gr = tab["sr"][t][s], tab["gr"][t][s]
                        _stage_bwd_weight(
                            active[r], stash[d][s][sr][0], gstash[d][s][gr],
                            grad_sink(d, r, pending),
                        )
                        stash[d][s][sr] = gstash[d][s][gr] = None
                    else:
                        raise ValueError(f"tick {t} stage {s}: op code {op[s]} not ported")
                if pending:
                    _scatter_tick(gzv, zb_slots, L, s, ck, dp, pending)
            for mailbox, slot, payload in sends:
                relay(mailbox, slot, payload)
        if training:
            return (gz if shard_grads else acc), loss
        return preds

    def split(a, width):
        """``(global_batch, dim)`` -> ``(dp, M, mubatch, width)``: replica
        ``d`` takes rows ``[d, d + 1) * M * mubatch`` (``P('dp')``)."""
        if a.shape[0] != dp * M * mb_sz:
            raise ValueError(
                f"expected {dp} x {M} x {mb_sz} = {dp * M * mb_sz} rows, got {a.shape[0]}"
            )
        return _fit(a, width).reshape(dp, M, mb_sz, width)

    def sharded_tail(stacked, opt_state, gsh):
        """ZeRO-1/2/3 after the sync: the norms over the shards, the clip,
        every rank's chunk update and the gather back. Returns (stacked,
        opt_state, gnorm or None)."""
        gnorm = None
        if with_grad_norm:
            # the shards partition the dp-summed gradient; padding is zero
            gnorm = torch.sqrt(torch.sum(gsh * gsh))
        if clip_norm is not None:
            gsh = clip_tree(gsh, clip_norm)
        if zero == 3:
            pch = stacked["P"]
        elif zero1:
            pch = _flat_rows(stacked, P, dp * csz)
        else:
            pch = _deal(stacked, zb_slots, P, dp)
        opt_state = _apply_sharded(opt, pch, gsh, opt_state, P, dp)
        if zero1:
            _unflat_rows_into(pch, stacked)
        elif zero == 2:
            _undeal_into(pch, zb_slots, stacked, P, dp)
        return stacked, opt_state, gnorm

    if training:

        def step(stacked, flags, opt_state, x, y):
            dev = _device_of(stacked)
            acc, losses = run_ticks(stacked, flags, split(x, D_in), split(y, D_out), dev)
            # loss: the dp sum of the head stage's tallies (psum over dp; the
            # pmax over pp picks the head stage, the only one that tallied)
            loss = functools.reduce(torch.add, losses)
            raw = None
            if zero == 0:
                grads = dp_sum(acc)
                del acc
                raw = grads
                gnorm = global_norm(grads) if with_grad_norm else None
                if clip_norm is not None:
                    grads = clip_tree(grads, clip_norm)
                stacked, opt_state = opt.apply(stacked, grads, opt_state)
            else:
                if shard_grads:
                    gsh = acc
                elif zero1:
                    # each replica's slabs flattened per pp row, then summed
                    # in replica order
                    gvecs = [_flat_rows(acc.pop(0), P, dp * csz) for _ in range(dp)]
                    gsh = functools.reduce(torch.add, gvecs)
                    del gvecs
                    if with_digests:
                        raw = _unflat_rows(gsh, stacked)
                else:
                    # bucketed zero 2: the slabs dealt into the block-cyclic
                    # layout, summed in replica order
                    deals = [_deal(acc.pop(0), zb_slots, P, dp) for _ in range(dp)]
                    gsh = functools.reduce(torch.add, deals)
                    del deals
                stacked, opt_state, gnorm = sharded_tail(stacked, opt_state, gsh)
                del gsh
            outs = (stacked, opt_state, loss)
            if with_grad_norm:
                outs += (gnorm,)
            if with_step_stats:
                if zero == 3:
                    pch = stacked["P"]
                    outs += (torch.sqrt(torch.sum(pch * pch)),)
                else:
                    outs += (global_norm(stacked),)
            if with_digests:
                outs += (_digest_grids(stacked, raw),)
            return outs

        return step

    def infer(stacked, flags, x):
        dev = _device_of(stacked)
        preds = run_ticks(stacked, flags, split(x, D_in), None, dev)
        return torch.cat([p for rep in preds for p in rep[:M]], dim=0)

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
    followed by the whole split's argmax accuracy. ``with_grad_norm``
    appends ``{"grad_norm": (n_epochs,)}``, each epoch's mean pre-clip
    global gradient norm. ZeRO stages 0-2 and the bucketed sync as
    ``make_pipeline_epoch``; stage 3 is refused, as in the JAX package."""
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
