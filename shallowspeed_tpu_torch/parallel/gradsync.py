"""Bucketed gradient synchronization: the port's counterpart of
``shallowspeed_tpu/parallel/gradsync.py``.

The JAX package issues one collective per byte-bounded BUCKET of the
gradient, in backward order (output layer first), instead of one whole-tree
``psum`` at the sync anchor, so XLA can overlap each bucket's communication
with the tail's compute. This module keeps its planning half as it is, pure
host data: ``BucketLeaf``, ``BucketPlan``, the three planners,
``plan_buckets`` and the analytical ``sync_comm_bytes``. The plans feed the
session's ``grad_sync_plan`` record and choose the executor's ZeRO-2 tail.

The emitters, ``psum_bucketed`` and ``psum_scatter_bucketed`` (the JAX
module's ``:270``, ``:293``), run on a process mesh (``parallel/
multihost.py``), where the dp replicas sit in different processes: one
``all_reduce`` (zero 0) or ``reduce_scatter_tensor`` (zero 1 and 2) over
the dp group a planned bucket, in the plan's backward order, each noted on the
program audit's census as its own site. On the virtual mesh every dp
replica's gradient lies on the one device, so a bucket has no
communication to overlap: there the executor runs the unbucketed
replica-order sum, which a per-bucket sum equals bit for bit (both are
elementwise: the JAX module's bitwise contract). At tp > 1 every plan
covers one device's Megatron shards (``executor.tp_local_dims``), so the
dp payload shrinks by tp, as in the JAX package.
"""

import dataclasses
import functools

import torch

from shallowspeed_tpu_torch.observability import program_audit as A

from shallowspeed_tpu_torch.parallel.executor import (
    slot_shapes,
    stacked_flat_len,
    tp_local_dims,
    zero_block_slots,
)


@dataclasses.dataclass(frozen=True)
class BucketLeaf:
    """One gradient leaf of the executor's per-device stacked tree."""

    kind: str  # "W" | "b"
    slot: int  # layer-slot index (executor.slot_shapes order)
    shape: tuple  # per-device stacked shape: (V, o, i) for W, (V, o) for b

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self):
        return 4 * self.size  # f32 gradients


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A static bucketing of one layout's gradient sync.

    ``mode="dp"``: ``buckets`` is a tuple of leaf groups (each a tuple of
    ``BucketLeaf``), in backward order — one flat sum per group.
    ``mode="zero1"``: ``buckets`` is a tuple of ``(start, stop)`` column
    ranges over the per-replica chunk (``dp`` records the replica count
    the ranges were planned for). ``mode="zero2"``: ``buckets`` is a tuple
    of ``(slot_index, start, stop)`` column ranges over one slot's
    ``(dp, V*k)`` block-cyclic matrix (``executor.zero_block_slots``
    order), in backward order."""

    mode: str  # "dp" | "zero1" | "zero2"
    bucket_bytes: int  # the grad_bucket_bytes knob that built the plan
    buckets: tuple
    dp: int = 1  # zero1/zero2: replicas (census result bytes = grad / dp)

    @property
    def num_buckets(self):
        return len(self.buckets)

    def bucket_grad_bytes(self):
        """Per-bucket synced-gradient payload in bytes (what the byte
        budget bounds): the full leaf bytes for DP buckets, ``dp x width``
        scattered columns for ZeRO-1/2 buckets."""
        if self.mode == "dp":
            return [sum(l.nbytes for l in group) for group in self.buckets]
        if self.mode == "zero2":
            return [4 * self.dp * (b - a) for _, a, b in self.buckets]
        return [4 * self.dp * (b - a) for a, b in self.buckets]

    def bucket_census_bytes(self):
        """Per-bucket result bytes of the JAX package's collective: an
        all-reduce returns the full bucket on every device, a
        reduce-scatter 1/dp of it."""
        if self.mode == "dp":
            return self.bucket_grad_bytes()
        if self.mode == "zero2":
            return [4 * (b - a) for _, a, b in self.buckets]
        return [4 * (b - a) for a, b in self.buckets]

    def total_grad_bytes(self):
        return sum(self.bucket_grad_bytes())

    def describe(self):
        """JSON-able plan summary (the ``grad_sync_plan`` record)."""
        return {
            "mode": self.mode,
            "grad_bucket_bytes": int(self.bucket_bytes),
            "num_buckets": self.num_buckets,
            "bucket_grad_bytes": self.bucket_grad_bytes(),
            "bucket_census_bytes": self.bucket_census_bytes(),
            "total_grad_bytes": self.total_grad_bytes(),
        }


def _stacked_leaves(spec, pp, tp=1):
    """The executor's per-device gradient leaves in BACKWARD order: the
    backward finalizes slot L-1 (the output layer) first and computes each
    slot's dW and db together, so the order is [W_{L-1}, b_{L-1}, ...,
    W_0, b_0]. Under tp the leaves are one rank's Megatron shards."""
    dims = slot_shapes(spec, tp)
    w_dims, b_widths, _, _ = tp_local_dims(dims, tp)
    V = spec.n_stages // pp
    leaves = []
    for l in reversed(range(len(dims))):
        o, i = w_dims[l]
        leaves.append(BucketLeaf("W", l, (V, o, i)))
        leaves.append(BucketLeaf("b", l, (V, b_widths[l])))
    return leaves


def plan_dp_buckets(spec, pp, bucket_bytes, tp=1):
    """Greedy byte-bounded bucketing of the stacked gradient tree for the
    plain-DP sum; None when ``bucket_bytes`` is falsy (the anchor sum).
    Backward order is kept; a bucket closes as soon as the next leaf would
    exceed the budget (an oversized leaf gets a bucket of its own — a leaf
    is never split)."""
    if not bucket_bytes:
        return None
    bucket_bytes = int(bucket_bytes)
    buckets, current, current_bytes = [], [], 0
    for leaf in _stacked_leaves(spec, pp, tp):
        if current and current_bytes + leaf.nbytes > bucket_bytes:
            buckets.append(tuple(current))
            current, current_bytes = [], 0
        current.append(leaf)
        current_bytes += leaf.nbytes
    if current:
        buckets.append(tuple(current))
    return BucketPlan(mode="dp", bucket_bytes=bucket_bytes, buckets=tuple(buckets))


def plan_zero1_buckets(spec, dp, pp, bucket_bytes, tp=1):
    """Byte-bounded column ranges over the per-replica chunk of the padded
    flat gradient (each covers ``dp x width`` elements: one width-slice of
    every replica's chunk); None when ``bucket_bytes`` is falsy."""
    if not bucket_bytes:
        return None
    bucket_bytes = int(bucket_bytes)
    csz = -(-stacked_flat_len(spec, pp, tp) // dp)
    width = max(1, bucket_bytes // (4 * dp))
    ranges = tuple((a, min(a + width, csz)) for a in range(0, csz, width))
    return BucketPlan(mode="zero1", bucket_bytes=bucket_bytes, buckets=ranges, dp=int(dp))


def plan_zero2_buckets(spec, dp, pp, bucket_bytes, tp=1):
    """Byte-bounded ``(slot_index, start, stop)`` column ranges over each
    slot's ``(dp, V*k)`` block-cyclic matrix, in backward order (W_l then
    b_l, slot L-1 first); concatenating a slot's ranges in ascending order
    gives its shard segment. None when ``bucket_bytes`` is falsy."""
    if not bucket_bytes:
        return None
    bucket_bytes = int(bucket_bytes)
    slots, _ = zero_block_slots(spec, pp, dp, tp)
    L = len(slots) // 2
    width = max(1, bucket_bytes // (4 * dp))
    buckets = []
    for l in reversed(range(L)):
        for si in (l, L + l):  # W_l then b_l, mirroring _stacked_leaves
            cols = slots[si].rows * slots[si].k
            for a in range(0, cols, width):
                buckets.append((si, a, min(a + width, cols)))
    return BucketPlan(
        mode="zero2", bucket_bytes=bucket_bytes, buckets=tuple(buckets), dp=int(dp)
    )


def plan_buckets(spec, dp, pp, bucket_bytes, zero=0, tp=1):
    """The one layout -> plan dispatch, for a resolved dp stage ``zero``;
    stage 3 has no plan (its sync is per tick; the executor and the session
    refuse buckets there). None when ``bucket_bytes`` is falsy."""
    if zero == 3:
        return None
    if zero == 2:
        return plan_zero2_buckets(spec, dp, pp, bucket_bytes, tp=tp)
    if zero == 1:
        return plan_zero1_buckets(spec, dp, pp, bucket_bytes, tp=tp)
    return plan_dp_buckets(spec, pp, bucket_bytes, tp=tp)


def sync_comm_bytes(spec, dp, pp, plan=None, tp=1, zero=0, mubatches=1, gather_passes=2):
    """The dp-axis leg of the JAX package's analytical comms contract:
    ring-algorithm wire bytes PER DEVICE PER STEP for the gradient sync at
    the resolved ZeRO stage ``zero``, with the bucket plan's per-collective
    breakdown when one is active. Stage 0: one all-reduce of the stacked gradient,
    ``2 (dp-1)/dp x 4*flat``. Stage 1: reduce-scatter + all-gather of the
    padded flat vector (the same total over ``4*csz*dp``). Stage 2: the
    anchor program reduce-scatters per tick into the gradient shard (x
    ``mubatches``) and all-gathers the updated chunk once; a bucketed plan
    keeps stage 1's total over the block-cyclic ``4*csz3*dp``. Stage 3:
    the per-tick reduce-scatter plus ``gather_passes`` param-gather sweeps
    per microbatch. Under tp each device syncs only its Megatron shard, so
    the dp payload shrinks by tp. On the port's virtual mesh the same bytes
    move between ranks' buffers on one device; the multi-card runtime will
    put them on the wire."""
    flat = stacked_flat_len(spec, pp, tp)
    if zero >= 2:
        _, csz3 = zero_block_slots(spec, pp, dp, tp)
        payload = 4 * csz3 * dp  # the per-slot padded block-cyclic deal
        if zero == 3:
            M = int(mubatches)
            passes = int(gather_passes)
            rs_bytes = (dp - 1) / dp * M * payload
            ag_bytes = (dp - 1) / dp * M * passes * payload
            axis = {
                "kind": "reduce_scatter+all_gather",
                "algorithm": "ring",
                "grad_bytes_per_device": M * payload,
                "bytes_per_step_per_device": rs_bytes + ag_bytes,
                "reduce_scatter_bytes_per_step_per_device": rs_bytes,
                "scatter_schedule": "per_tick",
                "scatter_mubatches": M,
                "gather": {
                    "schedule": "per_tick",
                    "passes": passes,
                    "mubatches": M,
                    "bytes_per_step_per_device": ag_bytes,
                },
                "hlo_min_all_gather_ops": passes,
            }
        elif plan is None:
            M = int(mubatches)
            rs_bytes = (dp - 1) / dp * M * payload
            ag_bytes = (dp - 1) / dp * payload
            axis = {
                "kind": "reduce_scatter+all_gather",
                "algorithm": "ring",
                "grad_bytes_per_device": M * payload,
                "bytes_per_step_per_device": rs_bytes + ag_bytes,
                "reduce_scatter_bytes_per_step_per_device": rs_bytes,
                "scatter_schedule": "per_tick",
                "scatter_mubatches": M,
            }
        else:
            axis = {
                "kind": "reduce_scatter+all_gather",
                "algorithm": "ring",
                "grad_bytes_per_device": payload,
                "bytes_per_step_per_device": 2 * (dp - 1) / dp * payload,
            }
    elif zero == 1:
        csz = -(-flat // dp)
        payload = 4 * csz * dp  # the padded flat vector
        axis = {
            "kind": "reduce_scatter+all_gather",
            "algorithm": "ring",
            "grad_bytes_per_device": payload,
            "bytes_per_step_per_device": 2 * (dp - 1) / dp * payload,
        }
    else:
        payload = 4 * flat  # this device's padded stacked gradient
        axis = {
            "kind": "all_reduce",
            "algorithm": "ring",
            "grad_bytes_per_device": payload,
            "bytes_per_step_per_device": 2 * (dp - 1) / dp * payload,
        }
    axis["zero"] = zero
    axis["mode"] = "anchor" if plan is None else "bucketed"
    if plan is not None:
        axis["grad_bucket_bytes"] = int(plan.bucket_bytes)
        axis["num_buckets"] = plan.num_buckets
        axis["bucket_grad_bytes"] = plan.bucket_grad_bytes()
        axis["bucket_census_bytes"] = plan.bucket_census_bytes()
    return axis


def psum_bucketed(tree, plan, comm):
    """Zero 0's bucketed dp sum on a process mesh: one ``all_reduce`` over
    the dp group a bucket of ``plan`` (a ``mode="dp"`` plan), in its
    backward order; each bucket's leaves of ``tree`` (this process's
    stacked gradient, its replicas already summed) flattened into one
    payload and the sum written back in place. Returns ``tree``."""
    for i, group in enumerate(plan.buckets):
        leaves = [tree[leaf.kind][leaf.slot] for leaf in group]
        if A.active is not None:
            A.active.note("all_reduce", f"dp_sum.bucket{i}", sum(leaf.nbytes for leaf in group))
        flat = comm.all_reduce(torch.cat([a.reshape(-1) for a in leaves]), "dp")
        off = 0
        for a in leaves:
            a.copy_(flat[off:off + a.numel()].view(a.shape))
            off += a.numel()
    return tree


def psum_scatter_bucketed(parts, plan, comm, slots=None):
    """Zero 1's and bucketed zero 2's reduce-scatter on a process mesh:
    ``parts``, this process's replicas' ``(rows, dp*chunk)`` gradient rows
    (the padded flat layout, or the block-cyclic deal), summed in replica
    order, then one ``reduce_scatter_tensor`` over the dp group a column
    range of the chunk, in the plan's order: a ``mode="zero1"`` plan's
    ``(a, b)``, or a ``mode="zero2"`` plan's ``(slot, a, b)`` over
    ``slots`` (``executor.zero_block_slots``), slot ``slot``'s columns
    ``[off + a, off + b)``. Every dp rank's range of its chunk goes out
    together. Returns this process's ``(rows, dl*chunk)`` chunk columns."""
    local = functools.reduce(torch.add, parts)
    rows, csz = local.shape[0], local.shape[1] // plan.dp
    if plan.mode == "zero2":
        ranges = [(slots[si].off + a, slots[si].off + b) for si, a, b in plan.buckets]
    else:
        ranges = list(plan.buckets)
    view = local.view(rows, comm.size("dp"), -1, csz)  # (rows, G, dl, chunk)
    out = torch.empty((rows, view.shape[2], csz), dtype=local.dtype, device=local.device)
    for i, (a, b) in enumerate(ranges):
        if A.active is not None:
            A.active.note("reduce_scatter", f"zero_sum.bucket{i}", 4 * (b - a))
        out[:, :, a:b] = comm.reduce_scatter(view[:, :, :, a:b].permute(1, 0, 2, 3), "dp")
    return out.view(rows, -1)
