"""Bucketed gradient synchronization: the port's counterpart of
``shallowspeed_tpu/parallel/gradsync.py``.

The JAX package issues one collective per byte-bounded BUCKET of the
gradient, in backward order (output layer first), instead of one whole-tree
``psum`` at the sync anchor, so XLA can overlap each bucket's communication
with the tail's compute. This module keeps its planning half as it is, pure
host data at tp = 1: ``BucketLeaf``, ``BucketPlan``, the three planners,
``plan_buckets`` and the analytical ``sync_comm_bytes``. The plans feed the
session's ``grad_sync_plan`` record and choose the executor's ZeRO-2 tail.

The JAX module's emitters have no counterpart here. On the port's virtual
mesh every dp replica's gradient lies on the one device, so a bucket has no
communication to overlap, and a per-bucket sum is the unbucketed
replica-order sum sliced and put back together (both are elementwise: the
JAX module's bitwise contract). The executor runs the unbucketed sum; the
multi-card runtime, where a bucket is a real collective, brings per-bucket
emission back (ROADMAP.md §A item 7). tp > 1 raises
``NotImplementedError``: the port's mesh has no tp axis yet (ROADMAP.md §A
item 3).
"""

import dataclasses

from shallowspeed_tpu_torch.parallel.executor import (
    _tp1,
    slot_shapes,
    stacked_flat_len,
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
    W_0, b_0]."""
    _tp1(tp)
    dims = slot_shapes(spec)
    V = spec.n_stages // pp
    leaves = []
    for l in reversed(range(len(dims))):
        o, i = dims[l]
        leaves.append(BucketLeaf("W", l, (V, o, i)))
        leaves.append(BucketLeaf("b", l, (V, o)))
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
    per microbatch. On the port's virtual mesh the same bytes move between
    ranks' buffers on one device; the multi-card runtime will put them on
    the wire."""
    _tp1(tp)
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
