"""The port's bucketed gradient sync (shallowspeed_tpu_torch/parallel/
gradsync.py) against the JAX package's.

- The planning half is a copy: every plan's ``describe()`` and
  ``sync_comm_bytes`` equal the JAX module's, for the three modes, several
  budgets and layouts (V = 1 and 2).
- Every plan partitions its layout: each leaf in one bucket (stage 0),
  the column ranges tile the chunk (stage 1) and each slot (stage 2).
- A bucketed step is bitwise the anchor step at every budget (stages 0
  and 1; bucketed stage 2 is stage 1), and the device layouts the sums
  run in equal the host helpers.
- tp > 1: the plans, ``sync_comm_bytes`` and the layout lengths equal the
  JAX module's over one rank's Megatron shards, and the device layouts and
  sums hold at pp*tp device rows.
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as JM
from shallowspeed_tpu.parallel import gradsync as jgs
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel import gradsync as tgs
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)  # tests/test_zero23.py's
FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
B = 64
BUDGETS = (1, 256, 4096, 65536, 1 << 22)
LAYOUTS = [(2, 2, 1), (2, 2, 2), (4, 2, 1), (2, 4, 1)]  # (dp, pp, V)


def _specs(sizes, pp, V):
    return (
        JM.make_model_spec(sizes, pp * V, B),
        TM.make_model_spec(sizes, pp * V, B),
    )


@pytest.mark.parametrize("zero", [0, 1, 2])
@pytest.mark.parametrize("dp,pp,V", LAYOUTS)
def test_plans_equal_jax(zero, dp, pp, V):
    jspec, tspec = _specs(SIZES, pp, V)
    for budget in BUDGETS:
        jp = jgs.plan_buckets(jspec, dp, pp, budget, zero=zero)
        tp = tgs.plan_buckets(tspec, dp, pp, budget, zero=zero)
        assert tp.describe() == jp.describe()
        if zero == 0:
            assert [[(l.kind, l.slot, l.shape) for l in g] for g in tp.buckets] == [
                [(l.kind, l.slot, l.shape) for l in g] for g in jp.buckets
            ]
        else:
            assert tp.buckets == jp.buckets
    assert tgs.plan_buckets(tspec, dp, pp, 0, zero=zero) is None


def test_flagship_plans_and_zero3_has_none():
    jspec, tspec = _specs(FLAGSHIP, 4, 1)
    for zero in (0, 1, 2):
        assert (
            tgs.plan_buckets(tspec, 2, 4, 65536, zero=zero).describe()
            == jgs.plan_buckets(jspec, 2, 4, 65536, zero=zero).describe()
        )
    # stage 3 syncs per tick: no tail plan (the executor and the session
    # refuse a bucket budget there)
    assert tgs.plan_buckets(tspec, 2, 4, 0, zero=3) is None
    assert tgs.plan_buckets(tspec, 2, 4, 1024, zero=3) is None


@pytest.mark.parametrize("dp,pp,V", LAYOUTS)
def test_plans_partition_their_layout(dp, pp, V):
    _, tspec = _specs(SIZES, pp, V)
    mesh = VirtualMesh(dp, pp, "cpu")
    _, csz = TE.zero1_flat_len(tspec, mesh)
    slots, _ = TE.zero_block_slots(tspec, pp, dp)
    leaves = [(l.kind, l.slot) for l in tgs._stacked_leaves(tspec, pp)]
    for budget in BUDGETS:
        p0 = tgs.plan_buckets(tspec, dp, pp, budget, zero=0)
        assert [(l.kind, l.slot) for g in p0.buckets for l in g] == leaves
        assert all(
            len(g) == 1 or sum(l.nbytes for l in g) <= budget for g in p0.buckets
        )
        p1 = tgs.plan_buckets(tspec, dp, pp, budget, zero=1)
        assert p1.buckets[0][0] == 0 and p1.buckets[-1][1] == csz
        assert all(a[1] == b[0] for a, b in zip(p1.buckets, p1.buckets[1:]))
        p2 = tgs.plan_buckets(tspec, dp, pp, budget, zero=2)
        cover = {}
        for si, a, b in p2.buckets:
            assert a == cover.get(si, 0) and b > a
            cover[si] = b
        assert cover == {i: sl.rows * sl.k for i, sl in enumerate(slots)}


@pytest.mark.parametrize("dp,pp,V", LAYOUTS)
def test_sync_comm_bytes_equal_jax(dp, pp, V):
    jspec, tspec = _specs(SIZES, pp, V)
    for zero in (0, 1, 2, 3):
        for budget in (0, 256) if zero < 3 else (0,):
            jp = jgs.plan_buckets(jspec, dp, pp, budget, zero=zero)
            tp = tgs.plan_buckets(tspec, dp, pp, budget, zero=zero)
            for mub in (1, 4):
                assert tgs.sync_comm_bytes(
                    tspec, dp, pp, plan=tp, zero=zero, mubatches=mub
                ) == jgs.sync_comm_bytes(jspec, dp, pp, plan=jp, zero=zero, mubatches=mub)


def test_layout_lengths_equal_jax():
    from shallowspeed_tpu.parallel import executor as JE

    for dp, pp, V in LAYOUTS:
        jspec, tspec = _specs(SIZES, pp, V)
        assert TE.stacked_flat_len(tspec, pp) == JE.stacked_flat_len(jspec, pp)
        js, jc = JE.zero_block_slots(jspec, pp, dp)
        ts, tc = TE.zero_block_slots(tspec, pp, dp)
        assert tc == jc and [tuple(s) for s in ts] == [tuple(s) for s in js]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_plans_and_lengths_equal_jax(tp):
    """At tp > 1 the planners bucket one rank's Megatron shards: plans,
    ``sync_comm_bytes`` and the layout lengths equal the JAX module's, and
    the dp payload is the tp = 1 one's over tp (before the tp rounding)."""
    from shallowspeed_tpu.parallel import executor as JE

    jspec, tspec = _specs(SIZES, 2, 1)
    for zero in (0, 1, 2):
        for budget in (256, 4096):
            tp_plan = tgs.plan_buckets(tspec, 2, 2, budget, zero=zero, tp=tp)
            jp_plan = jgs.plan_buckets(jspec, 2, 2, budget, zero=zero, tp=tp)
            assert tp_plan.describe() == jp_plan.describe()
            assert tgs.sync_comm_bytes(tspec, 2, 2, plan=tp_plan, tp=tp, zero=zero, mubatches=4) == (
                jgs.sync_comm_bytes(jspec, 2, 2, plan=jp_plan, tp=tp, zero=zero, mubatches=4)
            )
    for zero in (0, 1, 2, 3):
        assert tgs.sync_comm_bytes(tspec, 2, 2, tp=tp, zero=zero, mubatches=4) == (
            jgs.sync_comm_bytes(jspec, 2, 2, tp=tp, zero=zero, mubatches=4)
        )
    assert TE.stacked_flat_len(tspec, 2, tp) == JE.stacked_flat_len(jspec, 2, tp)
    ts, tc = TE.zero_block_slots(tspec, 2, 2, tp)
    js, jc = JE.zero_block_slots(jspec, 2, 2, tp)
    assert tc == jc and [tuple(s) for s in ts] == [tuple(s) for s in js]
    # every leaf of a dp plan is one rank's shard
    leaves = [l for g in tgs.plan_dp_buckets(tspec, 2, 4096, tp=tp).buckets for l in g]
    assert 4 * sum(l.size for l in leaves) == 4 * TE.stacked_flat_len(tspec, 2, tp)


def _replica_trees(tspec, dp, seed, tp=1):
    """``dp`` seeded gradient-shaped trees on the stacked layout (padding
    included: the layout movers are data-blind)."""
    gen = torch.Generator().manual_seed(seed)
    dims = TE.slot_shapes(tspec, tp)
    S = tspec.n_stages
    return [
        {
            "W": tuple(torch.randn(S, o, i, generator=gen) for o, i in dims),
            "b": tuple(torch.randn(S, o, generator=gen) for o, _ in dims),
        }
        for _ in range(dp)
    ]


def _step_weights(tspec, mesh, zero, bucket, V):
    """One momentum step of the executor from the seeded init; the
    logical params' bytes."""
    pp, dp = mesh.pp, mesh.dp
    order = TE.interleave_order(pp * V, pp) if V > 1 else None
    sched = TS.InterleavedSchedule if V > 1 else TS.GPipeSchedule
    prog = lower_schedule(sched, 2, pp, virtual=V)
    opt = make_optimizer("momentum", 0.01)
    stacked, flags = TE.init_stacked(tspec, mesh, order=order)
    st = opt.init(stacked) if zero == 0 else (
        TE.zero1_init_state(opt, tspec, mesh) if zero == 1
        else TE.zero_block_init_state(opt, tspec, mesh)
    )
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(B, SIZES[0]).astype(np.float32))
    y = torch.from_numpy(np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, 10, B)])
    step = TE.make_pipeline_step(
        mesh, tspec, prog, B // dp // 2, opt, zero=zero, grad_bucket_bytes=bucket
    )
    stacked = step(stacked, flags, st, x, y)[0]
    layers = TE.unstack_params(stacked, tspec, order=order)
    return b"".join(l[k].tobytes() for s in layers for l in s for k in ("W", "b"))


@pytest.mark.parametrize("dp,pp,V", LAYOUTS)
def test_bucketed_sums_are_bitwise_the_anchor(dp, pp, V):
    """A bucketed step at every budget is bitwise its anchor: stage 0's
    ``dp_sum``, stage 1's flat replica-order sum; bucketed stage 2 (the
    full-slab tail) is stage 1."""
    _, tspec = _specs(SIZES, pp, V)
    mesh = VirtualMesh(dp, pp, "cpu")
    z0 = _step_weights(tspec, mesh, 0, 0, V)
    z1 = _step_weights(tspec, mesh, 1, 0, V)
    assert z0 == z1
    for budget in BUDGETS:
        assert _step_weights(tspec, mesh, 0, budget, V) == z0
        assert _step_weights(tspec, mesh, 1, budget, V) == z1
        assert _step_weights(tspec, mesh, 2, budget, V) == z1


def test_flat_and_dealt_sums_hold_the_anchor():
    """The replicas' slabs summed in the flat (stage 1) and the dealt
    block-cyclic (stage 2) layouts hold ``dp_sum``'s values."""
    dp, pp, V = 2, 2, 2
    _, tspec = _specs(SIZES, pp, V)
    mesh = VirtualMesh(dp, pp, "cpu")
    trees = _replica_trees(tspec, dp, seed=5)
    anchor = TE.dp_sum(trees)
    _, csz = TE.zero1_flat_len(tspec, mesh)
    flat = TE._flat_rows(trees[0], pp, dp * csz) + TE._flat_rows(trees[1], pp, dp * csz)
    slots, _ = TE.zero_block_slots(tspec, pp, dp)
    dealt = TE._deal(trees[0], slots, pp, dp) + TE._deal(trees[1], slots, pp, dp)
    for got in (TE._unflat_rows(flat, anchor), TE._undeal(dealt, slots, pp, dp)):
        assert all(torch.equal(a, b) for k in ("W", "b") for a, b in zip(got[k], anchor[k]))


def test_device_layouts_equal_the_host_helpers():
    """The executor's device-side deal/flatten equal the host helpers the
    checkpoints use (``zero_block_flatten_rows``, ``_zero1_flatten_rows``)."""
    dp, pp, V = 2, 2, 2
    _, tspec = _specs(SIZES, pp, V)
    mesh = VirtualMesh(dp, pp, "cpu")
    (tree,) = _replica_trees(tspec, 1, seed=3)
    host = {k: tuple(a.numpy() for a in tree[k]) for k in ("W", "b")}
    slots, _ = TE.zero_block_slots(tspec, pp, dp)
    np.testing.assert_array_equal(
        TE._deal(tree, slots, pp, dp).numpy(), TE.zero_block_flatten_rows(host, tspec, mesh)
    )
    flat, csz = TE.zero1_flat_len(tspec, mesh)
    np.testing.assert_array_equal(
        TE._flat_rows(tree, pp, dp * csz).numpy()[:, :flat],
        TE._zero1_flatten_rows(host, tspec, mesh),
    )


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_device_layouts_and_sums_hold(tp):
    """At tp > 1 the device layouts hold pp*tp rows of rank shards: the
    flat and dealt rows equal the host helpers (the checkpoints' and the
    JAX package's layout), their replica sums ``dp_sum``'s values, and the
    gathers write the global slabs back exactly."""
    dp, pp, V = 2, 2, 2
    _, tspec = _specs(SIZES, pp, V)
    mesh = VirtualMesh(dp, pp, "cpu", tp=tp)
    trees = _replica_trees(tspec, dp, seed=7, tp=tp)
    host = {k: tuple(a.numpy() for a in trees[0][k]) for k in ("W", "b")}
    slots, _ = TE.zero_block_slots(tspec, pp, dp, tp)
    np.testing.assert_array_equal(
        TE._deal(trees[0], slots, pp, dp, tp).numpy(), TE.zero_block_flatten_rows(host, tspec, mesh)
    )
    flat, csz = TE.zero1_flat_len(tspec, mesh)
    rows = TE._flat_rows(trees[0], pp, dp * csz, tp)
    assert rows.shape == (pp * tp, dp * csz)
    np.testing.assert_array_equal(rows.numpy()[:, :flat], TE._zero1_flatten_rows(host, tspec, mesh))
    anchor = TE.dp_sum(trees)
    summed = TE._flat_rows(trees[0], pp, dp * csz, tp) + TE._flat_rows(trees[1], pp, dp * csz, tp)
    dealt = TE._deal(trees[0], slots, pp, dp, tp) + TE._deal(trees[1], slots, pp, dp, tp)
    for got in (TE._unflat_rows(summed, anchor, tp), TE._undeal(dealt, slots, pp, dp, tp)):
        assert all(torch.equal(a, b) for k in ("W", "b") for a, b in zip(got[k], anchor[k]))
    into = {k: tuple(torch.zeros_like(a) for a in anchor[k]) for k in ("W", "b")}
    TE._unflat_rows_into(summed, into, tp)
    assert all(torch.equal(a, b) for k in ("W", "b") for a, b in zip(into[k], anchor[k]))
    into = {k: tuple(torch.zeros_like(a) for a in anchor[k]) for k in ("W", "b")}
    TE._undeal_into(dealt, slots, into, pp, dp, tp)
    assert all(torch.equal(a, b) for k in ("W", "b") for a, b in zip(into[k], anchor[k]))
