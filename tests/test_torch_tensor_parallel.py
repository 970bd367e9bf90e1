"""Tensor parallelism on the port's virtual mesh (shallowspeed_tpu_torch/
parallel/{mesh,executor,gradsync}.py, api.py, convert.py) against the JAX
package's, on the CPU at tests/test_tensor_parallel.py's sizes.

- The layout helpers equal the JAX package's (``slot_shapes``,
  ``tp_local_dims``, ``tp_allreduce_sites``, ``stash_slot_nbytes``,
  ``stack_params``, the zero-1 rows, ``zero_block_slots`` and the planners)
  on every zoo model at pp in {1, 2, 4} and tp in {2, 4}.
- The port's executor against JAX ``E.make_pipeline_step`` on the same data
  and init, two steps with a clip, at each ``TP_LAYOUTS`` corner of the JAX
  file and the zero 2, zero 3, bucketed, split, recompute, interleaved and
  gelu legs: every weight, the loss and the grad norm within the
  cross-engine class ``rtol=2e-4, atol=2e-6``, and the weights within the
  cross-layout class ``rtol=5e-4, atol=5e-6`` of the port's sequential
  trainer (splitting a contraction over ranks reassociates its sum).
- In the port at fixed tp = 2, bitwise: bucketed vs anchor sync, zero 1 vs
  zero 0, bucketed zero 2 vs zero 1, zero 3 vs anchor zero 2, split vs
  combined backward, recompute vs stashed, the run vs the step loop, and
  ``predict`` across ladder rungs.
- Exact data movement: with integer-valued weights and inputs the tp = 2
  stage forward and backward are the tp = 1 ones bit for bit.
- The session: ``tp=`` on the whole lattice against the sequential path,
  the JAX session's refusals in its words, checkpoints across the two
  packages and across tp, a killed tp = 2 run resumed to its twin's hash,
  the JSONL records' tp fields and the divergence replay at tp = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as JM
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import JsonlMetrics as JaxJsonl
from shallowspeed_tpu.observability.metrics import read_jsonl
from shallowspeed_tpu.optimizer import make_optimizer as jmake_optimizer
from shallowspeed_tpu.parallel import executor as JE
from shallowspeed_tpu.parallel import gradsync as jgs
from shallowspeed_tpu.parallel import lower_schedule as jlower
from shallowspeed_tpu.parallel import make_mesh as jmesh
from shallowspeed_tpu.parallel.mesh import make_mesh as jmake_mesh
from shallowspeed_tpu_torch import convert, faults, trainer
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import list_step_checkpoints
from shallowspeed_tpu_torch.observability import JsonlMetrics
from shallowspeed_tpu_torch.observability import divergence as tdiv
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel import gradsync as tgs
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh, mesh_tp

SIZES = (40, 36, 32, 28, 24, 20, 14, 10)  # tests/test_tensor_parallel.py's
M, B = 4, 32
CLIP = 0.05
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 5e-4, 5e-6  # cross-layout (tests/test_tensor_parallel.py)
OPTS = {"sgd": (0.01,), "momentum": (0.005, 0.9)}
ZOO = ("mnist-mlp", "mlp-wide", "mlp-deep", "transformer")


def _sizes(model):
    return (SIZES, "relu") if model is None else TM.resolve_model(model)


def _data(in_dim, out_dim, seed=7, nb=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(nb, B, in_dim).astype(np.float32)
    Y = np.eye(out_dim, dtype=np.float32)[rng.randint(0, out_dim, (nb, B))]
    return X, Y


def _flat(layers):
    return [l for s in layers for l in s]


def _close(got, want, rtol, atol, label=""):
    for a, b in zip(got, want):
        for k in ("W", "b"):
            np.testing.assert_allclose(
                np.asarray(a[k]).reshape(-1), np.asarray(b[k]).reshape(-1),
                rtol=rtol, atol=atol, err_msg=f"{label} {k}",
            )


def _same(a, b):
    return all(
        np.asarray(x[k]).tobytes() == np.asarray(y[k]).tobytes()
        for x, y in zip(a, b) for k in ("W", "b")
    )


# ---------------------------------------------------------------------------
# The mesh and the static layout
# ---------------------------------------------------------------------------


def test_mesh_tp_axis_and_refusal():
    mesh = VirtualMesh(2, 2, "cpu", tp=2)
    assert mesh.shape == {"dp": 2, "pp": 2, "tp": 2} == dict(jmake_mesh(2, 2, tp=2).shape)
    assert mesh_tp(mesh) == 2
    two = VirtualMesh(2, 2, "cpu")
    assert two.shape == dict(jmake_mesh(2, 2).shape) and mesh_tp(two) == 1
    assert VirtualMesh(2, 2, "cpu", tp=1).shape == {"dp": 2, "pp": 2}
    with pytest.raises(ValueError) as want:
        jmake_mesh(1, 1, tp=0)
    with pytest.raises(ValueError) as got:
        VirtualMesh(1, 1, "cpu", tp=0)
    assert str(got.value) == str(want.value) == "tp must be >= 1, got 0"


def _fill(spec):
    """Distinct, cheap values in every logical param (arange per leaf)."""
    out, base = [], 0.0
    for st in spec.stages:
        layers = []
        for l in range(st.n_linears):
            i, o = st.local_sizes[l], st.local_sizes[l + 1]
            W = (np.arange(o * i, dtype=np.float32) * 1e-3 + base).reshape(o, i)
            b = (np.arange(o, dtype=np.float32) - base).reshape(1, o)
            layers.append({"W": W, "b": b})
            base += 1.0
        out.append(layers)
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("pp", [1, 2, 4])
@pytest.mark.parametrize("model", ZOO)
def test_layout_helpers_equal_jax(model, pp, tp):
    sizes, act = TM.resolve_model(model)
    tspec = TM.make_model_spec(sizes, pp, 128, act=act)
    jspec = JM.make_model_spec(sizes, pp, 128, act=act)
    dims = TE.slot_shapes(tspec, tp)
    assert dims == JE.slot_shapes(jspec, tp)
    assert TE.tp_local_dims(dims, tp) == JE.tp_local_dims(dims, tp)
    for training in (True, False):
        want = JE.tp_allreduce_sites(jspec, tp, training)
        assert TE.tp_allreduce_sites(tspec, tp, training) == want
    assert TE.stash_slot_nbytes(tspec, 32, tp) == JE.stash_slot_nbytes(jspec, 32, tp)
    assert TE.stacked_flat_len(tspec, pp, tp) == JE.stacked_flat_len(jspec, pp, tp)
    for dp in (1, 2):
        ts, tc = TE.zero_block_slots(tspec, pp, dp, tp)
        js, jc = JE.zero_block_slots(jspec, pp, dp, tp)
        assert tc == jc and [tuple(s) for s in ts] == [tuple(s) for s in js]
    params = _fill(tspec)
    tst, tfl = TE.stack_params(params, tspec, tp=tp)
    jst, jfl = JE.stack_params(params, jspec, tp=tp)
    for k in ("W", "b"):
        for a, b in zip(tst[k], jst[k]):
            assert a.shape == b.shape and np.array_equal(a, b)
    for k in jfl:
        assert np.array_equal(tfl[k], jfl[k])
    # the zero-1 rows: the JAX helpers read only the mesh's shape, so the
    # virtual mesh stands in for a device mesh the host cannot build
    mesh = VirtualMesh(2, pp, "cpu", tp=tp)
    rows = TE._zero1_flatten_rows(tst, tspec, mesh)
    assert rows.shape[0] == pp * tp
    assert np.array_equal(rows, JE._zero1_flatten_rows(jst, jspec, mesh))
    back = TE._zero1_unflatten_rows(rows, tspec, mesh)
    assert all(np.array_equal(a, b) for k in ("W", "b") for a, b in zip(back[k], tst[k]))


@pytest.mark.parametrize("zero", [0, 1, 2])
@pytest.mark.parametrize("tp", [2, 4])
def test_planners_and_comm_bytes_equal_jax(tp, zero):
    tspec = TM.make_model_spec(SIZES, 2, B)
    jspec = JM.make_model_spec(SIZES, 2, B)
    for budget in (256, 4096):
        tp_plan = tgs.plan_buckets(tspec, 2, 2, budget, zero=zero, tp=tp)
        jp_plan = jgs.plan_buckets(jspec, 2, 2, budget, zero=zero, tp=tp)
        assert tp_plan.describe() == jp_plan.describe()
        assert tgs.sync_comm_bytes(tspec, 2, 2, plan=tp_plan, tp=tp, zero=zero, mubatches=M) == (
            jgs.sync_comm_bytes(jspec, 2, 2, plan=jp_plan, tp=tp, zero=zero, mubatches=M)
        )
    # the dp payload is one rank's shards: it shrinks with tp
    payload = tgs.sync_comm_bytes(tspec, 2, 2, tp=tp)["grad_bytes_per_device"]
    assert payload == 4 * TE.stacked_flat_len(tspec, 2, tp)
    assert TE.stacked_flat_len(tspec, 2, tp) < TE.stacked_flat_len(tspec, 2)


# ---------------------------------------------------------------------------
# The executor against the JAX package and the sequential path
# ---------------------------------------------------------------------------

SCHED = {"gpipe": "GPipeSchedule", "pipedream": "PipeDreamFlushSchedule",
         "naive": "NaiveParallelSchedule", "interleaved": "InterleavedSchedule"}


def _opt(make, name):
    return make(name, *OPTS[name])


def _port(dp, pp, tp, sched="gpipe", zero=0, bucket=0, split=False, rec=False,
          virtual=1, opt="sgd", model=None, clip=CLIP, run=False):
    """Two steps of the port's executor from the init (or ``run``: the
    same two batches as one ``make_pipeline_run`` epoch). Returns (flat
    logical params, the mean loss, the last step's loss and grad norm;
    None for the last two after a run)."""
    sizes, act = _sizes(model)
    X, Y = _data(sizes[0], sizes[-1])
    mesh = VirtualMesh(dp, pp, "cpu", tp=tp)
    spec = TM.make_model_spec(sizes, pp * virtual, B, act=act)
    order = TE.interleave_order(pp * virtual, pp) if virtual > 1 else None
    prog = tlower(getattr(TS, SCHED[sched]), M, pp, virtual=virtual, backward_split=split,
                  recompute=rec)
    o = _opt(make_optimizer, opt)
    stacked, flags = TE.init_stacked(spec, mesh, order=order)
    if zero == 0:
        st = o.init(stacked)
    elif zero == 1:
        st = TE.zero1_init_state(o, spec, mesh)
    else:
        st = TE.zero_block_init_state(o, spec, mesh)
    if zero == 3:
        host = {k: tuple(a.numpy() for a in stacked[k]) for k in ("W", "b")}
        stacked = TE.zero_params_at_rest(host, spec, mesh)
    kw = dict(clip_norm=clip, zero=zero, grad_bucket_bytes=bucket)
    if run:
        fn = TE.make_pipeline_run(mesh, spec, prog, B // dp // M, o, **kw)
        stacked, st, losses = fn(stacked, flags, st, torch.from_numpy(X), torch.from_numpy(Y), 1)
        mean, loss, gn = losses[-1], None, None
    else:
        step = TE.make_pipeline_step(mesh, spec, prog, B // dp // M, o, with_grad_norm=True, **kw)
        total = torch.zeros(())
        for i in range(len(X)):
            xb, yb = torch.from_numpy(X[i]), torch.from_numpy(Y[i])
            stacked, st, loss, gn = step(stacked, flags, st, xb, yb)
            total = total + loss
        mean, loss, gn = total / len(X), float(loss), float(gn)
    if zero == 3:
        layers = convert.zero_params_to_numpy(stacked, spec, mesh, order=order)
    else:
        layers = TE.unstack_params(stacked, spec, order=order)
    return _flat(layers), float(mean), loss, gn


def _jax(dp, pp, tp, sched="gpipe", zero=0, bucket=0, split=False, rec=False,
         virtual=1, opt="sgd", model=None, clip=CLIP):
    """``_port``'s drive through JAX ``E.make_pipeline_step`` on the
    8-device virtual CPU mesh."""
    sizes, act = _sizes(model)
    X, Y = _data(sizes[0], sizes[-1])
    mesh = jmesh(dp, pp, tp=tp)
    spec = JM.make_model_spec(sizes, pp * virtual, B, act=act)
    order = JE.interleave_order(pp * virtual, pp) if virtual > 1 else None
    prog = jlower(getattr(JS, SCHED[sched]), M, pp, virtual=virtual, backward_split=split,
                  recompute=rec)
    o = _opt(jmake_optimizer, opt)
    stacked, flags = JE.init_stacked(spec, mesh, order=order)
    if zero == 0:
        st = o.init(stacked)
    elif zero == 1:
        st = JE.zero1_init_state(o, spec, mesh)
    else:
        st = JE.zero_block_init_state(o, spec, mesh)
    if zero == 3:
        rows = JE.zero_block_flatten_rows(jax.device_get(stacked), spec, mesh)
        stacked = {"P": jax.device_put(rows, JE.zero1_part_sharding(mesh))}
    step = JE.make_pipeline_step(
        mesh, spec, prog, B // dp // M, o, zero=zero, grad_bucket_bytes=bucket,
        clip_norm=clip, with_grad_norm=True,
    )
    for i in range(len(X)):
        stacked, st, loss, gn = step(stacked, flags, st, jnp.asarray(X[i]), jnp.asarray(Y[i]))
    if zero == 3:
        host = JE.zero_block_unflatten_rows(np.asarray(jax.device_get(stacked["P"])), spec, mesh)
    else:
        host = jax.device_get(stacked)
    return _flat(JE.unstack_params(host, spec, order=order)), float(loss), float(gn)


def _sequential(opt="sgd", model=None, clip=CLIP):
    """The port's sequential trainer on the same two batches."""
    sizes, act = _sizes(model)
    X, Y = _data(sizes[0], sizes[-1])
    spec = TM.make_model_spec(sizes, 1, B, act=act)
    params = convert.params_from_numpy(TM.init_model(spec), "cpu")
    o = _opt(make_optimizer, opt)
    step = trainer.make_train_step(spec, o, clip_norm=clip)
    st = o.init(TM.param_tree(params))
    for i in range(len(X)):
        params, st = step(
            params, st, torch.from_numpy(X[i].reshape(M, B // M, -1)),
            torch.from_numpy(Y[i].reshape(M, B // M, -1)),
        )
    return _flat(convert.params_to_numpy(params))


# layout -> (dp, pp, tp, kwargs): the JAX file's TP_LAYOUTS corners, then the
# rest of the lattice at DP=2 x PP=2 x TP=2 (or TP=2 alone)
CORNERS = {
    "tp2": (1, 1, 2, {}),
    "tp4": (1, 1, 4, {}),
    "dp2-tp2": (2, 1, 2, {}),
    "pp2-tp2": (1, 2, 2, {}),
    "dp2-pp2-tp2": (2, 2, 2, dict(sched="pipedream")),
    "zero1-tp2": (2, 2, 2, dict(zero=1, opt="momentum")),
    "zero2-tp2": (2, 2, 2, dict(zero=2, opt="momentum")),
    "zero3-tp2": (2, 2, 2, dict(zero=3, opt="momentum")),
    "zero2-bucketed-tp2": (2, 2, 2, dict(zero=2, bucket=256, opt="momentum")),
    "split-dp2-pp2-tp2": (2, 2, 2, dict(sched="pipedream", split=True)),
    "recompute-pp2-tp2": (1, 2, 2, dict(rec=True)),
    "interleaved-pp2-v2-tp2": (1, 2, 2, dict(sched="interleaved", virtual=2)),
    "naive-dp2-pp2-tp2": (2, 2, 2, dict(sched="naive")),
    "gelu-tp2": (1, 1, 2, dict(model="transformer")),
}


@pytest.fixture(scope="module")
def sequential_runs():
    """The port's sequential oracle per (optimizer, model), computed once."""
    cache = {}

    def get(opt, model):
        if (opt, model) not in cache:
            cache[opt, model] = _sequential(opt, model)
        return cache[opt, model]

    return get


@pytest.mark.parametrize("corner", list(CORNERS))
def test_executor_matches_jax_and_sequential(corner, sequential_runs):
    dp, pp, tp, kw = CORNERS[corner]
    got, _, loss, gn = _port(dp, pp, tp, **kw)
    want, jloss, jgn = _jax(dp, pp, tp, **kw)
    assert np.isfinite(loss) and np.isfinite(gn)
    assert loss == pytest.approx(jloss, rel=RTOL, abs=ATOL)
    assert gn == pytest.approx(jgn, rel=RTOL, abs=ATOL)
    _close(got, want, RTOL, ATOL, corner)
    seq = sequential_runs(kw.get("opt", "sgd"), kw.get("model"))
    _close(got, seq, LAYOUT_RTOL, LAYOUT_ATOL, f"{corner} vs sequential")


# ---------------------------------------------------------------------------
# The in-port bitwise contracts at tp = 2
# ---------------------------------------------------------------------------

# (a, b): two drives of DP=2 x PP=2 x TP=2 that must end on the same bits
# (no clip on the ZeRO pairs: their norm reads a different partition)
CONTRACTS = {
    "bucketed zero 0 = zero 0": (dict(bucket=256), dict()),
    "zero 1 = zero 0": (dict(zero=1, clip=None), dict(clip=None)),
    "bucketed zero 2 = zero 1": (dict(zero=2, bucket=256, clip=None), dict(zero=1, clip=None)),
    "zero 3 = anchor zero 2": (dict(zero=3), dict(zero=2)),
    "split = combined": (dict(split=True), dict()),
    "recompute = stashed": (dict(rec=True), dict()),
    "split + recompute = combined": (dict(split=True, rec=True), dict()),
    "run = step loop": (dict(run=True), dict()),
    "zero 2 run = zero 2 step loop": (dict(zero=2, run=True), dict(zero=2)),
    "gelu split + recompute = combined": (
        dict(model="transformer", split=True, rec=True), dict(model="transformer"),
    ),
}


@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_bitwise_contract_at_tp2(contract):
    a_kw, b_kw = CONTRACTS[contract]
    common = dict(sched="pipedream", opt="momentum")
    a = _port(2, 2, 2, **{**common, **a_kw})
    b = _port(2, 2, 2, **{**common, **b_kw})
    assert a[1] == b[1], contract  # the mean loss, bitwise
    assert _same(a[0], b[0]), contract


# ---------------------------------------------------------------------------
# Exact data movement
# ---------------------------------------------------------------------------


def _integer_params(spec, seed):
    rng = np.random.RandomState(seed)
    return [
        [
            {
                "W": rng.randint(-1, 2, (st.local_sizes[l + 1], st.local_sizes[l])).astype(
                    np.float32
                ),
                "b": rng.randint(-1, 2, (1, st.local_sizes[l + 1])).astype(np.float32),
            }
            for l in range(st.n_linears)
        ]
        for st in spec.stages
    ]


# (sizes, pp): an odd slot count (the closing gather), an even one, and a
# PP=2 split whose shorter stage passes through inactive slots of both kinds
EXACT = {"5 slots": ((16, 12, 12, 8, 8, 6), 1), "4 slots": ((16, 12, 12, 8, 6), 1),
         "pp2 ragged": ((16, 12, 12, 8, 8, 6), 2)}


@pytest.mark.parametrize("case", list(EXACT))
def test_tp2_stage_is_tp1_bit_for_bit_on_integers(case):
    sizes, pp = EXACT[case]
    spec = TM.make_model_spec(sizes, pp, 8)
    params = _integer_params(spec, 3)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(0, 2, (8, sizes[0])).astype(np.float32))
    stacks = {tp: TE.stack_params(params, spec, tp=tp) for tp in (1, 2)}
    for r in range(spec.n_stages):
        outs, grads = {}, {}
        g_width = TE.slot_shapes(spec)[-1][0]
        g0 = torch.from_numpy(rng.randint(-1, 2, (8, g_width)).astype(np.float32))
        for tp, (st, fl) in stacks.items():
            dims = TE.slot_shapes(spec, tp)
            W = [torch.from_numpy(w[r]) for w in st["W"]]
            b = [torch.from_numpy(v[r]) for v in st["b"]]
            act, relu, res = (fl[k][r].tolist() for k in ("active", "relu", "residual"))
            xin = TE._fit(x, dims[0][1])
            g = TE._fit(g0, dims[-1][0])
            gW = [torch.zeros_like(w) for w in W]
            gb = [torch.zeros_like(v) for v in b]
            if tp == 1:
                out, xs, masks = TE._stage_fwd(W, b, act, relu, res, dims, xin, "xla", "relu")

                def sink(l, dw, db):
                    gW[l].add_(dw)
                    gb[l].add_(db.reshape(-1))

                dx = TE._stage_bwd(W, act, relu, res, dims, xs, masks, g, "xla", sink)
            else:
                tr = TE.TpRanks(tp, range(tp))
                out, xs, masks = TE._stage_fwd_tp(W, b, act, relu, res, dims, xin, "relu", tr)

                def sink(l, dw, db):
                    TE._tp_w(gW[l], l, tp).add_(dw)
                    TE._tp_b(gb[l], tp).add_(db)

                dx = TE._stage_bwd_tp(W, act, relu, res, dims, xs, masks, g, tr, sink)
            outs[tp] = out
            grads[tp] = (dx, gW, gb)
        w1 = outs[1].shape[-1]
        assert torch.equal(outs[2][:, :w1], outs[1]) and not outs[2][:, w1:].any()
        dx1, gW1, gb1 = grads[1]
        dx2, gW2, gb2 = grads[2]
        assert torch.equal(dx2[:, : dx1.shape[-1]], dx1)
        for a1, a2 in zip(gW1 + gb1, gW2 + gb2):
            idx = tuple(slice(0, n) for n in a1.shape)
            assert torch.equal(a2[idx], a1)


def test_inference_program_tp2_is_tp1_on_integers():
    """The whole inference program (relays, passthroughs, the head) at
    DP=1 x PP=2 x TP=2 gives the TP=1 program's bits on integer inputs."""
    sizes = (16, 12, 12, 8, 8, 6)
    spec = TM.make_model_spec(sizes, 2, 8)
    params = _integer_params(spec, 6)
    x = torch.from_numpy(np.random.RandomState(7).randint(0, 2, (8, 16)).astype(np.float32))
    prog = tlower(TS.InferenceSchedule, 2, 2, training=False)
    preds = {}
    for tp in (1, 2):
        stacked, flags = convert.stacked_from_numpy(params, spec, "cpu", tp=tp)
        step = TE.make_pipeline_step(VirtualMesh(1, 2, "cpu", tp=tp), spec, prog, 4)
        preds[tp] = step(stacked, flags, x)
    assert torch.equal(preds[1], preds[2])


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 128), ("val", 64)):
        np.save(d / f"x_{suffix}.npy", rng.rand(n, SIZES[0]).astype(np.float32))
        labels = rng.randint(0, SIZES[-1], n)
        np.save(d / f"y_{suffix}.npy", np.eye(SIZES[-1], dtype=np.float32)[labels])
    return d


@pytest.fixture(scope="module")
def wide_data_dir(tmp_path_factory):
    """784-wide rows for the zoo's transformer."""
    d = tmp_path_factory.mktemp("tp_wide")
    rng = np.random.RandomState(1)
    for suffix, n in (("train", 64), ("val", 32)):
        np.save(d / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(d / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return d


COMMON = dict(sizes=SIZES, global_batch_size=32, mubatches=2, lr=0.01)


def test_session_tp2_trains_and_predicts_like_jax(tp_data_dir):
    """The JAX file's session test, without its audit: TrainingSession(dp=2,
    tp=2) trains within the cross-layout class of the sequential session and
    the cross-engine class of the JAX session, and predicts the same rows
    bitwise through two ladder rungs."""
    run = TorchSession(dp=2, tp=2, data_dir=tp_data_dir, device="cpu", **COMMON)
    assert not run.sequential and run.tp == 2
    assert np.isfinite(run.train_epoch())
    seq = TorchSession(data_dir=tp_data_dir, device="cpu", **COMMON)
    seq.train_epoch()
    _close(_flat(run.params()), _flat(seq.params()), LAYOUT_RTOL, LAYOUT_ATOL)
    js = JaxSession(dp=2, tp=2, data_dir=tp_data_dir, **COMMON)
    js.train_epoch()
    _close(_flat(run.params()), _flat(js.params()), RTOL, ATOL)
    x = np.asarray(np.random.RandomState(5).rand(3, SIZES[0]), np.float32)
    p_small = run.predict(x)
    p_large = run.predict(np.concatenate([x, x, x], axis=0))[:3]
    assert np.array_equal(p_small, p_large)
    np.testing.assert_allclose(p_small, js.predict(x), rtol=RTOL, atol=1e-6)
    assert run.accuracy() == pytest.approx(js.accuracy())


# the session lattice at tp > 1, each against the sequential session
LATTICE = {
    "tp4": dict(tp=4),
    "naive dp2-pp2-tp2": dict(dp=2, pp=2, tp=2, schedule="naive"),
    "gpipe pp2-tp2 zero 3": dict(dp=2, pp=2, tp=2, zero=3),
    "pipedream dp2-pp2-tp2 split recompute": dict(
        dp=2, pp=2, tp=2, schedule="pipedream", backward_split=True, recompute=True,
    ),
    "interleaved pp2-v2-tp2": dict(pp=2, tp=2, schedule="interleaved", virtual_stages=2),
    "zero 2 bucketed dp2-pp2-tp2": dict(dp=2, pp=2, tp=2, zero=2, grad_bucket_bytes=256),
    "zero 1 dp2-tp2": dict(dp=2, tp=2, zero=1),
}


@pytest.mark.parametrize("layout", list(LATTICE))
def test_session_lattice_within_class_of_sequential(layout, tp_data_dir):
    kw = LATTICE[layout]
    run = TorchSession(data_dir=tp_data_dir, device="cpu", optimizer="momentum", **COMMON, **kw)
    run.train_epoch()
    seq = TorchSession(data_dir=tp_data_dir, device="cpu", optimizer="momentum", **COMMON)
    seq.train_epoch()
    _close(_flat(run.params()), _flat(seq.params()), LAYOUT_RTOL, LAYOUT_ATOL, layout)
    x = np.asarray(np.random.RandomState(2).rand(5, SIZES[0]), np.float32)
    np.testing.assert_allclose(run.predict(x), seq.predict(x), rtol=LAYOUT_RTOL, atol=1e-6)


def test_session_gelu_tp2_within_class_of_sequential(wide_data_dir):
    kw = dict(model="transformer", global_batch_size=16, mubatches=2, lr=0.01,
              data_dir=wide_data_dir, device="cpu")
    run = TorchSession(pp=2, tp=2, schedule="pipedream", **kw)
    run.train_epoch()
    seq = TorchSession(**kw)
    seq.train_epoch()
    _close(_flat(run.params()), _flat(seq.params()), LAYOUT_RTOL, LAYOUT_ATOL)


def test_session_validations_in_the_jax_words():
    cases = [
        (dict(tp=0), "tp must be >= 1"),
        (dict(dp=2, tp=2, kernel_backend="pallas"), "pallas"),
        (dict(tp=2, fuse_mubatches=True), "sequential path only"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match) as got:
            TorchSession(device="cpu", **kw)
        with pytest.raises(ValueError, match=match) as want:
            JaxSession(**kw)
        assert str(got.value) == str(want.value)
    # the executor's refusal, in the JAX executor's words
    spec = TM.make_model_spec(SIZES, 1, B)
    prog = tlower(TS.GPipeSchedule, M, 1)
    with pytest.raises(ValueError) as got:
        TE.make_pipeline_step(VirtualMesh(1, 1, "cpu", tp=2), spec, prog, 8,
                              make_optimizer("sgd", 0.01), kernel_backend="pallas")
    with pytest.raises(ValueError) as want:
        JE.make_pipeline_step(jmesh(1, 1, tp=2), JM.make_model_spec(SIZES, 1, B),
                              jlower(JS.GPipeSchedule, M, 1), 8, jmake_optimizer("sgd", 0.01),
                              kernel_backend="pallas")
    assert str(got.value) == str(want.value)
    # the MPMD runtime builds at tp > 1; its envelope refuses ZeRO in the
    # JAX session's words
    assert TorchSession(device="cpu", dp=2, tp=2, runtime="mpmd").runtime == "mpmd"
    kw = dict(dp=2, tp=2, zero=1, runtime="mpmd")
    with pytest.raises(ValueError, match="runtime='mpmd' does not support zero") as got:
        TorchSession(device="cpu", **kw)
    with pytest.raises(ValueError, match="runtime='mpmd' does not support zero") as want:
        JaxSession(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("zero", [0, 3])
def test_checkpoints_cross_packages_and_tp(zero, tp_data_dir, tmp_path):
    """A JAX DP=2 x TP=2 snapshot restores in the port at TP=2 and at TP=1
    (sequential), and a port TP=2 step snapshot in the JAX session at TP=2
    and sequential: params, momentum and the cursor bitwise at restore."""
    kw = dict(optimizer="momentum", data_dir=tp_data_dir, **COMMON)
    js = JaxSession(dp=2, tp=2, zero=zero, **kw)
    js.train_epoch()
    js.save(tmp_path / "jax.npz")
    want_state = js.opt_state_logical()
    for lay in (dict(dp=2, tp=2, zero=zero), dict()):
        ts = TorchSession(device="cpu", resume=tmp_path / "jax.npz", **lay, **kw)
        assert ts.model_hash() == js.model_hash() and ts.epoch == js.epoch == 1
        assert _same(_flat(ts.params()), _flat(js.params()))
        assert _same(_flat(ts.opt_state_logical()["parts"][""]), _flat(want_state["parts"][""]))
    ts = TorchSession(device="cpu", dp=2, tp=2, zero=zero, checkpoint_dir=tmp_path / "ck", **kw)
    ts.train_steps(3)
    path = ts.save_step_checkpoint()
    for lay in (dict(dp=2, tp=2, zero=zero), dict()):
        back = JaxSession(resume=path, **lay, **kw)
        assert back.model_hash() == ts.model_hash()
        assert (back.epoch, back.step_in_epoch) == (0, 3)
        assert _same(_flat(back.opt_state_logical()["parts"][""]),
                     _flat(ts.opt_state_logical()["parts"][""]))
        again = TorchSession(device="cpu", resume=path, **lay, **kw)
        assert again.model_hash() == ts.model_hash()


def test_killed_tp2_run_resumes_to_its_twin(tp_data_dir, tmp_path):
    kw = dict(dp=2, pp=2, tp=2, zero=2, optimizer="momentum", data_dir=tp_data_dir,
              device="cpu", **COMMON)
    twin = TorchSession(**kw)
    for _ in range(2):
        twin.train_epoch()
    ck = tmp_path / "ck"

    def drive(run):
        while run.epoch < 2:
            run.train_steps(2)
            run.save_step_checkpoint()

    killed = TorchSession(checkpoint_dir=ck, faults="die@step=5", **kw)
    with pytest.raises(faults.InjectedFault, match="die@step=5"):
        drive(killed)
    resumed = TorchSession(checkpoint_dir=ck, resume="auto", **kw)
    assert resumed.global_step == list_step_checkpoints(ck)[-1][0] > 0
    drive(resumed)
    assert resumed.model_hash() == twin.model_hash()
    assert _same(_flat(resumed.opt_state_logical()["parts"][""]),
                 _flat(twin.opt_state_logical()["parts"][""]))


# ---------------------------------------------------------------------------
# Observability at tp > 1
# ---------------------------------------------------------------------------


def _event(records, name):
    return [r for r in records if r["kind"] == "event" and r["name"] == name]


def test_records_carry_tp_like_jax(tp_data_dir, tmp_path):
    kw = dict(dp=2, pp=2, tp=2, zero=2, grad_bucket_bytes=256, schedule="pipedream",
              recompute=True, data_dir=tp_data_dir, **COMMON)
    streams, sessions = {}, {}
    for name, cls, rec_cls, dev in (
        ("jax", JaxSession, JaxJsonl, {}),
        ("port", TorchSession, JsonlMetrics, {"device": "cpu"}),
    ):
        rec = rec_cls(tmp_path / f"{name}.jsonl")
        s = cls(metrics=rec, **kw, **dev)
        s.close()
        rec.close()
        streams[name] = read_jsonl(tmp_path / f"{name}.jsonl")
        sessions[name] = s
    for name in ("mesh_layout", "pipeline_program", "grad_sync_plan"):
        (t,), (j,) = _event(streams["port"], name), _event(streams["jax"], name)
        assert t["tp"] == j["tp"] == 2, name
        # the port places every virtual rank on its one device
        skip = {"layout", "n_devices"} if name == "mesh_layout" else set()
        keep = {k: v for k, v in j.items() if k not in skip | {"ts"}}
        assert {k: t[k] for k in keep} == keep, name
    # the FLOP ledger reads the session's tp
    cm_t, cm_j = (sessions[n]._cost_model.as_record() for n in ("port", "jax"))
    assert cm_t["padded_flops_per_batch"] == cm_j["padded_flops_per_batch"]


def test_divergence_replays_a_tp2_stream(tp_data_dir, tmp_path):
    """A tp = 2 run with a flipped bit against its clean twin: the digest
    streams name the step, and ``bisect_replay`` rebuilds both recorded
    tp = 2 sessions from their snapshots and reproduces the divergence."""
    paths, cks = [], []
    for name, plan in (("clean", None), ("flip", "flip@step=2")):
        path, ck = tmp_path / f"{name}.jsonl", tmp_path / f"ck-{name}"
        rec = JsonlMetrics(path)
        s = TorchSession(dp=2, tp=2, data_dir=tp_data_dir, device="cpu", metrics=rec,
                         digests=True, faults=plan, checkpoint_dir=ck, **COMMON)
        while s.epoch < 1:
            s.train_steps(1)
            s.save_step_checkpoint()
        rec.close()
        paths.append(path)
        cks.append(ck)
    recs = [read_jsonl(p) for p in paths]
    assert [r["tp"] for r in _event(recs[0], "digest_config")] == [2]
    div = tdiv.first_divergence(*(tdiv.digest_stream(r) for r in recs))
    assert div["step"] == 2
    lines = []
    diffs = tdiv.bisect_replay(*recs, *cks, div, out=lines.append, device="cpu")
    assert diffs and any("bitwise-equal" in l for l in lines)
