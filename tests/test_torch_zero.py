"""ZeRO stages 1-3 on the port's virtual mesh (shallowspeed_tpu_torch/
parallel/executor.py, api.py, convert.py, train.py) against the JAX
package's, on the CPU at tests/test_zero23.py's sizes.

- Port vs JAX ``E.make_pipeline_step(zero=...)`` on the 8-device virtual
  CPU mesh: 3 steps from the same init and data, params and losses within
  the cross-engine class ``rtol=2e-4, atol=2e-6``, per stage and optimizer
  at (dp, pp, V) = (2, 2, 1) and (2, 2, 2).
- The in-port bitwise contracts, the JAX package's own
  (``tests/test_zero1.py``, ``tests/test_zero23.py``,
  ``tests/test_gradsync.py``): bucketed zero 0 is zero 0; zero 1 is zero 0
  (SGD, momentum, and Adam too: eager elementwise math does not care how
  the update is chunked); bucketed zero 2 is zero 1 at any microbatch
  count; anchor zero 2 is zero 1 at ``mubatches=1`` and within ``rtol=1e-5,
  atol=1e-6`` of it at 4 (its per-tick sum is microbatch-outer), two runs
  bitwise; zero 3 is anchor zero 2; with a clip, rel 1e-6.
- Layouts: the state and ZeRO-3 params equal the JAX helpers' arrays, and
  round-trip through the logical form; checkpoints pass between the two
  packages across stages, bitwise at restore.
- The session and CLI, refusals in the JAX words.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as JM
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.optimizer import make_optimizer as jmake_optimizer
from shallowspeed_tpu.parallel import executor as JE
from shallowspeed_tpu.parallel import lower_schedule as jlower
from shallowspeed_tpu.parallel import make_mesh as jmesh
from shallowspeed_tpu_torch import convert, faults
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import list_step_checkpoints
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)  # tests/test_zero23.py's
B, M, LR, NB = 64, 4, 0.01, 3
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
OPTS = {"sgd": LR, "momentum": LR, "adam": LR}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(NB, B, SIZES[0]).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, 10, (NB, B))]
    return X, Y


def _sched(virtual, split, pkg):
    if virtual > 1:
        return pkg.InterleavedSchedule
    return pkg.PipeDreamFlushSchedule if split else pkg.GPipeSchedule


def _port(opt_name, dp, pp, zero, virtual=1, split=False, bucket=0, mub=M, clip=None,
          kernel_backend="xla", aux=None):
    """3 steps of the port's executor from the init; returns (logical params
    flat list, state, last loss, (spec, mesh, order), the aux outputs)."""
    X, Y = _data()
    mesh = VirtualMesh(dp, pp, "cpu")
    spec = TM.make_model_spec(SIZES, pp * virtual, B)
    order = TE.interleave_order(pp * virtual, pp) if virtual > 1 else None
    prog = tlower(_sched(virtual, split, TS), mub, pp, virtual=virtual, backward_split=split)
    opt = make_optimizer(opt_name, OPTS[opt_name])
    stacked, flags = TE.init_stacked(spec, mesh, order=order)
    if zero == 0:
        st = opt.init(stacked)
    elif zero == 1:
        st = TE.zero1_init_state(opt, spec, mesh)
    else:
        st = TE.zero_block_init_state(opt, spec, mesh)
    if zero == 3:
        host = {k: tuple(a.numpy() for a in stacked[k]) for k in ("W", "b")}
        stacked = TE.zero_params_at_rest(host, spec, mesh)
    step = TE.make_pipeline_step(
        mesh, spec, prog, B // dp // mub, opt, zero=zero, grad_bucket_bytes=bucket,
        clip_norm=clip, kernel_backend=kernel_backend, **(aux or {}),
    )
    extras = []
    for i in range(NB):
        out = step(stacked, flags, st, torch.from_numpy(X[i]), torch.from_numpy(Y[i]))
        stacked, st, loss = out[:3]
        extras.append(out[3:])
    if zero == 3:
        layers = convert.zero_params_to_numpy(stacked, spec, mesh, order=order)
    else:
        layers = TE.unstack_params(stacked, spec, order=order)
    return [l for s in layers for l in s], st, float(loss), (spec, mesh, order), extras


def _jax(opt_name, dp, pp, zero, virtual=1, bucket=0, mub=M):
    """The JAX package's ``make_pipeline_step(zero=...)`` on the same data
    (tests/test_zero23.py's drive)."""
    X, Y = _data()
    mesh = jmesh(dp, pp)
    spec = JM.make_model_spec(SIZES, pp * virtual, B)
    order = JE.interleave_order(pp * virtual, pp) if virtual > 1 else None
    prog = jlower(_sched(virtual, False, JS), mub, pp, virtual=virtual)
    opt = jmake_optimizer(opt_name, OPTS[opt_name])
    stacked, flags = JE.init_stacked(spec, mesh, order=order)
    if zero == 1:
        st = JE.zero1_init_state(opt, spec, mesh)
    else:
        st = JE.zero_block_init_state(opt, spec, mesh)
    if zero == 3:
        rows = JE.zero_block_flatten_rows(jax.device_get(stacked), spec, mesh)
        stacked = {"P": jax.device_put(rows, JE.zero1_part_sharding(mesh))}
    step = JE.make_pipeline_step(
        mesh, spec, prog, B // dp // mub, opt, zero=zero, grad_bucket_bytes=bucket
    )
    for i in range(NB):
        stacked, st, loss = step(stacked, flags, st, jnp.asarray(X[i]), jnp.asarray(Y[i]))
    if zero == 3:
        host = JE.zero_block_unflatten_rows(np.asarray(jax.device_get(stacked["P"])), spec, mesh)
    else:
        host = jax.device_get(stacked)
    layers = JE.unstack_params(host, spec, order=order)
    return [l for s in layers for l in s], st, float(loss), (spec, mesh, order)


def _same(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in ("W", "b"))


def _close(a, b, rtol, atol):
    for x, y in zip(a, b):
        for k in ("W", "b"):
            np.testing.assert_allclose(x[k], y[k], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

# tier-1: momentum at every stage and layout, SGD and Adam at anchor zero 2
# (2, 2, 1); the other SGD/Adam cases are slow
CROSS = [
    pytest.param(
        opt, zero, layout,
        marks=() if opt == "momentum" or (zero, layout) == (2, (2, 2, 1)) else pytest.mark.slow,
    )
    for opt in ("sgd", "momentum", "adam")
    for zero in (1, 2, 3)
    for layout in ((2, 2, 1), (2, 2, 2))
]


@pytest.mark.parametrize("opt,zero,layout", CROSS)
def test_stage_matches_jax(opt, zero, layout):
    dp, pp, V = layout
    got, _, loss_t, _, _ = _port(opt, dp, pp, zero, virtual=V)
    want, _, loss_j, _ = _jax(opt, dp, pp, zero, virtual=V)
    assert loss_t == pytest.approx(loss_j, rel=RTOL, abs=ATOL)
    _close(got, want, RTOL, ATOL)


@pytest.mark.parametrize(
    "zero", [1, pytest.param(2, marks=pytest.mark.slow)], ids=["zero1", "zero2"]
)
def test_bucketed_stage_matches_jax(zero):
    got, _, _, _, _ = _port("momentum", 2, 2, zero, bucket=256)
    want, _, _, _ = _jax("momentum", 2, 2, zero, bucket=256)
    _close(got, want, RTOL, ATOL)


# ---------------------------------------------------------------------------
# The in-port bitwise contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [1, 256, 65536])
@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 2, 2), (4, 2, 1)])
def test_bucketed_zero0_is_bitwise_zero0(budget, layout):
    dp, pp, V = layout
    a = _port("momentum", dp, pp, 0, virtual=V)[0]
    b = _port("momentum", dp, pp, 0, virtual=V, bucket=budget)[0]
    assert _same(a, b)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 2, 2), (4, 2, 1), (2, 4, 1)])
def test_zero1_is_bitwise_zero0(opt, layout):
    dp, pp, V = layout
    z0 = _port(opt, dp, pp, 0, virtual=V)
    z1 = _port(opt, dp, pp, 1, virtual=V)
    assert z0[2] == z1[2] and _same(z0[0], z1[0])
    z1b = _port(opt, dp, pp, 1, virtual=V, bucket=256)
    assert _same(z1[0], z1b[0])


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 2, 2)])
def test_bucketed_zero2_is_bitwise_zero1_at_any_microbatch_count(opt, layout):
    dp, pp, V = layout
    z1 = _port(opt, dp, pp, 1, virtual=V)[0]
    for budget in (1, 256, 65536):
        assert _same(z1, _port(opt, dp, pp, 2, virtual=V, bucket=budget)[0])


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_anchor_zero2_is_zero1_at_one_microbatch_and_close_above(opt):
    assert _same(_port(opt, 2, 2, 1, mub=1)[0], _port(opt, 2, 2, 2, mub=1)[0])
    z1 = _port(opt, 2, 2, 1)[0]
    z2 = _port(opt, 2, 2, 2)[0]
    z2_again = _port(opt, 2, 2, 2)[0]
    _close(z1, z2, 1e-5, 1e-6)
    assert _same(z2, z2_again)
    # the per-tick tree really is microbatch-outer: at M=4 it is not zero 1's
    assert opt != "momentum" or not _same(z1, z2)


@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 2, 2), (4, 2, 1)])
@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_zero3_is_bitwise_anchor_zero2(layout, opt):
    dp, pp, V = layout
    z2 = _port(opt, dp, pp, 2, virtual=V)
    z3 = _port(opt, dp, pp, 3, virtual=V)
    assert z2[2] == z3[2] and _same(z2[0], z3[0])


def test_split_backward_at_zero2_and_zero3():
    """The split backward's B-weight ticks feed the same per-tick scatter
    (bitwise the unsplit anchor run) and the same slabs (bucketed zero 2
    bitwise zero 1)."""
    z1 = _port("momentum", 2, 2, 1, split=True)[0]
    assert _same(z1, _port("momentum", 2, 2, 2, split=True, bucket=256)[0])
    z2 = _port("momentum", 2, 2, 2, split=True)[0]
    assert _same(z2, _port("momentum", 2, 2, 3, split=True)[0])
    _close(z1, z2, 1e-5, 1e-6)


@pytest.mark.parametrize("zero", [1, 2, 3])
def test_clip_and_norms_over_the_shards(zero):
    """The clip's and the aux norms' partial sums partition differently over
    the shards: within float tolerance of zero 0's (rel 1e-6)."""
    aux = dict(with_step_stats=True)
    base = _port("adam", 2, 2, 0, clip=0.01, aux=aux)
    got = _port("adam", 2, 2, zero, clip=0.01, aux=aux)
    _close(got[0], base[0], 1e-6, 1e-7)
    for (gn0, pn0), (gn, pn) in zip(base[4], got[4]):
        assert float(gn) == pytest.approx(float(gn0), rel=1e-6)
        assert float(pn) == pytest.approx(float(pn0), rel=1e-6)


def test_zero1_digests_are_bitwise_zero0s():
    aux = dict(with_digests=True)
    a = _port("momentum", 2, 2, 0, aux=aux)[4]
    b = _port("momentum", 2, 2, 1, aux=aux)[4]
    for (da,), (db,) in zip(a, b):
        for k in ("crc_w", "crc_b", "pnorm_w", "pnorm_b", "gnorm_w", "gnorm_b"):
            assert torch.equal(da[k], db[k]), k


@pytest.mark.parametrize("zero", [1, 2])
def test_pallas_backend_is_bitwise_xla_on_cpu(zero):
    a = _port("momentum", 2, 2, zero)[0]
    b = _port("momentum", 2, 2, zero, kernel_backend="pallas")[0]
    assert _same(a, b)


def test_executor_refusals_in_jax_words():
    mesh = VirtualMesh(2, 2, "cpu")
    spec = TM.make_model_spec(SIZES, 2, B)
    prog = tlower(TS.GPipeSchedule, M, 2)
    opt = make_optimizer("momentum", LR)
    cases = [
        (dict(zero=4), "zero must be one of 0/1/2/3"),
        (dict(zero=3, kernel_backend="pallas"), "use kernel_backend='xla' with --zero 3"),
        (dict(zero=3, grad_bucket_bytes=64), "nothing to bucket at stage 3"),
        (dict(zero=2, with_digests=True), "run digests at --zero 1 or below"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=re.escape(match)):
            TE.make_pipeline_step(mesh, spec, prog, 16, opt, **kw)
    eval_prog = tlower(TS.InferenceSchedule, 1, 2, training=False)
    with pytest.raises(ValueError, match="zero1 applies to training programs only"):
        TE.make_pipeline_step(mesh, spec, eval_prog, 8, zero=1)
    with pytest.raises(ValueError, match="zero=2 applies to training programs only"):
        TE.make_pipeline_step(mesh, spec, eval_prog, 8, zero=2)
    with pytest.raises(ValueError, match="use --zero 3 without --fused-run"):
        TE.make_pipeline_run(mesh, spec, prog, 16, opt, zero=3)


# ---------------------------------------------------------------------------
# The layouts: equal to the JAX helpers' arrays, and round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["momentum", "adam"])
@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 2, 2), (4, 2, 1)])
def test_state_layouts_equal_jax_and_round_trip(opt_name, layout):
    """A trained JAX state's logical form -> the port's ZeRO-1 and ZeRO-2/3
    state tensors equal to the JAX helpers' arrays, and back to the same
    logical form; the ZeRO-3 params at rest likewise."""
    dp, pp, V = layout
    _, jst, _, (jspec, jmesh_, order) = _jax(opt_name, dp, pp, 1, virtual=V)
    logical = JE.zero1_state_to_logical(jst, jmake_optimizer(opt_name, LR), jspec, jmesh_, order=order)
    opt = make_optimizer(opt_name, LR)
    tspec = TM.make_model_spec(SIZES, pp * V, B)
    mesh = VirtualMesh(dp, pp, "cpu")
    jopt = jmake_optimizer(opt_name, LR)
    for zero, jfrom, tfrom in (
        (1, JE.zero1_state_from_logical, TE.zero1_state_from_logical),
        (2, JE.zero_block_state_from_logical, TE.zero_block_state_from_logical),
    ):
        want = jfrom(logical, jopt, jspec, jmesh_, order=order)
        got = tfrom(logical, opt, tspec, mesh, order=order)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jax.device_get(want[k])))
        back = convert.zero_opt_state_to_numpy(opt, got, tspec, mesh, zero, order=order)
        assert back["scalars"] == logical["scalars"]
        for k, part in logical["parts"].items():
            for sa, sb in zip(back["parts"][k], part):
                for la, lb in zip(sa, sb):
                    for key in ("W", "b"):
                        np.testing.assert_array_equal(la[key], np.asarray(lb[key]).reshape(la[key].shape))
    # the ZeRO-3 params at rest from the same logical params
    params = JE.unstack_params(jax.device_get(JE.init_stacked(jspec, jmesh_, order=order)[0]), jspec, order=order)
    rest, flags = convert.zero_params_from_numpy(params, tspec, mesh, order=order)
    want = JE.zero_block_flatten_rows(JE.stack_params(params, jspec, order=order)[0], jspec, jmesh_)
    np.testing.assert_array_equal(rest["P"].numpy(), want)
    again = convert.zero_params_to_numpy(rest, tspec, mesh, order=order)
    assert _same([l for s in again for l in s], [l for s in params for l in s])
    # the initial states are the JAX package's zeros
    for init_t, init_j in (
        (TE.zero1_init_state, JE.zero1_init_state),
        (TE.zero_block_init_state, JE.zero_block_init_state),
    ):
        t, j = init_t(opt, tspec, mesh), init_j(jopt, jspec, jmesh_)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(jax.device_get(j[k])))
    assert TE.zero1_init_state(make_optimizer("sgd", LR), tspec, mesh) == ()


# ---------------------------------------------------------------------------
# The session, its checkpoints and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """4 batches of 64 (tests/test_zero23.py's dataset)."""
    path = tmp_path_factory.mktemp("zero_split")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 256), ("val", 64)):
        np.save(path / f"x_{suffix}.npy", rng.randn(n, SIZES[0]).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


@pytest.fixture(scope="module")
def wide_split(tmp_path_factory):
    """The CLI trains the flagship: 2 batches of 64 at 784 wide."""
    path = tmp_path_factory.mktemp("zero_wide_split")
    rng = np.random.RandomState(1)
    for suffix, n in (("train", 128), ("val", 16)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


SESSION = dict(sizes=SIZES, global_batch_size=B, lr=0.01, optimizer="momentum",
               dp=2, pp=2, schedule="gpipe")


def _flat(params):
    return np.concatenate([l[k].ravel() for st in params for l in st for k in ("W", "b")])


@pytest.mark.parametrize(
    "zero,bucket", [(1, 0), (2, 0), (3, 0), (1, 256), (2, 256)],
    ids=["zero1", "zero2", "zero3", "zero1-bucketed", "zero2-bucketed"],
)
def test_session_matches_jax_session(split, zero, bucket):
    kw = dict(SESSION, data_dir=split, zero=zero, grad_bucket_bytes=bucket)
    js = JaxSession(**kw)
    ts = TorchSession(device="cpu", **kw)
    assert ts.train_epoch() == pytest.approx(js.train_epoch(), rel=RTOL, abs=ATOL)
    np.testing.assert_allclose(_flat(ts.params()), _flat(js.params()), rtol=RTOL, atol=ATOL)
    jl, tl = js.opt_state_logical(), ts.opt_state_logical()
    np.testing.assert_allclose(_flat(tl["parts"][""]), _flat(jl["parts"][""]), rtol=RTOL, atol=ATOL)
    ts.assert_replicas_in_sync()
    x = np.random.RandomState(5).randn(13, SIZES[0]).astype(np.float32)
    np.testing.assert_allclose(ts.predict(x), js.predict(x), rtol=1e-5, atol=1e-6)


def test_session_contracts_and_zero3_eval_view(split):
    """Sessions hold the executor's contracts end to end; the ZeRO-3 eval
    view is rebuilt after every update and reused between them, and its
    predict is bitwise the zero-2 session's."""
    runs = {}
    for name, kw in (
        ("z0", dict()), ("z1", dict(zero=1)), ("z2", dict(zero=2)), ("z3", dict(zero=3)),
        ("z2b", dict(zero=2, grad_bucket_bytes=4096)),
    ):
        s = TorchSession(device="cpu", data_dir=split, **SESSION, **kw)
        s.train_epoch()
        runs[name] = s
    h = {k: s.model_hash() for k, s in runs.items()}
    assert h["z0"] == h["z1"] == h["z2b"] and h["z2"] == h["z3"]
    x = np.random.RandomState(1).randn(40, SIZES[0]).astype(np.float32)
    z3 = runs["z3"]
    p3 = z3.predict(x)
    assert np.array_equal(p3, runs["z2"].predict(x))
    view = z3._eval_stacked()
    assert z3._eval_stacked() is view  # reused between updates
    assert z3.accuracy() == runs["z2"].accuracy()
    with pytest.raises(ValueError, match="use --zero 3 without --fused-run"):
        z3.train_run(1)
    z3.train_steps(1)
    assert z3._eval_stacked() is not view  # rebuilt after the update
    runs["z2"].train_steps(1)
    assert np.array_equal(z3.predict(x), runs["z2"].predict(x))
    assert set(z3._stacked) == {"P"}
    # the serving engine over the zero-3 session: every response bitwise a
    # direct predict() of its rows
    from shallowspeed_tpu_torch.serving import engine as tengine

    eng = tengine.ServingEngine(z3)
    reqs = [eng.submit(x[i : i + 3]) for i in range(0, 24, 3)]
    eng.drain()
    assert all(r.verdict == "ok" for r in reqs)
    for i, r in zip(range(0, 24, 3), reqs):
        assert np.array_equal(r.result, z3.predict(x[i : i + 3]))
    # the fused run composes with stages 0-2: bitwise the epoch loop
    a = TorchSession(device="cpu", data_dir=split, zero=2, grad_bucket_bytes=4096, **SESSION)
    b = TorchSession(device="cpu", data_dir=split, zero=2, grad_bucket_bytes=4096, **SESSION)
    losses, accs = a.train_run(2)
    assert losses == [b.train_epoch(), b.train_epoch()]
    assert a.model_hash() == b.model_hash() and accs[-1] == a.accuracy()


@pytest.mark.parametrize("writer", ["poison_weights", "flip_weights", "load_weights"])
def test_zero3_eval_view_is_dropped_by_every_weight_writer(split, tmp_path, writer):
    """A write to the ZeRO-3 shards outside a step drops the eval view, so
    predict reads the new weights: it equals a zero-2 session's after the
    same write."""
    z2 = TorchSession(device="cpu", data_dir=split, **SESSION, zero=2)
    z3 = TorchSession(device="cpu", data_dir=split, **SESSION, zero=3)
    x = np.random.RandomState(2).randn(16, SIZES[0]).astype(np.float32)
    z3.predict(x)
    view = z3._eval_stacked()
    if writer == "load_weights":
        donor = TorchSession(device="cpu", data_dir=split, **SESSION)
        donor.train_epoch()
        donor.save(tmp_path / "w.npz")
        for s in (z2, z3):
            s.load_weights(tmp_path / "w.npz")
    else:
        for s in (z2, z3):
            getattr(s, writer)()
    rebuilt = z3._eval_stacked()
    assert rebuilt is not view
    for k in ("W", "b"):
        for a, b in zip(rebuilt[k], z2._stacked[k]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())  # NaN == NaN here
    np.testing.assert_array_equal(z3.predict(x), z2.predict(x))


def test_checkpoints_cross_packages_and_stages(split, tmp_path):
    """A JAX zero-2 session's snapshot restores in the port at zero 1 (and a
    port zero-1 step snapshot in JAX at zero 2), bitwise at restore —
    params, momentum and the cursor — and the next epoch stays in class;
    a zero-3 snapshot loads into a sequential and a DP=4 zero-1 session."""
    js = JaxSession(data_dir=split, zero=2, **SESSION)
    js.train_epoch()
    js.save(tmp_path / "jax_z2.npz")
    ts = TorchSession(device="cpu", data_dir=split, zero=1, resume=tmp_path / "jax_z2.npz", **SESSION)
    assert ts.model_hash() == js.model_hash() and ts.epoch == js.epoch == 1
    assert _flat(ts.opt_state_logical()["parts"][""]).tobytes() == _flat(
        js.opt_state_logical()["parts"][""]
    ).tobytes()
    js.train_epoch()
    ts.train_epoch()
    np.testing.assert_allclose(_flat(ts.params()), _flat(js.params()), rtol=RTOL, atol=ATOL)

    ts = TorchSession(device="cpu", data_dir=split, zero=1, checkpoint_dir=tmp_path / "ck", **SESSION)
    ts.train_steps(3)
    path = ts.save_step_checkpoint()
    js = JaxSession(data_dir=split, zero=2, resume=path, **SESSION)
    assert js.model_hash() == ts.model_hash()
    assert (js.epoch, js.step_in_epoch) == (0, 3)
    assert _flat(js.opt_state_logical()["parts"][""]).tobytes() == _flat(
        ts.opt_state_logical()["parts"][""]
    ).tobytes()

    z3 = TorchSession(device="cpu", data_dir=split, zero=3, **SESSION)
    z3.train_epoch()
    z3.save(tmp_path / "z3.npz")
    saved = z3.opt_state_logical()
    seq = TorchSession(device="cpu", data_dir=split, resume=tmp_path / "z3.npz",
                       **dict(SESSION, dp=1, pp=1))
    dp4 = TorchSession(device="cpu", data_dir=split, resume=tmp_path / "z3.npz", zero=1,
                       **dict(SESSION, dp=4, pp=1))
    for s in (seq, dp4):
        assert s.model_hash() == z3.model_hash()
        assert _flat(s.opt_state_logical()["parts"][""]).tobytes() == _flat(saved["parts"][""]).tobytes()
    plain = TorchSession(device="cpu", data_dir=split, zero=3, **SESSION)
    plain.load_weights(tmp_path / "z3.npz")
    assert plain.model_hash() == z3.model_hash()


def test_killed_anchor_zero2_run_resumes_to_its_twin(split, tmp_path):
    kw = dict(SESSION, data_dir=split, zero=2, global_batch_size=32)
    twin = TorchSession(device="cpu", **kw)
    for _ in range(2):
        twin.train_epoch()
    ck = tmp_path / "ck"

    def drive(run):
        nb = run.batches_per_epoch
        while run.epoch < 2:
            run.train_steps(min(4 - run.global_step % 4, nb - run.step_in_epoch))
            if run.global_step % 4 == 0:
                run.save_step_checkpoint()

    killed = TorchSession(device="cpu", checkpoint_dir=ck, faults="die@step=11", **kw)
    with pytest.raises(faults.InjectedFault, match="die@step=11"):
        drive(killed)
    assert [gs for gs, _ in list_step_checkpoints(ck)] == [4, 8]
    resumed = TorchSession(device="cpu", checkpoint_dir=ck, resume="auto", **kw)
    assert resumed.global_step == 8
    drive(resumed)
    assert resumed.model_hash() == twin.model_hash()
    assert _flat(resumed.opt_state_logical()["parts"][""]).tobytes() == _flat(
        twin.opt_state_logical()["parts"][""]
    ).tobytes()


def test_session_refusals_in_jax_words(split):
    base = dict(sizes=SIZES, device="cpu")
    mesh = dict(base, dp=2, pp=2)
    cases = [
        (dict(base, zero=5), "zero must be one of"),
        (dict(base, zero1=True, zero=2), "conflicting dp-stage"),
        (dict(base, zero=2), "shards the update"),
        (dict(base, zero1=True), "zero1 shards the optimizer update"),
        (dict(mesh, zero=2, digests=True), "digests"),
        (dict(mesh, zero=3, kernel_backend="pallas"), "pallas"),
        (dict(mesh, zero=3, grad_bucket_bytes=1024), "per tick"),
        (dict(base, grad_bucket_bytes=1024), "the sequential path has no gradient sync"),
        (dict(mesh, grad_bucket_bytes=-1), "grad_bucket_bytes must be >= 0"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            TorchSession(**kw)
        with pytest.raises(ValueError, match=match):
            JaxSession(**{k: v for k, v in kw.items() if k != "device"})
    # tp composes with every stage; its pallas refusal is the JAX session's
    for zero in (1, 2, 3):
        assert TorchSession(**dict(mesh, tp=2, zero=zero)).tp == 2
    kw = dict(mesh, tp=2, zero=2, kernel_backend="pallas")
    with pytest.raises(ValueError, match="tensor parallelism") as got:
        TorchSession(**kw)
    with pytest.raises(ValueError, match="tensor parallelism") as want:
        JaxSession(**{k: v for k, v in kw.items() if k != "device"})
    assert str(got.value) == str(want.value)
    # the MPMD runtime's envelope refuses every stage, in the JAX words
    kw = dict(mesh, zero=2, runtime="mpmd")
    with pytest.raises(ValueError, match="does not support zero") as got:
        TorchSession(**kw)
    with pytest.raises(ValueError, match="does not support zero") as want:
        JaxSession(**{k: v for k, v in kw.items() if k != "device"})
    assert str(got.value) == str(want.value)


def test_grad_sync_plan_record(split, tmp_path):
    from shallowspeed_tpu.observability import JsonlMetrics as JaxJsonl
    from shallowspeed_tpu_torch.observability import JsonlMetrics

    kw = dict(SESSION, data_dir=split, zero=2, grad_bucket_bytes=4096)
    recs = []
    for cls, sink, extra in (
        (TorchSession, JsonlMetrics, dict(device="cpu")), (JaxSession, JaxJsonl, {}),
    ):
        path = tmp_path / f"{cls.__module__}.jsonl"
        m = sink(str(path))
        cls(metrics=m, **kw, **extra)
        m.close()

        recs.append([
            {k: v for k, v in r.items() if k not in ("ts", "v")}
            for r in map(json.loads, path.read_text().splitlines())
            if r.get("name") == "grad_sync_plan"
        ])
    assert len(recs[0]) == 1 and recs[0] == recs[1]


def _cli(capsys, split, *extra):
    rc = tcli.main([
        "--device", "cpu", "--data-dir", str(split), "--epochs", "1", "--no-eval",
        "--dp", "2", "--pp", "2", "--schedule", "gpipe", "--optimizer", "momentum",
        "--lr", "0.01", "--global-batch-size", "64", *extra,
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    return re.search(r"final model hash: (\w+)", out).group(1), out


def test_cli_zero_and_buckets(wide_split, capsys, monkeypatch):
    """``--zero 2 --grad-bucket-bytes`` prints zero 1's hash (the bucketed
    stage 2 is bitwise stage 1), ``--zero 3`` anchor zero 2's; the root
    CLI's refusals exit 2 with its words."""
    monkeypatch.delenv("SHALLOWSPEED_FAULTS", raising=False)
    split = wide_split
    h1, out = _cli(capsys, split, "--zero", "1")
    assert "DP replicas in sync" in out
    h2b, _ = _cli(capsys, split, "--zero", "2", "--grad-bucket-bytes", "65536")
    h2, _ = _cli(capsys, split, "--zero", "2")
    h3, _ = _cli(capsys, split, "--zero", "3")
    h1z, _ = _cli(capsys, split, "--zero1", "--kernel-backend", "pallas")
    assert h1 == h2b == h1z and h2 == h3
    for argv, match in (
        (["--zero1", "--zero", "2"], "conflicting dp-stage selectors"),
        (["--zero", "3", "--fused-run"], "--zero 3 is incompatible with --fused-run"),
        (["--zero", "3", "--kernel-backend", "pallas"], "--zero 3 is incompatible with --kernel-backend pallas"),
        (["--zero", "3", "--grad-bucket-bytes", "64"], "there is no tail collective"),
        (["--zero", "2", "--digests"], "--digests is incompatible with --zero 2"),
    ):
        with pytest.raises(SystemExit) as e:
            tcli.main(["--device", "cpu", "--data-dir", str(split), *argv])
        assert e.value.code == 2
        assert match in capsys.readouterr().err
