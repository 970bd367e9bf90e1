"""The port's multi-process runtime (shallowspeed_tpu_torch/parallel/multihost.py,
``mesh.ProcessMesh``, the executor's movers across processes, the
gradsync emitters, ``utils.assert_dp_replicas_in_sync_global``) against
the JAX package's ``tests/test_multihost.py`` surface.

- In this process: ``initialize`` is a no-op without a cluster
  environment, retries an unreachable coordinator on the JAX schedule and
  raises; NCCL on a shared device is refused; the process layouts equal the
  JAX workers' and ``shard_batch_for_process``'s rows equal the rows
  ``NamedSharding(mesh, P('dp'))`` gives each process's devices; a process
  mesh of world 1 is bitwise the ``VirtualMesh``; every refusal of the
  slice raises ``ValueError`` before any collective.
- Spawned gloo fleets on the CPU (``tests/_torch_multihost_worker.py``, the
  JAX workers' sizes): two processes (the dp sum of 1 and 2, GPipe, ZeRO-1
  with a clip, interleaved, the fused 2-epoch run, the flag-kernel backend,
  bucketed zero 0 and zero 1, inference, JSONL shards, ``p0print``, the
  session's refusal) and four (the 2x2 mesh with both axes crossing, two
  momentum steps with the global replica check after each and a detected
  desync; DP=4; DP=2 x PP=4 ZeRO-1 with two ranks a process). Every
  process's rows are held to the port's lockstep twin on a
  ``VirtualMesh`` — bitwise where the order of every sum is kept (dp = 2
  without a clip, inference), within the executor's cross-layout class
  ``rtol=3e-4, atol=3e-6`` where a norm is assembled from per-process
  partials or dp > 2 — and to the JAX executor's ``make_pipeline_step`` on
  the same mesh shape within the cross-engine class ``rtol=2e-4,
  atol=2e-6``; every process's census is clean against
  ``expected_comms``.
"""

import functools
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import jax
from shallowspeed_tpu import model as JM
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.optimizer import make_optimizer as jmake_optimizer
from shallowspeed_tpu.parallel import executor as JE
from shallowspeed_tpu.parallel import lower_schedule as jlower
from shallowspeed_tpu.parallel import make_mesh as jmesh
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import retry, utils
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch.observability import metrics as tmetrics
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel import gradsync, mpmd, multihost
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import ProcessMesh, VirtualMesh

WORKER = Path(__file__).parent / "_torch_multihost_worker.py"
SIZES, SIZES_I, B, M = (12, 10, 9, 8), (12, 11, 10, 9, 9, 8, 8, 8), 16, 2
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 3e-4, 3e-6  # cross-layout (tests/test_executor.py)

# the worker's legs: (world, layout); "bitwise" where every sum keeps the
# lockstep twin's order (dp = 2, no norm from per-process partials)
LEGS = {
    "gpipe": (2, dict(dp=2, pp=2), True),
    "zero1_clip": (2, dict(dp=2, pp=2, opt="momentum", zero=1, clip_norm=1.0), False),
    "interleaved": (2, dict(dp=2, pp=2, sizes=SIZES_I, sched="InterleavedSchedule", virtual=2), True),
    "pallas": (2, dict(dp=2, pp=2, kernel_backend="pallas"), True),
    "bucketed": (2, dict(dp=2, pp=2, grad_bucket_bytes=160), True),
    "zero1_bucketed": (2, dict(dp=2, pp=2, zero=1, grad_bucket_bytes=64), True),
    "mesh2x2": (4, dict(dp=2, pp=2, opt="momentum", steps=2), True),
    "dp4": (4, dict(dp=4, pp=1, clip_norm=0.5), False),
    "dp2pp4_zero1": (4, dict(dp=2, pp=4, sizes=SIZES_I, opt="momentum", zero=1, clip_norm=1.0), False),
    "pipedream_split": (4, dict(dp=2, pp=2, sched="PipeDreamFlushSchedule", backward_split=True), True),
    "recompute": (4, dict(dp=2, pp=2, recompute=True), True),
    "naive_adam_clip": (4, dict(dp=2, pp=2, sched="NaiveParallelSchedule", opt="adam", steps=2,
                                clip_norm=0.5), False),
    "zero1_adam": (4, dict(dp=2, pp=2, opt="adam", zero=1, steps=2), True),
}
PROG_KW = ("backward_split", "recompute")


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(B, SIZES[0]).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], B)]
    return X, Y


def _opt(name):
    return make_optimizer(name or "sgd", 0.05)


# ---------------------------------------------------------------------------
# initialize, backends, layouts, rows: in this process
# ---------------------------------------------------------------------------


def test_initialize_is_a_noop_without_a_cluster_environment(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    multihost.initialize()  # must not raise, nor touch a device
    assert not multihost.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0


def test_initialize_retries_an_unreachable_coordinator_then_raises(monkeypatch):
    calls, sleeps = [], []

    def unreachable(**kw):
        calls.append(kw)
        raise torch.distributed.DistNetworkError("client socket timed out")

    monkeypatch.setattr(multihost.dist, "init_process_group", unreachable)
    monkeypatch.setattr(multihost, "_sleep", sleeps.append)
    with pytest.raises(RuntimeError, match="timed out"):
        multihost.initialize("localhost:1", num_processes=2, process_id=1,
                             backend="gloo", device="cpu", timeout_s=5)
    assert len(calls) == 4  # the JAX schedule: 4 attempts
    assert sleeps == retry.backoff_delays(3, base=0.5, max_delay=10.0)
    assert calls[0]["init_method"] == "tcp://localhost:1"
    assert (calls[0]["world_size"], calls[0]["rank"], calls[0]["backend"]) == (2, 1, "gloo")
    assert not multihost.is_initialized()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("localhost:1", device="cpu")


def test_nccl_on_a_shared_device_is_refused(monkeypatch):
    assert multihost.check_backend(None, "cpu", 2, 0) == "gloo"
    assert multihost.check_backend(None, "cuda", 2, 2) == "nccl"
    assert multihost.check_backend("gloo", "cuda", 4, 1) == "gloo"
    with pytest.raises(ValueError, match="would share 1 visible GPU"):
        multihost.check_backend("nccl", "cuda", 2, 1)
    with pytest.raises(ValueError, match="would share 1 visible GPU"):
        multihost.check_backend(None, "cuda", 4, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        multihost.check_backend("nccl", "cpu", 2, 0)

    def never(**kw):
        raise AssertionError("joined before refusing")

    monkeypatch.setattr(multihost.dist, "init_process_group", never)
    with pytest.raises(ValueError, match="CUDA"):
        multihost.initialize("localhost:1", num_processes=2, process_id=0,
                             backend="nccl", device="cpu")


# the JAX workers' layouts (_multihost_worker.py:79-83, _multihost_worker4.py:66-71)
# and phase 21's: (dp, pp, world) -> per process (dp rows, stages)
LAYOUT_CASES = {
    (2, 2, 2): [((0,), (0, 1)), ((1,), (0, 1))],
    (2, 2, 4): [((0,), (0,)), ((0,), (1,)), ((1,), (0,)), ((1,), (1,))],
    (2, 4, 2): [((0,), (0, 1, 2, 3)), ((1,), (0, 1, 2, 3))],
    (2, 4, 4): [((0,), (0, 1)), ((0,), (2, 3)), ((1,), (0, 1)), ((1,), (2, 3))],
    (4, 1, 4): [((d,), (0,)) for d in range(4)],
    (4, 1, 2): [((0, 1), (0,)), ((2, 3), (0,))],
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES), ids=lambda c: "dp%d-pp%d-w%d" % c)
def test_process_layout_and_batch_rows_equal_jax(case):
    dp, pp, world = case
    devs = jax.devices()[: dp * pp]
    jm = jmesh(dp, pp, devices=devs)
    X = np.arange(B * 3, dtype=np.float32).reshape(B, 3)
    n = dp * pp // world
    for q in range(world):
        pm = ProcessMesh(dp, pp, world, q, "cpu")
        assert (tuple(pm.local_dp), tuple(pm.local_stages)) == LAYOUT_CASES[case][q]
        for d in pm.local_dp:
            for s in pm.local_stages:
                assert pm.owner(d, s) == q
        for spec in (("dp",), ()):
            idx = NamedSharding(jm, JP(*spec)).devices_indices_map(X.shape)
            want = sorted({r for dev in devs[q * n:(q + 1) * n] for r in range(B)[idx[dev][0]]})
            assert list(multihost.batch_rows(B, pm, spec)) == want
            got = multihost.shard_batch_for_process(X, pm, spec)
            assert got.device.type == "cpu" and torch.equal(got, torch.from_numpy(X[want]))
        assert q in pm.dp_peers(q) and q in pm.pp_peers(q)
        assert all(pm.block(p)[1] == pm.block(q)[1] for p in pm.dp_peers(q))
        assert all(pm.block(p)[0] == pm.block(q)[0] for p in pm.pp_peers(q))


def _virtual_and_world_one(zero, clip_norm, opt_name, steps=2):
    X, Y = _data()
    spec = TM.make_model_spec(SIZES, 2, B)
    prog = tlower(TS.GPipeSchedule, M, 2)
    out = []
    for mesh in (VirtualMesh(2, 2, "cpu"), multihost.make_process_mesh(2, 2, device="cpu")):
        opt = _opt(opt_name)
        stacked, flags = TE.init_stacked(spec, mesh)
        state = TE.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)
        step = TE.make_pipeline_step(mesh, spec, prog, B // 2 // M, opt, zero=zero,
                                     clip_norm=clip_norm, with_step_stats=True)
        runs = []
        for _ in range(steps):
            stacked, state, *aux = step(stacked, flags, state, torch.from_numpy(X),
                                        torch.from_numpy(Y))
            runs.append([float(a) for a in aux])
        out.append((stacked, state, runs))
    return out


@pytest.mark.parametrize("zero,clip_norm,opt_name", [(0, None, "sgd"), (0, 1.0, "adam"),
                                                     (1, 1.0, "momentum")])
def test_world_one_process_mesh_is_bitwise_the_virtual_mesh(zero, clip_norm, opt_name):
    (vs, vst, vr), (ps, pst, pr) = _virtual_and_world_one(zero, clip_norm, opt_name)
    assert vr == pr
    for k in ("W", "b"):
        for a, b in zip(vs[k], ps[k]):
            assert torch.equal(a, b)
    for (_, a), (_, b) in zip(utils._leaves(vst), utils._leaves(pst)):
        assert torch.equal(a, b)
    mesh = multihost.make_process_mesh(2, 2, device="cpu")
    assert mesh.world == 1 and mesh.local_stages == range(2) and mesh.local_dp == range(2)
    utils.assert_dp_replicas_in_sync_global(ps, TM.make_model_spec(SIZES, 2, B), mesh)


def test_refusals_on_a_process_mesh(monkeypatch):
    pm = ProcessMesh(2, 2, 2, 0, "cpu")  # no groups attached: a collective would fail
    spec = TM.make_model_spec(SIZES, 2, B)
    prog = tlower(TS.GPipeSchedule, M, 2)
    opt = _opt("sgd")
    for zero in (2, 3):
        with pytest.raises(ValueError, match=f"zero={zero} on a process mesh.*7b"):
            TE.make_pipeline_step(pm, spec, prog, 4, opt, zero=zero)
    with pytest.raises(ValueError, match="tp=2 on a process mesh.*7b"):
        ProcessMesh(2, 2, 2, 0, "cpu", tp=2)
    with pytest.raises(ValueError, match="with_digests on a process mesh"):
        TE.make_pipeline_step(pm, spec, prog, 4, opt, with_digests=True)
    eprog = tlower(TS.InferenceSchedule, 1, 2, training=False)
    with pytest.raises(ValueError, match="eval on a process mesh"):
        TE.make_pipeline_run(pm, spec, prog, 4, opt, eval_prog=eprog, eval_mubatch_size=8)
    with pytest.raises(ValueError, match="MPMD runtime.*7b"):
        mpmd.MpmdTrainRunner(pm, spec, prog, 4, opt)
    with pytest.raises(ValueError, match="do not split"):
        ProcessMesh(2, 2, 3, 0, "cpu")
    with pytest.raises(ValueError, match="block of stages"):
        ProcessMesh(3, 2, 2, 0, "cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    from shallowspeed_tpu_torch.api import TrainingSession

    with pytest.raises(ValueError, match="TrainingSession runs in one process.*7b"):
        TrainingSession(device="cpu", dp=2, pp=2)


# ---------------------------------------------------------------------------
# Spawned gloo fleets
# ---------------------------------------------------------------------------


def _run_fleet(world, outdir, timeout=150):
    """Spawn ``world`` workers on a fresh localhost port; retries on the
    (racy) port pick three times, as tests/test_multihost.py does. Returns
    (JSON of each, stdout of each)."""

    def attempt():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen([sys.executable, str(WORKER), str(p), str(world), str(port),
                              str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for p in range(world)
        ]
        outs, errs = [], []
        try:
            for p in procs:
                try:
                    out, err = p.communicate(timeout=timeout)
                except subprocess.TimeoutExpired:
                    errs.append("worker timed out (port race?)")
                    return None, errs
                errs.append(err)
                if p.returncode != 0:
                    return None, errs
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        return outs, errs

    for _ in range(3):
        outs, errs = attempt()
        if outs is not None:
            return [json.loads(o.strip().splitlines()[-1]) for o in outs], outs
    raise AssertionError(f"workers failed 3x:\n{errs[-1][-3000:]}")


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"fleet{world}")
        res, stdouts = _run_fleet(world, d)
        out[world] = dict(res=res, stdout=stdouts, dir=d)
    return out


def _leg_spec(lay):
    V = lay.get("virtual", 1)
    return TM.make_model_spec(lay.get("sizes", SIZES), lay["pp"] * V, B), V


@functools.lru_cache(maxsize=None)
def _twin(leg):
    """The leg on the port's lockstep executor (VirtualMesh, the CPU):
    (stacked numpy, state numpy leaves, losses)."""
    world, lay, _ = LEGS[leg]
    X, Y = _data()
    spec, V = _leg_spec(lay)
    mesh = VirtualMesh(lay["dp"], lay["pp"], "cpu")
    prog = tlower(getattr(TS, lay.get("sched", "GPipeSchedule")), M, lay["pp"], virtual=V,
                  **{k: lay[k] for k in PROG_KW if k in lay})
    order = TE.interleave_order(spec.n_stages, lay["pp"]) if V > 1 else None
    opt = _opt(lay.get("opt"))
    zero = lay.get("zero", 0)
    stacked, flags = TE.init_stacked(spec, mesh, order=order)
    state = TE.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)
    step = TE.make_pipeline_step(
        mesh, spec, prog, B // lay["dp"] // M, opt, zero=zero, clip_norm=lay.get("clip_norm"),
        kernel_backend=lay.get("kernel_backend", "xla"),
        grad_bucket_bytes=lay.get("grad_bucket_bytes", 0),
    )
    losses = []
    for _ in range(lay.get("steps", 1)):
        stacked, state, loss = step(stacked, flags, state, torch.from_numpy(X), torch.from_numpy(Y))
        losses.append(float(loss))
    return ({k: [a.numpy() for a in v] for k, v in stacked.items()},
            [a.numpy() for _, a in utils._leaves(state)], losses)


@functools.lru_cache(maxsize=None)
def _jax(leg):
    """The leg on the JAX executor's make_pipeline_step (XLA backend) on
    the emulated mesh of the same shape: (stacked numpy, losses)."""
    world, lay, _ = LEGS[leg]
    X, Y = _data()
    V = lay.get("virtual", 1)
    spec = JM.make_model_spec(lay.get("sizes", SIZES), lay["pp"] * V, B)
    mesh = jmesh(lay["dp"], lay["pp"])
    prog = jlower(getattr(JS, lay.get("sched", "GPipeSchedule")), M, lay["pp"], virtual=V,
                  **{k: lay[k] for k in PROG_KW if k in lay})
    order = JE.interleave_order(spec.n_stages, lay["pp"]) if V > 1 else None
    opt = jmake_optimizer(lay.get("opt") or "sgd", 0.05)
    zero1 = lay.get("zero", 0) == 1
    stacked, flags = JE.init_stacked(spec, mesh, order=order)
    state = JE.zero1_init_state(opt, spec, mesh) if zero1 else opt.init(stacked)
    step = JE.make_pipeline_step(mesh, spec, prog, B // lay["dp"] // M, opt, zero1=zero1,
                                 clip_norm=lay.get("clip_norm"))
    losses = []
    for _ in range(lay.get("steps", 1)):
        stacked, state, loss = step(stacked, flags, state, jnp.asarray(X), jnp.asarray(Y))
        losses.append(float(loss))
    return {k: [np.asarray(a) for a in v] for k, v in stacked.items()}, losses


def _rows_of(leg, pid):
    world, lay, _ = LEGS[leg]
    V = lay.get("virtual", 1)
    s = ProcessMesh(lay["dp"], lay["pp"], world, pid, "cpu").local_stages
    return slice(s.start * V, s.stop * V)


def _process_params(fleets, leg, pid):
    world = LEGS[leg][0] if leg in LEGS else 2
    z = np.load(fleets[world]["dir"] / f"{leg}.p{pid}.npz")
    n = len([k for k in z.files if k.startswith("W")])
    return {k: [z[f"{k}{l}"] for l in range(n)] for k in ("W", "b")}, z


def _close(got, want, rtol, atol):
    for k in ("W", "b"):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _equal(got, want):
    return all(np.array_equal(a, b) for k in ("W", "b") for a, b in zip(got[k], want[k]))


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_process_holds_the_twins_rows(fleets, leg):
    """Each process's rows against the lockstep twin's: bitwise where §2 of
    the contract keeps every sum's order, else within the cross-layout
    class; the losses likewise, equal on every process."""
    world, lay, bitwise = LEGS[leg]
    twin, twin_state, twin_losses = _twin(leg)
    res = fleets[world]["res"]
    for pid in range(world):
        got, z = _process_params(fleets, leg, pid)
        rows = _rows_of(leg, pid)
        want = {k: [a[rows] for a in v] for k, v in twin.items()}
        if bitwise:
            assert _equal(got, want), (leg, pid)
            assert res[pid][leg] == twin_losses
            if twin_state and not lay.get("zero"):
                # a zero-0 momentum state: the same rows of the twin's mirror
                states = [z[k] for k in z.files if k.startswith("state")]
                assert all(np.array_equal(a, b[rows]) for a, b in zip(states, twin_state))
        else:
            _close(got, want, LAYOUT_RTOL, LAYOUT_ATOL)
            np.testing.assert_allclose(res[pid][leg], twin_losses, rtol=LAYOUT_RTOL)
        assert res[pid][leg] == res[0][leg]  # every process returns the same loss


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_process_within_the_cross_engine_class_of_jax(fleets, leg):
    world, lay, _ = LEGS[leg]
    want_all, losses = _jax(leg)
    for pid in range(world):
        got, _ = _process_params(fleets, leg, pid)
        rows = _rows_of(leg, pid)
        _close(got, {k: [a[rows] for a in v] for k, v in want_all.items()}, RTOL, ATOL)
        np.testing.assert_allclose(fleets[world]["res"][pid][leg], losses, rtol=RTOL)


@pytest.mark.parametrize("leg", [l for l in LEGS if LEGS[l][1].get("zero")])
def test_zero1_state_chunks_are_the_twins(fleets, leg):
    """At zero 1 a process holds only its ranks' state chunks: its stages'
    rows and its dp ranks' columns of the twin's ``(pp, dp*chunk)`` state."""
    world, lay, bitwise = LEGS[leg]
    _, twin_state, _ = _twin(leg)
    spec, _ = _leg_spec(lay)
    _, csz = TE.zero1_flat_len(spec, VirtualMesh(lay["dp"], lay["pp"], "cpu"))
    for pid in range(world):
        _, z = _process_params(fleets, leg, pid)
        pm = ProcessMesh(lay["dp"], lay["pp"], world, pid, "cpu")
        s, d = pm.local_stages, pm.local_dp
        got = [z[k] for k in z.files if k.startswith("state")]
        assert len(got) == len(twin_state)
        for a, full in zip(got, twin_state):
            # Adam's step is a 0-d scalar every process holds
            want = full if full.ndim == 0 else full[s.start:s.stop, d.start * csz:d.stop * csz]
            assert a.shape == want.shape
            if bitwise:
                assert np.array_equal(a, want)
            else:
                np.testing.assert_allclose(a, want, rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL)


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_process_census_is_clean(fleets, leg):
    world = LEGS[leg][0]
    for r in fleets[world]["res"]:
        assert r[f"{leg}_census"] == [], (leg, r["pid"])
        assert {k for k, _ in r[f"{leg}_sites"].values()} <= {
            "all_reduce", "reduce_scatter", "all_gather", "collective_permute"}


def test_two_process_dp_sum_of_one_and_two(fleets):
    assert [r["psum"] for r in fleets[2]["res"]] == [[[3.0] * 4]] * 2


@pytest.mark.parametrize("leg,zero", [("bucketed", 0), ("zero1_bucketed", 1)])
def test_bucketed_sync_issues_one_collective_a_bucket(fleets, leg, zero):
    _, lay, _ = LEGS[leg]
    spec, _ = _leg_spec(lay)
    plan = gradsync.plan_buckets(spec, 2, 2, lay["grad_bucket_bytes"], zero=zero)
    assert plan.num_buckets >= 3
    site, kind = ("dp_sum", "all_reduce") if zero == 0 else ("zero_sum", "reduce_scatter")
    for r in fleets[2]["res"]:
        sites = r[f"{leg}_sites"]
        assert site not in sites  # no whole-tree sum beside the buckets
        got = [sites[f"{site}.bucket{i}"] for i in range(plan.num_buckets)]
        assert got == [[kind, b] for b in plan.bucket_census_bytes()]
        assert f"{site}.bucket{plan.num_buckets}" not in sites
        # the loss's sum, the buckets, and at zero 1 the gather
        assert r[f"{leg}_stats"]["collectives"] == 1 + plan.num_buckets + zero


def test_two_process_flag_backend_loss_equals_xla_and_the_run_falls(fleets):
    for r in fleets[2]["res"]:
        assert r["pallas"] == r["gpipe"]
        assert len(r["run"]) == 2 and r["run"][1] < r["run"][0]
        assert r["run"][0] == r["gpipe"][0]


def test_two_process_fused_run_is_the_twins(fleets):
    X, Y = _data()
    mesh = VirtualMesh(2, 2, "cpu")
    spec = TM.make_model_spec(SIZES, 2, B)
    stacked, flags = TE.init_stacked(spec, mesh)
    run = TE.make_pipeline_run(mesh, spec, tlower(TS.GPipeSchedule, M, 2), B // 2 // M, _opt("sgd"))
    stacked, _, losses = run(stacked, flags, (), torch.from_numpy(X)[None],
                             torch.from_numpy(Y)[None], 2)
    for pid, r in enumerate(fleets[2]["res"]):
        assert r["run"] == losses.tolist()
        got, _ = _process_params(fleets, "run", pid)
        assert _equal(got, {k: [a.numpy() for a in v] for k, v in stacked.items()})


def test_inference_rows_are_the_twins(fleets):
    """Each process's predictions are its dp rows of the twin's, bitwise:
    two processes each with whole replicas, and four where the head stage's
    process hands its rows to the other stage's."""
    X, _ = _data()
    spec = TM.make_model_spec(SIZES, 2, B)
    mesh = VirtualMesh(2, 2, "cpu")
    stacked, flags = TE.init_stacked(spec, mesh)
    infer = TE.make_pipeline_step(mesh, spec, tlower(TS.InferenceSchedule, M, 2, training=False),
                                  B // 2 // M)
    want = infer(stacked, flags, torch.from_numpy(X)).numpy()
    for world, name in ((2, "infer"), (4, "infer4")):
        for pid in range(world):
            got = np.load(fleets[world]["dir"] / f"{name}.p{pid}.npy")
            d = ProcessMesh(2, 2, world, pid, "cpu").local_dp.start
            assert np.array_equal(got, want[d * B // 2:(d + 1) * B // 2]), (world, pid)
    # the gathered tree's hash on every process is the init's
    want_hash = utils.model_hash(TE.unstack_params(stacked, spec))
    assert [r["hash"] for r in fleets[2]["res"]] == [want_hash] * 2


def test_jsonl_shard_a_process_and_p0print_once(fleets):
    d = fleets[2]["dir"]
    assert [r["jsonl_path"] for r in fleets[2]["res"]] == [f"{d / 'm.jsonl'}.p{p}" for p in range(2)]
    recs = [r for r in tmetrics.read_jsonl(d / "m.jsonl") if r.get("name") == "hello"]
    assert sorted(r["pid"] for r in recs) == [0, 1]
    assert sum(o.count("p0print from process 0") for o in fleets[2]["stdout"]) == 1
    assert "p0print" in fleets[2]["stdout"][0]


def test_session_refused_on_a_process_group(fleets):
    assert all(r["session_refused"] for r in fleets[2]["res"])


@pytest.mark.parametrize("zero", [0, 1])
def test_step_stats_norms_over_every_process(fleets, zero):
    """The loss, the pre-clip grad norm and the post-update param norm of a
    2x2 step over four processes: the same on every process, and within the
    cross-layout class of the twin's (squares summed from per-process
    partials)."""
    X, Y = _data()
    spec = TM.make_model_spec(SIZES, 2, B)
    mesh = VirtualMesh(2, 2, "cpu")
    stacked, flags = TE.init_stacked(spec, mesh)
    opt = _opt("momentum")
    state = TE.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)
    step = TE.make_pipeline_step(mesh, spec, tlower(TS.GPipeSchedule, M, 2), B // 2 // M, opt,
                                 zero=zero, clip_norm=0.5, with_step_stats=True)
    want = [float(v) for v in step(stacked, flags, state, torch.from_numpy(X),
                                   torch.from_numpy(Y))[2:]]
    got = [r[f"stats{zero}"] for r in fleets[4]["res"]]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], want, rtol=LAYOUT_RTOL)


def test_four_process_2x2_replicas_in_sync_and_desync_detected(fleets):
    """Both axes cross processes; the global check passed after each of
    two momentum steps on params and state (the worker exits non-zero
    otherwise), training progressed, and a copy diverged on process 3 was
    detected on every process."""
    res = fleets[4]["res"]
    assert all(r["mesh2x2"][1] < r["mesh2x2"][0] for r in res)
    for r in res:
        assert r["desync_detected"].startswith("cross-process replica desync at (leaf, shard-index)")
        assert "(0, 1)" in r["desync_detected"]  # W slot 0 of stage row 1, process 3's
    # every relay crossed a process: each process sent and received
    assert all(r["mesh2x2_stats"]["sends"] == r["mesh2x2_stats"]["recvs"] > 0 for r in res)
    assert all(r["dp2pp4_zero1_stats"]["sends"] > 0 for r in res)
    assert all(r["dp4_stats"]["sends"] == 0 for r in res)
