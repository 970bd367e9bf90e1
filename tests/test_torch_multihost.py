"""The port's multi-process runtime (shallowspeed_tpu_torch/parallel/multihost.py,
``mesh.ProcessMesh``, the executor's movers across processes, the
gradsync emitters, ``utils.assert_dp_replicas_in_sync_global``) against
the JAX package's ``tests/test_multihost.py`` surface.

- In this process: ``initialize`` is a no-op without a cluster
  environment, retries an unreachable coordinator on the JAX schedule and
  raises; NCCL on a shared device is refused; the process layouts equal the
  JAX workers' and ``shard_batch_for_process``'s rows equal the rows
  ``NamedSharding(mesh, P('dp'))`` gives each process's devices; at tp > 1
  every allowed ``(dp, pp, tp, world)`` up to 8 ranks gives each process
  the JAX device order's block, and tp = 1 keeps the ``(dp, pp)`` layout
  and groups; a process mesh of world 1 is bitwise the ``VirtualMesh``;
  what stays refused raises ``ValueError`` before any collective.
- Spawned gloo fleets on the CPU (``tests/_torch_multihost_worker.py``, the
  JAX workers' sizes, every leg of its ``LEGS``): two processes (the dp
  sum of 1 and 2, GPipe, ZeRO-1 with a clip, interleaved, the flag-kernel
  backend, bucketed zero 0, 1 and 2, zero 2 and 3, tp of 2 and 4 across
  processes, digests, the fused 2-epoch run with and without its eval,
  inference, JSONL shards, ``p0print``, the session's refusal) and four
  (the 2x2 mesh with both axes crossing, DP=4, DP=2 x PP=4 ZeRO-1, the
  lattice, zero 2 and 3 on the 2x2 mesh, DP=2 x TP=2 with tp crossing at
  zero 0 and 3, DP=2 x PP=2 x TP=2 with tp inside a process, DP=4 zero 2
  with a clip, ZeRO-1 digests, tp of 4 a rank a process; a diverged stage
  row and a diverged tp band detected). Every process's rows, bands and
  shards are held to the port's lockstep twin on a ``VirtualMesh`` —
  bitwise where the order of every sum is kept (dp = 2 and tp = 2 inside
  a process without a norm from partials, inference), within the
  executor's cross-layout class ``rtol=3e-4, atol=3e-6`` where a norm is
  assembled from per-process partials, dp > 2 sums over processes, or tp
  crosses processes (each multiplies its own ranks' bands only) — and to the
  JAX executor's ``make_pipeline_step`` on the same mesh shape within the
  cross-engine class ``rtol=2e-4, atol=2e-6``; replicas hash-equal after
  every step; every process's census is clean against ``expected_comms``.
"""

import functools
import importlib.util
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
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 3e-4, 3e-6  # cross-layout (tests/test_executor.py)


def _load_worker():
    spec = importlib.util.spec_from_file_location("_torch_multihost_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # its top imports the standard library only
    return mod


_W = _load_worker()
SIZES, SIZES_I, B, M = _W.SIZES, _W.SIZES_I, _W.B, _W.M
# the worker's legs: (world, layout, bitwise) — "bitwise" where every sum
# keeps the lockstep twin's order (dp = 2, tp = 2 inside a process, no norm
# from per-process partials) and every product has the twin's shape: where
# tp crosses processes a process multiplies its held ranks' bands only, a
# product batched over fewer ranks than the twin's, which may reduce
# otherwise
NOT_BITWISE = {"zero1_clip", "dp4", "dp2pp4_zero1", "naive_adam_clip", "tp4", "dp4_zero2_clip",
               "tp4_digests", "tp2", "dp2tp2", "dp2tp2_zero3"}
LEGS = {leg: (world, lay, leg not in NOT_BITWISE) for leg, (world, lay) in _W.LEGS.items()}
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


def _layouts(max_ranks=8):
    """Every ``(dp, pp, tp, world)`` with ``dp*pp*tp <= max_ranks`` and
    ``world`` dividing the ranks."""
    for dp in range(1, max_ranks + 1):
        for pp in range(1, max_ranks // dp + 1):
            for tp in range(1, max_ranks // (dp * pp) + 1):
                ranks = dp * pp * tp
                for world in range(1, ranks + 1):
                    if ranks % world == 0:
                        yield dp, pp, tp, world


def test_process_layout_at_tp_is_the_jax_device_order():
    """At every allowed layout up to 8 ranks, process ``q`` owns exactly
    the mesh positions of the JAX devices ``q*n .. (q+1)*n - 1`` (the
    order-preserving ``make_mesh(dp, pp, tp=tp)``), its groups are the
    processes sharing the other axes, and a refused layout is one whose
    device blocks are not such a product; at tp = 1 the layout and groups
    are the ``(dp, pp)`` ones unchanged."""
    devs = jax.devices()
    allowed = refused = 0
    for dp, pp, tp, world in _layouts():
        ranks = dp * pp * tp
        n = ranks // world
        coords = np.argwhere(np.ones((dp, pp, tp), bool))  # flat order = device order
        jm = jmesh(dp, pp, devices=devs[:ranks], tp=tp)
        # a device's (d, s, t); the tp = 1 mesh has no tp axis
        pos = {dev.id: (tuple(int(c) for c in np.argwhere(jm.devices == dev)[0]) + (0,))[:3]
               for dev in devs[:ranks]}
        assert [pos[d.id] for d in devs[:ranks]] == [tuple(int(v) for v in c) for c in coords]
        try:
            layouts = [ProcessMesh(dp, pp, world, q, "cpu", tp=tp) for q in range(world)]
        except ValueError as e:
            refused += 1
            assert "ranks a process over" in str(e) or "positions a process" in str(e)
            continue
        allowed += 1
        for q, pm in enumerate(layouts):
            want = sorted(pos[d.id] for d in devs[q * n:(q + 1) * n])
            got = sorted((d, s, t) for d in pm.local_dp for s in pm.local_stages for t in pm.local_tp)
            assert got == want, (dp, pp, tp, world, q)
            assert all(pm.owner(*c) == q for c in got)
            r = pm.device_rows
            assert list(r) == sorted(s * tp + t for s in pm.local_stages for t in pm.local_tp)
            for peers, same in ((pm.dp_peers(q), (1, 2)), (pm.pp_peers(q), (0, 2)),
                                (pm.tp_peers(q), (0, 1))):
                assert q in peers
                assert list(peers) == [p for p in range(world)
                                       if all(layouts[p].ranks()[i] == pm.ranks()[i] for i in same)]
            if tp == 1:
                # the (dp, pp) layout and groups, unchanged
                assert pm.local_tp == range(1) and pm.shape == {"dp": dp, "pp": pp}
                old = [("mesh", tuple(range(world)))]
                for kind, i in (("dp", 1), ("pp", 0)):
                    gs = {tuple(p for p in range(world) if pm.block(p)[i] == pm.block(x)[i])
                          for x in range(world)}
                    old += [(kind, g) for g in sorted(gs) if len(g) > 1]
                assert pm.groups() == old
                assert not pm.tp_peers(q)[1:]
    assert allowed > 40 and refused > 5


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
    """What stays refused across processes, before any collective: the MPMD
    runtime and the session (ROADMAP item 7b), the JAX executor's own
    refusals (the flag kernels at zero 3 and at tp > 1, digests at zero 2),
    and the layouts that do not split."""
    pm = ProcessMesh(2, 2, 2, 0, "cpu")  # no groups attached: a collective would fail
    spec = TM.make_model_spec(SIZES, 2, B)
    prog = tlower(TS.GPipeSchedule, M, 2)
    opt = _opt("sgd")
    with pytest.raises(ValueError, match="use kernel_backend='xla' with --zero 3"):
        TE.make_pipeline_step(pm, spec, prog, 4, opt, zero=3, kernel_backend="pallas")
    with pytest.raises(ValueError, match="use kernel_backend='xla' with --tp"):
        TE.make_pipeline_step(ProcessMesh(2, 2, 4, 0, "cpu", tp=2), spec, prog, 4, opt,
                              kernel_backend="pallas")
    with pytest.raises(ValueError, match="run digests at --zero 1 or below"):
        TE.make_pipeline_step(pm, spec, prog, 4, opt, zero=2, with_digests=True)
    with pytest.raises(ValueError, match="MPMD runtime.*7b"):
        mpmd.MpmdTrainRunner(pm, spec, prog, 4, opt)
    with pytest.raises(ValueError, match="do not split"):
        ProcessMesh(2, 2, 3, 0, "cpu")
    with pytest.raises(ValueError, match="block of stages"):
        ProcessMesh(3, 2, 2, 0, "cpu")
    with pytest.raises(ValueError, match="tp=2 x .* do not split|do not split"):
        ProcessMesh(1, 1, 4, 0, "cpu", tp=2)
    with pytest.raises(ValueError, match="ranks a process over tp=2"):
        ProcessMesh(3, 1, 2, 0, "cpu", tp=2)
    with pytest.raises(ValueError, match="positions a process over pp=3"):
        ProcessMesh(2, 3, 3, 0, "cpu", tp=2)
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


def _state_init(E, opt, spec, mesh, zero, stacked):
    if zero >= 2:
        return E.zero_block_init_state(opt, spec, mesh)
    return E.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)


@functools.lru_cache(maxsize=None)
def _twin(leg):
    """The leg on the port's lockstep executor (VirtualMesh, the CPU):
    (full stacked numpy — ``{"P"}`` at zero 3 — state numpy leaves, losses,
    digests)."""
    world, lay, _ = LEGS[leg]
    X, Y = _data()
    spec, V = _leg_spec(lay)
    tp = lay.get("tp", 1)
    mesh = VirtualMesh(lay["dp"], lay["pp"], "cpu", tp=tp)
    prog = tlower(getattr(TS, lay.get("sched", "GPipeSchedule")), M, lay["pp"], virtual=V,
                  **{k: lay[k] for k in PROG_KW if k in lay})
    order = TE.interleave_order(spec.n_stages, lay["pp"]) if V > 1 else None
    opt = _opt(lay.get("opt"))
    zero = lay.get("zero", 0)
    stacked, flags = TE.init_stacked(spec, mesh, order=order)
    state = _state_init(TE, opt, spec, mesh, zero, stacked)
    if zero == 3:
        stacked = TE.zero_params_at_rest(
            {k: tuple(a.numpy() for a in v) for k, v in stacked.items()}, spec, mesh)
    step = TE.make_pipeline_step(
        mesh, spec, prog, B // lay["dp"] // M, opt, zero=zero, clip_norm=lay.get("clip_norm"),
        kernel_backend=lay.get("kernel_backend", "xla"),
        grad_bucket_bytes=lay.get("grad_bucket_bytes", 0),
        with_digests=lay.get("with_digests", False),
    )
    losses, digests = [], []
    for _ in range(lay.get("steps", 1)):
        out = step(stacked, flags, state, torch.from_numpy(X), torch.from_numpy(Y))
        stacked, state, loss = out[:3]
        losses.append(float(loss))
        if lay.get("with_digests"):
            digests.append({k: v.tolist() for k, v in out[-1].items()})
    return ({k: [a.numpy() for a in v] if k != "P" else v.numpy() for k, v in stacked.items()},
            [a.numpy() for _, a in utils._leaves(state)], losses, digests)


@functools.lru_cache(maxsize=None)
def _jax(leg):
    """The leg on the JAX executor's make_pipeline_step (XLA backend) on
    the emulated mesh of the same shape: (full stacked numpy, losses)."""
    world, lay, _ = LEGS[leg]
    X, Y = _data()
    V = lay.get("virtual", 1)
    spec = JM.make_model_spec(lay.get("sizes", SIZES), lay["pp"] * V, B)
    mesh = jmesh(lay["dp"], lay["pp"], tp=lay.get("tp", 1))
    prog = jlower(getattr(JS, lay.get("sched", "GPipeSchedule")), M, lay["pp"], virtual=V,
                  **{k: lay[k] for k in PROG_KW if k in lay})
    order = JE.interleave_order(spec.n_stages, lay["pp"]) if V > 1 else None
    opt = jmake_optimizer(lay.get("opt") or "sgd", 0.05)
    zero = lay.get("zero", 0)
    stacked, flags = JE.init_stacked(spec, mesh, order=order)
    state = _state_init(JE, opt, spec, mesh, zero, stacked)
    if zero == 3:
        rows = JE.zero_block_flatten_rows(jax.device_get(stacked), spec, mesh)
        stacked = {"P": jax.device_put(rows, JE.zero1_part_sharding(mesh))}
    step = JE.make_pipeline_step(mesh, spec, prog, B // lay["dp"] // M, opt, zero=zero,
                                 clip_norm=lay.get("clip_norm"),
                                 grad_bucket_bytes=lay.get("grad_bucket_bytes", 0))
    losses = []
    for _ in range(lay.get("steps", 1)):
        stacked, state, loss = step(stacked, flags, state, jnp.asarray(X), jnp.asarray(Y))
        losses.append(float(loss))
    if zero == 3:
        host = JE.zero_block_unflatten_rows(np.asarray(jax.device_get(stacked["P"])), spec, mesh)
    else:
        host = jax.device_get(stacked)
    return {k: [np.asarray(a) for a in v] for k, v in host.items()}, losses


def _pm(leg, pid):
    world, lay, _ = LEGS[leg]
    return ProcessMesh(lay["dp"], lay["pp"], world, pid, "cpu", tp=lay.get("tp", 1))


def _chunks_of(full, leg, pid):
    """A process's chunks of a ``(pp*tp, dp*chunk)`` ZeRO tensor: its
    device rows and its dp ranks' columns."""
    return TE.local_chunks(full, _pm(leg, pid))


def _share_of(full, leg, pid):
    """A process's share of a full stacked tree (``{W, b}`` lists, or the
    ZeRO-3 ``{"P"}`` rows): its stages' rows and tp bands, or its chunks."""
    if "P" in full:
        return {"P": _chunks_of(full["P"], leg, pid)}
    spec, _ = _leg_spec(LEGS[leg][1])
    return {k: list(v) for k, v in TE.local_stacked(full, spec, _pm(leg, pid)).items()}


def _process_params(fleets, leg, pid, world=None):
    world = world or (LEGS[leg][0] if leg in LEGS else 2)
    z = np.load(fleets[world]["dir"] / f"{leg}.p{pid}.npz")
    if "P" in z.files:
        return {"P": z["P"]}, z
    n = len([k for k in z.files if k.startswith("W")])
    return {k: [z[f"{k}{l}"] for l in range(n)] for k in ("W", "b")}, z


def _pairs(got, want):
    if "P" in got:
        return [(got["P"], want["P"])]
    return [(a, b) for k in ("W", "b") for a, b in zip(got[k], want[k])]


def _close(got, want, rtol, atol):
    for a, b in _pairs(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _equal(got, want):
    return all(a.shape == b.shape and np.array_equal(a, b) for a, b in _pairs(got, want))


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_process_holds_the_twins_rows(fleets, leg):
    """Each process's rows, tp bands or ZeRO-3 shard against the lockstep
    twin's: bitwise where §2 of the contract keeps every sum's order, else
    within the cross-layout class; the losses likewise, equal on every
    process."""
    world, lay, bitwise = LEGS[leg]
    twin, twin_state, twin_losses, _ = _twin(leg)
    res = fleets[world]["res"]
    L = len(twin.get("W", ()))
    for pid in range(world):
        got, z = _process_params(fleets, leg, pid)
        want = _share_of(twin, leg, pid)
        if bitwise:
            assert _equal(got, want), (leg, pid)
            assert res[pid][leg] == twin_losses
            if len(twin_state) == 2 * L and not lay.get("zero"):
                # a zero-0 momentum state: the same share of the twin's mirror
                states = [z[k] for k in z.files if k.startswith("state")]
                mirror = {"W": twin_state[:L], "b": twin_state[L:]}
                assert _equal({"W": states[:L], "b": states[L:]}, _share_of(mirror, leg, pid))
        else:
            _close(got, want, LAYOUT_RTOL, LAYOUT_ATOL)
            np.testing.assert_allclose(res[pid][leg], twin_losses, rtol=LAYOUT_RTOL)
        assert res[pid][leg] == res[0][leg]  # every process returns the same loss


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_process_within_the_cross_engine_class_of_jax(fleets, leg):
    world, lay, _ = LEGS[leg]
    want_all, losses = _jax(leg)
    spec, _ = _leg_spec(lay)
    if lay.get("zero") == 3:
        mesh = VirtualMesh(lay["dp"], lay["pp"], "cpu", tp=lay.get("tp", 1))
        want_all = {"P": TE.zero_block_flatten_rows(want_all, spec, mesh)}
    for pid in range(world):
        got, _ = _process_params(fleets, leg, pid)
        _close(got, _share_of(want_all, leg, pid), RTOL, ATOL)
        np.testing.assert_allclose(fleets[world]["res"][pid][leg], losses, rtol=RTOL)


@pytest.mark.parametrize("leg", [l for l in LEGS if LEGS[l][1].get("zero")])
def test_zero1_state_chunks_are_the_twins(fleets, leg):
    """At zero >= 1 a process holds only its ranks' state chunks: its
    device rows and its dp ranks' columns of the twin's ``(pp*tp,
    dp*chunk)`` state (the flat layout at zero 1, the block-cyclic one at 2
    and 3)."""
    world, lay, bitwise = LEGS[leg]
    _, twin_state, _, _ = _twin(leg)
    for pid in range(world):
        _, z = _process_params(fleets, leg, pid)
        got = [z[k] for k in z.files if k.startswith("state")]
        assert len(got) == len(twin_state)
        for a, full in zip(got, twin_state):
            # Adam's step is a 0-d scalar every process holds
            want = full if full.ndim == 0 else _chunks_of(full, leg, pid)
            assert a.shape == want.shape
            if bitwise:
                assert np.array_equal(a, want)
            else:
                np.testing.assert_allclose(a, want, rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL)


@pytest.mark.parametrize("leg", [l for l in LEGS if LEGS[l][1].get("with_digests")])
def test_digest_grids_are_the_twins(fleets, leg):
    """Every process returns the whole ``(S, L)`` digest grids, the same on
    every process: the checksums exactly the twin's, the norms bitwise
    where every sum keeps its order (a row whole in one process), within
    the cross-layout class where a row's squares come from tp bands."""
    world, lay, bitwise = LEGS[leg]
    _, _, _, want = _twin(leg)
    res = fleets[world]["res"]
    for r in res:
        got = r[f"{leg}_digests"]
        assert got == res[0][f"{leg}_digests"] and len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                if bitwise:
                    assert g[k] == w[k], (leg, k)
                elif not k.startswith("crc"):
                    np.testing.assert_allclose(g[k], w[k], rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL)
    if not bitwise:
        # the params are the twin's within the class only: the last step's
        # checksums are the ones of the rows the processes hold, each row
        # summed from its bands' words (mod 2^32)
        shares = [_process_params(fleets, leg, pid)[0] for pid in range(world)]
        for key, kind in (("crc_w", "W"), ("crc_b", "b")):
            for l in range(len(shares[0][kind])):
                words = sum(int(np.sum(sh[kind][l].view(np.int32).astype(np.int64))) for sh in shares)
                assert res[0][f"{leg}_digests"][-1][key][0][l] == words & 0xFFFFFFFF


@pytest.mark.parametrize("leg", list(LEGS))
def test_every_process_census_is_clean(fleets, leg):
    world = LEGS[leg][0]
    for r in fleets[world]["res"]:
        assert r[f"{leg}_census"] == [], (leg, r["pid"])
        assert {k for k, _ in r[f"{leg}_sites"].values()} <= {
            "all_reduce", "reduce_scatter", "all_gather", "collective_permute"}


def test_two_process_dp_sum_of_one_and_two(fleets):
    assert [r["psum"] for r in fleets[2]["res"]] == [[[3.0] * 4]] * 2


@pytest.mark.parametrize("leg,zero", [("bucketed", 0), ("zero1_bucketed", 1), ("zero2_bucketed", 2)])
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
        # the loss's sum, the buckets, and at zero 1 and 2 the gather
        assert r[f"{leg}_stats"]["collectives"] == 1 + plan.num_buckets + (zero > 0)


def test_per_tick_zero_collectives_a_slot_and_a_stage(fleets):
    """Anchor zero 2 and zero 3 across processes: one reduce-scatter a
    slot (W and b) and backward tick of each held stage, and at zero 3 one
    parameter all-gather a stage and tick that computes, over the dp
    group; no whole-tree sum."""
    for leg in ("zero2_pallas", "zero3"):
        _, lay, _ = LEGS[leg]
        spec, _ = _leg_spec(lay)
        L = len(TE.slot_shapes(spec))
        prog = tlower(TS.GPipeSchedule, M, 2)
        ops = np.asarray(prog.op)
        # every process holds both stages: its active slots a backward tick
        flags = TE.stack_params(TM.init_model(spec), spec)[1]["active"]
        bwd = sum(int(flags[s].sum()) for t, s in zip(*np.nonzero(ops == 2)))
        fwd_bwd = int(np.sum((ops == 1) | (ops == 2)))
        for r in fleets[2]["res"]:
            sites = r[f"{leg}_sites"]
            assert "dp_sum" not in sites and "zero_sum" not in sites
            assert sum("zero_scatter" in k for k in sites) == 2 * L
            want = 2 * bwd + 1 + (fwd_bwd if lay["zero"] == 3 else 1)
            assert r[f"{leg}_stats"]["collectives"] == want, (leg, r[f"{leg}_stats"])


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


@pytest.mark.parametrize("world,leg", [(2, "run_eval"), (4, "run_eval4")])
def test_fused_run_eval_is_the_twins(fleets, world, leg):
    """The fused 2-epoch run with its in-run eval on a process mesh: each
    process counts its dp rows' correct predictions inside the split, one
    all-reduce over dp makes the count; losses, accuracies and the rows
    bitwise the twin's (dp = 2), on two processes and on four (the head
    stage's process hands its predictions to its pp group)."""
    X, Y = _data()
    vr = np.random.RandomState(1)
    VX = np.zeros((_W.VAL_PADDED, SIZES[0]), np.float32)
    VX[:_W.VAL_ROWS] = vr.randn(_W.VAL_ROWS, SIZES[0])
    VY = vr.randint(0, SIZES[-1], _W.VAL_ROWS)
    mesh = VirtualMesh(2, 2, "cpu")
    spec = TM.make_model_spec(SIZES, 2, B)
    stacked, flags = TE.init_stacked(spec, mesh)
    run = TE.make_pipeline_run(mesh, spec, tlower(TS.GPipeSchedule, M, 2), B // 2 // M, _opt("sgd"),
                               eval_prog=tlower(TS.InferenceSchedule, 1, 2, training=False),
                               eval_mubatch_size=_W.VAL_PADDED // 2)
    stacked, _, losses, accs = run(stacked, flags, (), torch.from_numpy(X)[None],
                                   torch.from_numpy(Y)[None], torch.from_numpy(VX),
                                   torch.from_numpy(VY), 2)
    assert 0 < float(accs[-1]) < 1
    want = {k: [a.numpy() for a in v] for k, v in stacked.items()}
    for pid, r in enumerate(fleets[world]["res"]):
        assert r[leg] == {"losses": losses.tolist(), "accs": accs.tolist()}
        got, _ = _process_params(fleets, leg, pid, world)
        pm = ProcessMesh(2, 2, world, pid, "cpu")
        assert _equal(got, {k: list(v) for k, v in TE.local_stacked(want, spec, pm).items()})


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
    """Both axes cross processes; the global check passed after each step
    of every leg on params and state (the worker exits non-zero
    otherwise), training progressed, and a copy diverged on process 3 was
    detected on every process: a stage row of the 2x2 mesh, and a tp band
    of DP=2 x TP=2 (compared only with the same band of the other dp
    replica). ``gather_stacked`` rebuilds the full tree from rows, bands
    and ZeRO-3 shards on every process."""
    res = fleets[4]["res"]
    assert all(r["mesh2x2"][1] < r["mesh2x2"][0] for r in res)
    for r in res:
        for leg in ("mesh2x2", "dp2tp2"):
            assert r[f"{leg}_desync"].startswith("cross-process replica desync at (leaf, shard-index)")
            assert r[f"{leg}_gathered"]
        assert "(0, 1)" in r["mesh2x2_desync"]  # W slot 0 of stage row 1, process 3's
        assert "[(0, 0, 1)]" in r["dp2tp2_desync"]  # W slot 0, stage row 0, process 3's band 1
    # every relay crossed a process: each process sent and received
    assert all(r["mesh2x2_stats"]["sends"] == r["mesh2x2_stats"]["recvs"] > 0 for r in res)
    assert all(r["dp2pp4_zero1_stats"]["sends"] > 0 for r in res)
    assert all(r["dp4_stats"]["sends"] == 0 for r in res)
    # tp across processes: one Megatron all-reduce a sum site and
    # microbatch over the tp group, then the loss's and the gradient's sums
    # over dp; no relay (pp = 1)
    fwd, bwd = TE.tp_allreduce_sites(TM.make_model_spec(SIZES, 1, B), 2)
    for r in res:
        assert r["dp2tp2_stats"]["sends"] == 0
        assert r["dp2tp2_stats"]["collectives"] == M * (len(fwd) + len(bwd)) + 2
