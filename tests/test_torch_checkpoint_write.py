"""The checkpoint write path of the port against the JAX package's: the
snapshot stages, the file format both ways, rotation, and the async writer.

The format is the JAX package's, so the same state must build the same
arrays, metadata and checksum, a file either package writes must verify and
load in the other, and a directory the port rotated must be one the JAX
package's discovery reads. The zip bytes carry timestamps, so files are
compared by their arrays, metadata and checksum, not byte for byte.
"""

import threading
import time

import numpy as np
import pytest

from shallowspeed_tpu import checkpoint as jckpt
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import faults
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import (
    CheckpointError,
    find_latest_good,
    list_step_checkpoints,
    step_checkpoint_path,
    verify_checkpoint,
)

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
GBS = 32
BATCHES = 6  # batches per epoch of the split


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt_split")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", BATCHES * GBS + 5), ("val", 40)):
        np.save(path / f"x_{suffix}.npy", rng.rand(n, SIZES[0]).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


def _session(cls, split, **kw):
    kw.setdefault("sizes", SIZES)
    kw.setdefault("global_batch_size", GBS)
    kw.setdefault("lr", 0.01)
    if cls is TorchSession:
        kw["device"] = "cpu"
    return cls(data_dir=split, **kw)


def _contents(path):
    """A file's arrays and metadata, as the JAX reader sees them."""
    meta, arrays = jckpt.verify_checkpoint(path, require_finite=True, with_arrays=True)
    return meta, {k: v for k, v in arrays.items() if k != "meta"}


def _assert_same_contents(a, b):
    (ma, xa), (mb, xb) = a, b
    assert ma == mb  # the metadata, checksum and all_finite included
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and xa[k].tobytes() == xb[k].tobytes(), k


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_build_snapshot_matches_jax(split, opt):
    """The same logical state builds the same arrays and metadata, and
    stamps the same checksum and finiteness flag."""
    ts = _session(TorchSession, split, optimizer=opt)
    ts.train_steps(3)
    kw = dict(
        extra={"optimizer": {"name": opt, "lr": 0.01}}, opt_state=ts.opt_state_logical(),
        step_in_epoch=3, global_step=3,
    )
    ours = C.build_snapshot(ts.params(), ts.spec, 0, **kw)
    theirs = jckpt.build_snapshot(ts.params(), ts.spec, 0, **kw)
    assert C.stamp_verification(*ours) == jckpt.stamp_verification(*theirs) is True
    _assert_same_contents(ours[::-1], theirs[::-1])
    assert C.content_checksum(ours[0]) == jckpt.content_checksum(theirs[0]) == ours[1]["checksum"]
    assert {"ow0", "o_m_w0", "o_v_b6"} & set(ours[0]) == {
        "sgd": set(), "momentum": {"ow0"}, "adam": {"o_m_w0", "o_v_b6"}
    }[opt]


@pytest.mark.parametrize("layout", [dict(), dict(dp=2, pp=4)], ids=["sequential", "dp2xpp4"])
def test_step_checkpoint_files_equal_jax_and_load_both_ways(split, tmp_path, layout):
    """A step checkpoint of the port and of the JAX session at the same
    state (init, Adam, a step cursor of 0) hold the same arrays, metadata
    and checksum; each package verifies and loads the other's file."""
    ts = _session(TorchSession, split, optimizer="adam", checkpoint_dir=tmp_path / "t", **layout)
    js = _session(JaxSession, split, optimizer="adam", checkpoint_dir=tmp_path / "j")
    tp, jp = ts.save_step_checkpoint(), js.save_step_checkpoint()
    _assert_same_contents(_contents(tp), _contents(jp))
    for path in (tp, jp):
        assert C.verify_checkpoint(path, require_finite=True)["global_step"] == 0
        t_params, _, t_meta, t_opt = C.load_checkpoint(path, 4, with_opt_state=True)
        j_params, _, j_meta, j_opt = jckpt.load_checkpoint(path, 4, with_opt_state=True)
        assert t_meta == j_meta and t_opt["scalars"] == j_opt["scalars"] == {"t": 0.0}
        for ts_, js_ in zip(t_params, j_params):
            for lt, lj in zip(ts_, js_):
                assert lt["W"].tobytes() == np.asarray(lj["W"]).tobytes()
    # and the resumed session carries the other package's state bitwise
    resumed = _session(TorchSession, split, optimizer="adam", resume=jp, **layout)
    assert resumed.model_hash() == ts.model_hash() and resumed.resumed_from == str(jp)


def test_jax_discovery_reads_a_directory_the_port_rotated(split, tmp_path):
    ck = tmp_path / "ck"
    ts = _session(TorchSession, split, checkpoint_dir=ck, checkpoint_keep=2)
    hashes = {}
    for _ in range(4):
        ts.train_steps(1)
        ts.save_step_checkpoint()
        hashes[ts.global_step] = ts.model_hash()
    assert [gs for gs, _ in jckpt.list_step_checkpoints(ck)] == [3, 4]
    faults.corrupt_checkpoint_bytes(step_checkpoint_path(ck, 4))
    path, meta, skipped = jckpt.find_latest_good(ck)
    assert path.name == "step-00000003.npz" and meta["global_step"] == 3
    assert len(skipped) == 1 and skipped[0][0].name == "step-00000004.npz"
    assert find_latest_good(ck)[0] == path  # the port's discovery agrees
    # the watcher's and the bisect's discovery agree with the JAX package's
    for than in (None, 2, 3):
        ours = C.find_newer_good(ck, than_step=than, with_arrays=True)
        theirs = jckpt.find_newer_good(ck, than_step=than, with_arrays=True)
        assert ours[:3] == theirs[:3] and ours[4] == theirs[4]
        assert (ours[3] is None) == (theirs[3] is None)
        if ours[3] is not None:
            assert ours[3]["w0"].tobytes() == theirs[3]["w0"].tobytes()
    for step in (2, 3, 4, 9):
        assert C.find_step_at_or_before(ck, step) == jckpt.find_step_at_or_before(ck, step)
    assert C.find_newer_good(ck, than_step=3)[:3] == (None, None, None)
    assert C.find_step_at_or_before(ck, 9)[0] == 3
    js = _session(JaxSession, split, checkpoint_dir=ck, resume="auto")
    assert (js.epoch, js.step_in_epoch) == (0, 3) and js.model_hash() == hashes[3]


def test_failed_write_leaves_no_temp_file_and_retries_oserror(tmp_path, monkeypatch):
    """A write that fails mid-stream removes its temp file, whether the
    failure is not retried or exhausts the three attempts of ``OSError``;
    a transient ``OSError`` is retried and the third attempt lands."""
    ts = TorchSession(device="cpu", sizes=SIZES, global_batch_size=GBS)
    path = tmp_path / "ck.npz"
    real_savez = np.savez
    monkeypatch.setattr(C.retry.time, "sleep", lambda s: None)
    for exc, calls_wanted in ((RuntimeError("disk detached"), 1), (OSError("NFS hiccup"), 3)):
        calls = []

        def boom(*a, exc=exc, calls=calls, **kw):
            calls.append(1)
            raise exc

        monkeypatch.setattr(C.np, "savez", boom)
        with pytest.raises(type(exc)):
            C.save_checkpoint(path, ts.params(), ts.spec, epoch=0)
        assert len(calls) == calls_wanted and list(tmp_path.iterdir()) == []
    attempts = []

    def flaky_then_ok(f, **arrays):
        attempts.append(1)
        if len(attempts) < 3:
            raise OSError("transient")
        real_savez(f, **arrays)

    monkeypatch.setattr(C.np, "savez", flaky_then_ok)
    nbytes, finite = C.save_checkpoint(path, ts.params(), ts.spec, epoch=2)
    assert len(attempts) == 3 and nbytes == path.stat().st_size and finite is True
    assert verify_checkpoint(path)["epoch"] == 2 and list(tmp_path.glob("*.tmp")) == []


def _job(step):
    ts = TorchSession(device="cpu", sizes=SIZES, global_batch_size=GBS)
    return C.build_snapshot(ts.params(), ts.spec, 0, step_in_epoch=step, global_step=step)


def test_async_writer_order_drain_and_backpressure(tmp_path):
    """Jobs rename in submit order and ``drain`` waits for all of them; a
    full window BLOCKS ``submit`` (a slow@save stalls the writer in its
    write window), and nothing is dropped."""
    results = []
    w = C.AsyncCheckpointWriter(max_in_flight=2)
    for step in (1, 2, 3):
        w.submit(step_checkpoint_path(tmp_path / "a", step), *_job(step), step,
                 on_complete=results.append)
    w.drain()
    assert [gs for gs, _ in list_step_checkpoints(tmp_path / "a")] == [1, 2, 3]
    assert [r["meta"]["global_step"] for r in results] == [1, 2, 3]
    assert all(r["all_finite"] and r["trusted"] and r["bytes"] > 0 for r in results)
    w.close()
    w.close()  # idempotent

    plan = faults.FaultPlan.parse("slow@save=0:ms=300")
    w = C.AsyncCheckpointWriter(max_in_flight=1, faults=plan)
    w.submit(step_checkpoint_path(tmp_path / "b", 1), *_job(1), 0)
    w.submit(step_checkpoint_path(tmp_path / "b", 2), *_job(2), 1)
    t0 = time.perf_counter()
    w.submit(step_checkpoint_path(tmp_path / "b", 3), *_job(3), 2)
    blocked = time.perf_counter() - t0
    w.drain()
    assert blocked > 0.05, "a full window did not block the submitter"
    assert [gs for gs, _ in list_step_checkpoints(tmp_path / "b")] == [1, 2, 3]
    assert plan.faults[0].fired
    w.close()


@pytest.mark.parametrize("spec", ["die@save=1", "corrupt@save=1"])
def test_async_writer_failures_and_corruption(tmp_path, spec):
    """``die@save`` fires after the temp write and before the rename: the
    victim is never visible, and the failure re-raises on the submitting
    thread at ``drain``. ``corrupt@save`` renames a file that never
    verifies, and discovery falls back past it."""
    plan = faults.FaultPlan.parse(spec)
    w = C.AsyncCheckpointWriter(max_in_flight=2, faults=plan)
    for seq, step in enumerate((4, 8)):
        w.submit(step_checkpoint_path(tmp_path, step), *_job(step), seq,
                 rotate_dir=tmp_path, rotate_keep=1)
    if spec.startswith("die"):
        with pytest.raises(faults.InjectedFault, match="die@save=1"):
            w.drain()
        assert [gs for gs, _ in list_step_checkpoints(tmp_path)] == [4]
        assert list(tmp_path.glob("*.tmp")) == []
        with pytest.raises(ValueError, match="closed"):
            w.close()
            w.submit(step_checkpoint_path(tmp_path, 9), *_job(9), 2)
    else:
        w.drain()
        # keep=1, yet the corrupted save never rotated the good one away
        assert [gs for gs, _ in list_step_checkpoints(tmp_path)] == [4, 8]
        path, _, skipped = find_latest_good(tmp_path)
        assert path.name == "step-00000004.npz"
        assert len(skipped) == 1 and "checksum" in skipped[0][1]
        w.close()


def test_several_writer_failures_surface_together(tmp_path, monkeypatch):
    """Every failed job is kept: the first raises, carrying the rest. The
    first job's deferred build holds the writer until both are queued."""
    w = C.AsyncCheckpointWriter(max_in_flight=3)
    monkeypatch.setattr(C.np, "savez", lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("full")))
    queued = threading.Event()
    jobs = {step: _job(step) for step in (1, 2)}

    def held_build():
        assert queued.wait(timeout=30)
        return jobs[1]

    w.submit(step_checkpoint_path(tmp_path, 1), None, None, 1, build=held_build)
    w.submit(step_checkpoint_path(tmp_path, 2), *jobs[2], 2)
    queued.set()
    with pytest.raises(CheckpointError, match="2 saves failed"):
        w.drain()
    w.close()


def test_async_session_save_is_a_host_copy_of_the_state(split, tmp_path):
    """The session's async save copies the live state on the step path:
    steps that run while the writer is still in its write window (a
    slow@save) update the tensors in place, and the file still holds the
    state of the step it names."""
    ck = tmp_path / "ck"
    ts = _session(
        TorchSession, split, optimizer="momentum", checkpoint_dir=ck,
        async_checkpoint=True, faults="slow@save=0:ms=1000",
    )
    ts.train_steps(2)
    want = ts.model_hash()
    path = ts.save_step_checkpoint()
    ts.train_steps(3)  # overlaps the writer's stall
    assert not path.exists()  # still in flight
    ts.drain_checkpoints()
    resumed = _session(TorchSession, split, optimizer="momentum", resume=path)
    assert resumed.model_hash() == want != ts.model_hash()
    assert (resumed.epoch, resumed.step_in_epoch) == (0, 2)
    ts.close()


def test_sync_and_async_saves_hold_the_same_snapshot(split, tmp_path):
    runs = {}
    for mode in (False, True):
        ts = _session(TorchSession, split, optimizer="adam", checkpoint_dir=tmp_path / str(mode))
        ts.train_steps(2)
        runs[mode] = ts.save_step_checkpoint(async_=mode)
        ts.close()
    _assert_same_contents(_contents(runs[False]), _contents(runs[True]))


def test_epoch_save_round_trip_and_mid_epoch_refusal(split, tmp_path):
    """``save`` writes the JAX session's epoch-boundary snapshot (resume
    continues at the next epoch); mid-epoch it refuses, since only a step
    snapshot keeps the cursor."""
    ts = _session(TorchSession, split, optimizer="momentum")
    ts.train_epoch()
    ts.save(tmp_path / "e.npz")
    resumed = _session(TorchSession, split, optimizer="momentum", resume=tmp_path / "e.npz")
    assert (resumed.epoch, resumed.step_in_epoch) == (1, 0)
    assert resumed.model_hash() == ts.model_hash()
    assert jckpt.verify_checkpoint(tmp_path / "e.npz")["epoch"] == 0
    ts.train_steps(1)
    with pytest.raises(ValueError, match="save_step_checkpoint"):
        ts.save(tmp_path / "mid.npz")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        ts.save_step_checkpoint()
    for kw in (dict(checkpoint_keep=0), dict(checkpoint_queue=0)):
        with pytest.raises(ValueError, match=">= 1"):
            TorchSession(device="cpu", **kw)
