"""The session's telemetry, port (CPU) against the JAX package, on one
seeded synthetic split: the record stream, the per-step flight and digest
records, the kernel paths' refusals, the health halt with its flush and
recovery, the divergence attribution, the trace analysis and the
dispatch probe, the engine's latency floor, and the CLI's flags.

Tolerances (``docs/numerics.md``): step loss, gradient norm and parameter
norm within the cross-engine class (``rtol=2e-4, atol=2e-6``); inside the
port the digest checksums are bitwise ``utils.layer_digests`` of the
port's own params. Checksums are not compared across the frameworks.

Records the JAX session writes and the port has no counterpart for are
dropped before the streams are compared: the ``jit_compile`` span and
counter (the port compiles no XLA program), and the ``xla_audit`` records,
whose census the JAX session reads from compiled HLO and the port from its
data movers, at other points of the run.
``rollup``/``alert`` records close on wall-clock windows, so where they
fall differs run to run in both packages; they are dropped too.
"""

import contextlib
import gzip
import io
import json

import numpy as np
import pytest

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import JsonlMetrics as JaxJsonl
from shallowspeed_tpu.observability import divergence as jdiv
from shallowspeed_tpu.observability.health import HealthError as JaxHealthError
from shallowspeed_tpu.serving import engine as jengine
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch import trainer as ttrainer
from shallowspeed_tpu_torch import utils as tutils
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import verify_checkpoint
from shallowspeed_tpu_torch.observability import HealthError, JsonlMetrics, read_jsonl
from shallowspeed_tpu_torch.observability import divergence as tdiv
from shallowspeed_tpu_torch.observability.metrics import MetricsRecorder
from shallowspeed_tpu_torch.observability import trace_stats
from shallowspeed_tpu_torch.parallel import executor as texec
from shallowspeed_tpu_torch.serving import engine as tengine

RTOL, ATOL = 2e-4, 2e-6  # cross-engine class
NB = 4  # batches per epoch of the split
JAX_ONLY = {("span", "jit_compile"), ("counter", "jit_compiles")}
JAX_ONLY_KINDS = {"xla_audit", "rollup", "alert"}


def _write_split(path, n_train, n_val=200, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1.0, (10, 784)).astype(np.float32)
    for suffix, n in (("train", n_train), ("val", n_val)):
        labels = rng.randint(0, 10, n)
        x = centers[labels] + rng.normal(0, 2.0, (n, 784)).astype(np.float32)
        x = np.clip((x + 8.0) / 16.0, 0.0, 1.0).astype(np.float32)
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[labels])
    return path


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return _write_split(tmp_path_factory.mktemp("split"), NB * 128)


def _kinds(records):
    return [
        (r["kind"], r["name"])
        for r in records
        if r["kind"] not in JAX_ONLY_KINDS and (r["kind"], r["name"]) not in JAX_ONLY
    ]


def _of(records, kind, name=None):
    return [r for r in records if r["kind"] == kind and (name is None or r["name"] == name)]


# the main path's four layouts, as the card runs them
LAYOUTS = {
    "4-microbatch": dict(),
    "fused": dict(fuse_mubatches=True),
    "dp2xpp4-pallas": dict(dp=2, pp=4, schedule="gpipe", kernel_backend="pallas"),
    "pp2xv2-interleaved": dict(pp=2, schedule="interleaved", virtual_stages=2,
                               kernel_backend="pallas"),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_epoch_stream_matches_jax(layout, split, tmp_path):
    kw = LAYOUTS[layout]
    streams = {}
    for name, cls, rec_cls, dev in (
        ("jax", JaxSession, JaxJsonl, {}),
        ("port", TorchSession, JsonlMetrics, {"device": "cpu"}),
    ):
        path = tmp_path / f"{name}.jsonl"
        rec = rec_cls(path)
        s = cls(data_dir=split, metrics=rec, health="record", digests=True, **kw, **dev)
        s.train_epoch()
        s.close()
        rec.close()
        streams[name] = read_jsonl(path)
        if name == "port":
            port = s
    j, t = streams["jax"], streams["port"]
    assert _kinds(t) == _kinds(j)
    steps_j, steps_t = _of(j, "step"), _of(t, "step")
    assert len(steps_t) == NB
    for a, b in zip(steps_t, steps_j):
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=k)
    # digests: the norms within the class; the checksums are the port's own
    dig_t, dig_j = _of(t, "digest"), _of(j, "digest")
    assert [d["step"] for d in dig_t] == [d["step"] for d in dig_j] == list(range(NB))
    for a, b in zip(dig_t, dig_j):
        for k in ("pnorm_w", "pnorm_b", "gnorm_w", "gnorm_b"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=k)
    want = tutils.layer_digests(port.params())
    assert dig_t[-1]["crc_w"] == [d["crc_w"] for d in want]
    assert dig_t[-1]["crc_b"] == [d["crc_b"] for d in want]
    np.testing.assert_allclose(dig_t[-1]["pnorm_w"], [d["pnorm_w"] for d in want], rtol=1e-6)
    cm_t, cm_j = _of(t, "event", "cost_model")[0], _of(j, "event", "cost_model")[0]
    for k in ("flops_per_sample", "flops_per_batch", "flops_per_epoch", "peak_flops_per_chip"):
        assert cm_t[k] == cm_j[k]
    assert cm_t.get("padded_flops_per_batch") == cm_j.get("padded_flops_per_batch")
    ep = _of(t, "event", "epoch")[0]
    assert ep["includes_compile"] and 0 < ep["mfu"] and ep["samples_per_sec"] > 0
    assert not _of(t, "health")


@pytest.mark.parametrize("layout", ["4-microbatch", "pp2xv2-interleaved"])
def test_digest_after_each_step_is_layer_digests(layout, split):
    """Step by step, the newest digest record is bitwise the host digest of
    the params the session then holds (interleaved: through the stacked-row
    order)."""
    rec = _MemoryRecorder()
    s = TorchSession(data_dir=split, metrics=rec, digests=True, device="cpu",
                     **LAYOUTS[layout])
    for k in range(NB):
        s.train_steps(1)
        d = rec.digests[-1]
        assert d["step"] == k
        want = tutils.layer_digests(s.params())
        assert d["crc_w"] == [x["crc_w"] for x in want]
        assert d["crc_b"] == [x["crc_b"] for x in want]


class _MemoryRecorder(MetricsRecorder):
    """A recorder that keeps its digest records in memory."""

    def __init__(self):
        super().__init__()
        self.digests = []

    def _emit(self, record):
        if record["kind"] == "digest":
            self.digests.append(record)


@pytest.mark.parametrize("kernel", ["epoch_kernel", "run_kernel"])
def test_kernel_paths_epoch_records_only_and_refusals(kernel, split, tmp_path):
    kw = dict(data_dir=split, fuse_mubatches=True, **{kernel: True})
    path = tmp_path / "k.jsonl"
    rec = JsonlMetrics(path)
    s = TorchSession(metrics=rec, health="record", device="cpu", **kw)
    if kernel == "epoch_kernel":
        s.train_epoch()
    else:
        s.train_run(2, with_eval=False)
    rec.close()
    recs = read_jsonl(path)
    assert not _of(recs, "step") and not _of(recs, "digest") and not _of(recs, "health")
    eps = _of(recs, "event", "epoch")
    assert len(eps) == (1 if kernel == "epoch_kernel" else 2)
    assert all(e["mfu"] > 0 for e in eps)
    for extra in (dict(record_steps=True), dict(digests=True)):
        msgs = []
        for cls, dev in ((JaxSession, {}), (TorchSession, {"device": "cpu"})):
            with pytest.raises(ValueError) as e:
                cls(**kw, **extra, **dev)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _grid_drive(session, epochs, every=4):
    """The CLI's step loop: chunks cut at the checkpoint grid (and at fault
    steps), a step checkpoint whenever the global step lands on it."""
    nb = session.batches_per_epoch
    while session.epoch < epochs:
        n = min(every - session.global_step % every, nb - session.step_in_epoch)
        session.train_steps(n)
        if session.global_step % every == 0:
            session.save_step_checkpoint()


def test_health_halt_flushes_and_resumes_to_the_twin(split, tmp_path):
    halted = {}
    for name, cls, err_cls, dev in (
        ("jax", JaxSession, JaxHealthError, {}),
        ("port", TorchSession, HealthError, {"device": "cpu"}),
    ):
        ck = tmp_path / name
        s = cls(data_dir=split, health="halt", faults="nan@step=5", checkpoint_dir=ck, **dev)
        with pytest.raises(err_cls) as e:
            _grid_drive(s, 2)
        halted[name] = (str(e.value), s.global_step, sorted(p.name for p in ck.iterdir()))
    assert halted["jax"] == halted["port"]
    msg, gs, files = halted["port"]
    assert "non_finite" in msg and "step 5" in msg and gs == 8
    assert files == ["step-00000004.npz", "step-00000008.npz"]
    meta = verify_checkpoint(tmp_path / "port" / "step-00000008.npz")
    assert meta["all_finite"] is False and meta["global_step"] == 8
    # resume="auto" skips the non-finite halt snapshot: back to step 4
    path = tmp_path / "resume.jsonl"
    rec = JsonlMetrics(path)
    r = TorchSession(data_dir=split, checkpoint_dir=tmp_path / "port", resume="auto",
                     metrics=rec, device="cpu")
    assert r.global_step == 4
    _grid_drive(r, 2)
    rec.close()
    (recovery,) = _of(read_jsonl(path), "recovery")
    assert recovery["name"] == "resumed" and recovery["global_step"] == 4
    assert [s["cause"] for s in recovery["skipped"]] and "step-00000008" in recovery["skipped"][0]["path"]
    twin = TorchSession(data_dir=split, device="cpu")
    _grid_drive(twin, 2, every=10**6)
    assert r.model_hash() == twin.model_hash()


def test_flip_divergence_named_alike_by_both_clis(split, tmp_path):
    paths = []
    for name, faults in (("clean", None), ("flip", "flip@step=2")):
        path = tmp_path / f"{name}.jsonl"
        rec = JsonlMetrics(path)
        s = TorchSession(data_dir=split, metrics=rec, digests=True, faults=faults, device="cpu")
        while s.epoch < 1:
            s.train_steps(NB)
        rec.close()
        paths.append(str(path))
    outs = []
    for main in (tdiv.main, jdiv.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(paths)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    div = tdiv.first_divergence(*(tdiv.digest_stream(read_jsonl(p)) for p in paths))
    assert (div["step"], div["layer"], div["tensor"]) == (2, 0, "W")
    assert outs[0][0] == 2


def _kineto(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_trace_stats_on_a_synthetic_kineto_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void linear_act_fwd_kernel<64, 64, 4, 4>(float const*)",
         "pid": 0, "tid": 7, "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::linear_act_bwd_kernel<32>(float const*)",
         "pid": 0, "tid": 7, "ts": 105.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 8,
         "ts": 130.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0, "tid": 8,
         "ts": 200.0, "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 500.0},
    ]
    p = _kineto(tmp_path / "a.pt.trace.json.gz", ev)
    busy = trace_stats.dispatch_busy(p)
    # [100, 115) + [130, 135) + [200, 201): 21 us, the cpu op ignored
    assert busy["source"] == "device" and busy["op_events"] == 4
    assert busy["busy_union_s"] == pytest.approx(21e-6, abs=1e-15)
    assert busy["comm_union_s"] == 0.0
    s = trace_stats.summarize(p)
    assert s["device_ops"] == 4 and s["top_ops"]["linear_act_fwd_kernel"] == 1
    assert s["top_ops"]["linear_act_bwd_kernel"] == 1 and s["comm_ops"] == 0
    assert s["span_ms"] == pytest.approx(0.101)
    # a CPU trace: the union of the cpu ops, nesting counted once
    cpu = _kineto(tmp_path / "b.pt.trace.json", [])
    with open(cpu, "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 1, "tid": 1, "ts": 0.0, "dur": 50.0},
            {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1, "tid": 1, "ts": 10.0, "dur": 20.0},
            {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "pid": 1, "tid": 1, "ts": 80.0, "dur": 5.0},
        ]}, f)
    b = trace_stats.dispatch_busy(cpu)
    assert b["source"] == "host-cpu-ops" and b["busy_union_s"] == pytest.approx(55e-6)
    assert trace_stats.summarize(cpu)["device_ops"] == 0
    assert sorted(trace_stats.find_traces(tmp_path)) == sorted([p, cpu])
    assert trace_stats.dispatch_overhead_share(21e-6, 84e-6) == pytest.approx(0.75)


@pytest.mark.parametrize("program", ["epoch", "rung"])
def test_measure_dispatch_overhead_on_the_cpu(program, split, tmp_path):
    # a narrow MLP keeps the profiled window far inside the 5 s budget on a
    # loaded host
    path = tmp_path / "m.jsonl"
    rec = JsonlMetrics(path)
    s = TorchSession(sizes=(784, 32, 31, 30, 10), data_dir=split, metrics=rec, device="cpu")
    r = s.measure_dispatch_overhead(repeats=1, program=program)
    rec.close()
    assert r["window_valid"] and r["op_events"] > 0 and r["op_source"] == "host-cpu-ops"
    assert 0.0 <= r["dispatch_overhead"] <= 1.0
    assert r["events_per_batch"] == r["op_events"] / (NB if program == "epoch" else 1)
    (ev,) = _of(read_jsonl(path), "event", "dispatch_overhead")
    assert ev["dispatch_overhead"] == r["dispatch_overhead"]


def test_engine_sheds_a_deadline_inside_the_floor(split, monkeypatch):
    """With a peak of 1 MFLOP/s the flagship slot's floor is ~2.9 s: a
    request due in 1 s is shed though its deadline has not passed, one due
    in 10 s is served — in both engines."""
    monkeypatch.setenv("SHALLOWSPEED_PEAK_FLOPS", "1e6")
    verdicts = []
    for mod, session in (
        (jengine, JaxSession(data_dir=split)),
        (tengine, TorchSession(data_dir=split, device="cpu")),
    ):
        bound = session.inference_latency_bound()
        assert bound["seconds"] == pytest.approx(bound["flops"] / 1e6)
        clock = iter(np.arange(0.0, 100.0, 0.01)).__next__
        eng = mod.ServingEngine(session, clock=clock)
        x = np.ones((1, 784), np.float32)
        soon = eng.submit(x, deadline_ms=1000.0)
        late = eng.submit(x, deadline_ms=10_000.0)
        eng.drain()
        verdicts.append((soon.verdict, late.verdict))
    assert verdicts[0] == verdicts[1] == ("expired", "ok")


def test_no_step_aux_without_a_consumer(split, monkeypatch):
    """NullMetrics, no monitor, record_steps unset: no norm or digest is
    computed and every epoch function keeps its uninstrumented arity."""

    def boom(*a, **k):
        raise AssertionError("telemetry aux computed with nothing consuming it")

    for mod in (ttrainer, texec):
        monkeypatch.setattr(mod, "global_norm", boom)
    monkeypatch.setattr(ttrainer, "_digest_aux", boom)
    monkeypatch.setattr(texec, "_digest_grids", boom)
    for kw in (dict(), dict(fuse_mubatches=True), LAYOUTS["dp2xpp4-pallas"]):
        s = TorchSession(data_dir=split, device="cpu", **kw)
        s.train_epoch()
        s.train_steps(2)
        assert s.flight is None
        out = s._epoch_fn(*s._state_args(), s._X[:1], s._Y[:1])
        assert len(out) == 3


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = tcli.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def test_cli_telemetry_flags_and_refusals(split, tmp_path, monkeypatch):
    monkeypatch.delenv("SHALLOWSPEED_FAULTS", raising=False)
    base = ["--device", "cpu", "--data-dir", str(split), "--epochs", "1"]
    path = tmp_path / "m.jsonl"
    rc, out, _ = _cli(base + ["--metrics-out", str(path), "--health", "warn", "--digests",
                              "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0 and f"telemetry written: {path}" in out
    recs = read_jsonl(path)
    assert len(_of(recs, "step")) == NB and len(_of(recs, "digest")) == NB
    (cap,) = _of(recs, "event", "profiler_capture")
    assert trace_stats.dispatch_busy(cap["trace"])["op_events"] > 0
    # the halt: exit 3, HEALTH HALT, the telemetry still written
    monkeypatch.setenv("SHALLOWSPEED_FAULTS", "nan@step=1")
    rc, out, err = _cli(base + ["--metrics-out", str(tmp_path / "h.jsonl"), "--health", "halt"])
    assert rc == 3 and "HEALTH HALT:" in err and "telemetry written:" in out
    monkeypatch.delenv("SHALLOWSPEED_FAULTS")
    # --audit runs the probe and the program, and the census holds
    rc, out, err = _cli(base + ["--audit", "--no-eval"])
    assert rc == 0 and "final model hash:" in out, err
    rc, _, err = _cli(base + ["--digests", "--fused-run"])
    assert rc == 2 and "--digests rides the epoch/step scan aux" in err
    # the probe's record (its window's validity on a loaded CPU is the
    # session test's subject, at a narrow width)
    rc, out, _ = _cli(base + ["--no-eval", "--dispatch-probe-out", str(tmp_path / "p.json")])
    assert rc == 0 and "dispatch overhead: >=" in out
    probe = json.loads((tmp_path / "p.json").read_text())
    assert probe["bench"] == "dispatch_overhead" and probe["op_events"] > 0
    assert 0.0 <= probe["value"] <= 1.0 and isinstance(probe["window_valid"], bool)


def test_serving_cli_records_the_session(tmp_path):
    from shallowspeed_tpu_torch.serving import __main__ as serve_cli

    path = tmp_path / "s.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_cli.main(["--device", "cpu", "--requests", "6", "--rate", "1000",
                             "--metrics-out", str(path)])
    assert rc == 0 and f"telemetry written: {path}" in out.getvalue()
    (cm,) = _of(read_jsonl(path), "event", "cost_model")
    assert cm["platform"] == "cpu" and cm["peak_source"] == "nominal-cpu-default"


def test_mid_epoch_resume_epoch_record_counts_its_steps(split, tmp_path):
    s = TorchSession(data_dir=split, checkpoint_dir=tmp_path / "ck", device="cpu")
    s.train_steps(1)
    s.save_step_checkpoint()
    path = tmp_path / "r.jsonl"
    rec = JsonlMetrics(path)
    r = TorchSession(data_dir=split, checkpoint_dir=tmp_path / "ck", resume="auto",
                     metrics=rec, device="cpu")
    r.train_steps(NB)
    rec.close()
    recs = read_jsonl(path)
    (ep,) = _of(recs, "event", "epoch")
    assert ep["chunked"] and ep["steps_counted"] == NB - 1 and ep["includes_compile"]
    assert [st["step"] for st in _of(recs, "step")] == list(range(1, NB))
    (rv,) = _of(recs, "recovery")
    assert rv["name"] == "resumed" and rv["step_in_epoch"] == 1


@pytest.mark.parametrize("layout", ["4-microbatch", "dp2xpp4-pallas"])
def test_clipped_run_records_each_epochs_grad_norm(layout, split, tmp_path):
    """With a recorder and a clip, ``train_run``'s epoch records carry the
    epoch's mean pre-clip gradient norm: bitwise ``train_epoch``'s."""
    got = []
    for name, drive in (("epoch", lambda s: s.train_epoch()),
                        ("run", lambda s: s.train_run(1, with_eval=False))):
        path = tmp_path / f"{name}.jsonl"
        rec = JsonlMetrics(path)
        s = TorchSession(data_dir=split, metrics=rec, clip_norm=0.05, record_steps=False,
                         device="cpu", **LAYOUTS[layout])
        drive(s)
        rec.close()
        (ep,) = _of(read_jsonl(path), "event", "epoch")
        got.append((ep["loss"], ep["grad_norm"]))
    assert got[0] == got[1] and got[0][1] > 0.05
