"""The program audit end to end on the CPU: the port's trainer CLI with
``--audit --metrics-out`` on the layouts of the JAX Makefile's
``audit-smoke`` (sequential, DP=2, PP=4 GPipe, DP=2 x PP=2 zero 1) and on
zero 2, zero 3 and TP=2, each writing census-clean ``xla_audit`` records
the report renders as its Memory and Comms sections; an audit mismatch
exits 1 with the evidence written; the MPMD runners' ``warm``; and the
serve CLI and the fleet's workers with ``--audit``."""

import contextlib
import io

import numpy as np
import pytest

from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession
from shallowspeed_tpu_torch.observability import JsonlMetrics, read_jsonl
from shallowspeed_tpu_torch.observability.metrics import MetricsRecorder
from shallowspeed_tpu_torch.observability import report as treport
from shallowspeed_tpu_torch.parallel import executor as E
from shallowspeed_tpu_torch.serving import __main__ as scli

NB = 4  # batches per epoch


class Recorder(MetricsRecorder):
    """The in-memory recorder, keeping every record."""

    def __init__(self):
        super().__init__()
        self.records = []

    def _emit(self, record):
        self.records.append(record)

    def audits(self, name):
        return [r for r in self.records if r["kind"] == "xla_audit" and r["name"] == name]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("audit_split")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", NB * 128), ("val", 64)):
        labels = rng.randint(0, 10, n)
        np.save(path / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[labels])
    return path


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _audits(path, name=None):
    return [
        r for r in read_jsonl(path)
        if r["kind"] == "xla_audit" and (name is None or r["name"] == name)
    ]


# the JAX Makefile's audit-smoke layouts, then zero 2, zero 3 and tp 2
CLI_LAYOUTS = [
    ("seq", []),
    ("dp2", ["--dp", "2"]),
    ("gpipe-pp4", ["--pp", "4", "--schedule", "gpipe"]),
    ("zero1", ["--dp", "2", "--pp", "2", "--schedule", "gpipe", "--zero1"]),
    ("zero2", ["--dp", "2", "--pp", "2", "--zero", "2", "--optimizer", "momentum"]),
    ("zero3", ["--dp", "2", "--pp", "2", "--zero", "3"]),
    ("tp2", ["--tp", "2"]),
]


@pytest.mark.parametrize("flags", [c[1] for c in CLI_LAYOUTS], ids=[c[0] for c in CLI_LAYOUTS])
def test_trainer_cli_audit_writes_clean_records_the_report_renders(split, tmp_path, monkeypatch, flags):
    monkeypatch.delenv("SHALLOWSPEED_FAULTS", raising=False)
    path = tmp_path / "audit.jsonl"
    rc, out, err = _run(tcli.main, [
        "--device", "cpu", "--data-dir", str(split), "--epochs", "1", "--no-eval",
        "--audit", "--metrics-out", str(path), *flags,
    ])
    assert rc == 0, err
    assert "final model hash:" in out
    audits = _audits(path)
    # the epoch, and on a mesh the inference rung of the final accuracy
    assert [r["name"] for r in audits if r["name"] != "inference_program"] == ["epoch_program"]
    assert all(r["census_ok"] for r in audits)
    (rec,) = _audits(path, "epoch_program")
    assert rec["census_ok"] is True and rec["mismatches"] == []
    assert rec["census_source"] == "movers"
    exp = rec["expected"]
    for kind in exp["required"]:
        assert rec["census"][kind]["count"] >= 1
    if exp["sequential"]:
        assert rec["census"] == {}
    rc, text, _ = _run(treport.main, [str(path), "--format", "md"])
    assert rc == 0
    assert "## Memory (compiled program)" in text
    assert "## Comms (XLA program audit)" in text
    assert "matches the layout contract" in text
    assert "unavailable (backend exposed no HLO text)" not in text
    if exp["zero_forecast"] is not None:
        assert "ZeRO forecast [stage" in text


def test_trainer_cli_audit_mismatch_exits_1_with_the_evidence(split, tmp_path, monkeypatch):
    """A dropped dp sum: the probe's census breaks the contract, the CLI
    exits 1 before the first step, and the failing record is written."""
    monkeypatch.delenv("SHALLOWSPEED_FAULTS", raising=False)
    monkeypatch.setattr(E, "dp_sum", lambda trees, ranks=1: trees[0])
    path = tmp_path / "bad.jsonl"
    rc, out, err = _run(tcli.main, [
        "--device", "cpu", "--data-dir", str(split), "--epochs", "1", "--no-eval",
        "--dp", "2", "--audit", "--metrics-out", str(path),
    ])
    assert rc == 1
    assert "AUDIT MISMATCH:" in err and "required collective 'all_reduce'" in err
    assert "final model hash:" not in out
    (rec,) = _audits(path)
    assert rec["census_ok"] is False
    rc, text, _ = _run(treport.main, [str(path), "--format", "text"])
    assert "CONTRACT MISMATCH" in text


def test_recorded_run_without_audit_writes_every_program_once(split, tmp_path):
    """Metrics alone: the census rides the first real dispatch of each
    program (the epoch, each distinct shorter chunk length, a fused run, an
    inference rung), one record a program, all clean."""
    path = tmp_path / "m.jsonl"
    with JsonlMetrics(path) as m:
        s = TrainingSession(data_dir=split, dp=2, pp=2, metrics=m, device="cpu")
        s.train_epoch()
        s.train_epoch()
        s.train_steps(1)
        s.train_steps(3)
        s.train_steps(1)
        s.train_steps(3)
        s.train_run(1, with_eval=True)
        s.predict(np.zeros((5, 784), np.float32))
    names = [r["name"] for r in _audits(path)]
    assert names == [
        "epoch_program", "chunk_program", "chunk_program", "run_program", "inference_program",
    ]
    assert all(r["census_ok"] for r in _audits(path))
    run = _audits(path, "run_program")[0]
    # the fused run's eval hands the head's predictions out too
    assert "preds" in run["census_sites"] and "dp_sum" in run["census_sites"]


@pytest.mark.parametrize(
    "layout",
    [dict(pp=4, schedule="gpipe"), dict(dp=2, pp=2, tp=2, recompute=True),
     dict(pp=2, schedule="pipedream", backward_split=True)],
    ids=["pp4", "dp2pp2tp2-recompute", "pp2-split"],
)
def test_mpmd_warm_audits_every_planned_stage_program(split, layout):
    rec = Recorder()
    s = TrainingSession(
        data_dir=split, runtime="mpmd", metrics=rec, audit=True, device="cpu",
        record_steps=False, **layout,
    )
    n_planned = len(s._mpmd.planned_programs())
    # warm alone, on clones: the count, and the session's state untouched
    calls = []

    def resolve(label, role, fn, args, expected, safety=False):
        calls.append((label, role))
        s._mpmd_resolve(label, role, fn, args, expected, safety)

    before = s.params()
    assert s._mpmd.warm(s._stacked, s._flags, s._opt_state, resolve) == n_planned
    assert len(set(calls)) == n_planned
    for a, b in zip(before, s.params()):
        for la, lb in zip(a, b):
            assert np.array_equal(la["W"], lb["W"]) and np.array_equal(la["b"], lb["b"])
    stage = rec.audits("mpmd_stage_program")
    assert len(stage) == n_planned
    for r in stage:
        assert r["census_ok"] is True, (r["program_label"], r["mismatches"])
        # relays left the stage programs: none moves one inside itself
        assert "collective_permute" not in r["census"]
        assert "collective_permute" in r["expected"]["forbidden"]
        assert r["expected"]["mpmd_role"] == r["role"]
    # the training: the runner's relays censused as the runner's, against
    # the layout's contract, and the chain's programs before they serve
    s.train_epoch()
    (epoch,) = rec.audits("epoch_program")
    assert epoch["census_ok"] is True
    assert {"relay.fwd", "relay.bwd"} <= set(epoch["census_sites"])
    s.predict(np.zeros((3, 784), np.float32))
    infer = [r for r in rec.audits("mpmd_stage_program") if r["role"] == "infer_fwd"]
    assert len(infer) == len(s._mpmd_infer.chain)
    assert all(r["census_ok"] and r["dispatch_safety"]["mismatches"] == [] for r in infer)


@pytest.mark.parametrize(
    "layout", [[], ["--dp", "2", "--pp", "2", "--tp", "2"]], ids=["seq", "dp2-pp2-tp2"]
)
def test_serve_cli_audit_serves_with_clean_records(split, tmp_path, layout):
    path = tmp_path / "s.jsonl"
    rc, out, err = _run(scli.main, [
        "--device", "cpu", "--requests", "12", "--rate", "2000", "--slo-ms", "2000",
        "--verify", "--audit", "--slot-ladder", "1,2", "--metrics-out", str(path), *layout,
    ])
    assert rc == 0, err
    assert "verify: 12/12 responses bitwise-equal to direct predict()" in out
    audits = _audits(path, "inference_program")
    if layout:
        # every rung the warm-up dispatched, held to the forward-only
        # contract and to dispatch safety before it served
        assert len(audits) == 2
        for r in audits:
            assert r["census_ok"] and r["expected"]["inference"] is True
            assert r["dispatch_safety"]["mismatches"] == []
    else:
        # the sequential slot program is not a separate audited program,
        # as in the JAX session without an AOT cache
        assert audits == []


def test_fleet_workers_get_the_audit_flag(split, monkeypatch):
    """``--fleet N --audit``: the workers' session kwargs carry it."""
    from shallowspeed_tpu_torch.serving import fleet

    seen = {}

    class Captured(Exception):
        pass

    def capture(self, worker_config, **kw):
        seen.update(worker_config["session"])
        raise Captured

    monkeypatch.setattr(fleet.ServingFleet, "__init__", capture)
    with pytest.raises(Captured):
        scli.main(["--device", "cpu", "--fleet", "2", "--audit", "--requests", "2"])
    assert seen["audit"] is True
