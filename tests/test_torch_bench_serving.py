"""The port's ``serving/bench_serving.py`` against the JAX package's: the
saturation knee on the same rows, a two-rate sweep record and a chaos-soak
record with the JAX records' keys, the soak's invariants (zero lost, bitwise
parity under the weights active at each dispatch, recovery), and the CLI
(sweep, soak, and the fleet flags refused with exit 2).
"""

import contextlib
import io
import json

import numpy as np
import pytest

from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.serving import bench_serving as jbench
from shallowspeed_tpu_torch import checkpoint as tckpt
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.serving import bench_serving as tbench

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
GBS = 64
CHAOS = "error@dispatch=2,slow@dispatch=3:ms=10,die@dispatch=4,nan@dispatch=6"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 128), ("val", 64)):
        x = rng.randn(n, SIZES[0]).astype(np.float32)
        y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], n)]
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", y)
    return path


def _write_ck(path, sizes):
    """A step-checkpoint directory: step 0 = the deterministic init, step 8
    = weights away from it (so a reload is observable)."""
    spec = tmodel.make_model_spec(sizes, 1, GBS)
    init = tmodel.init_model(spec)
    rng = np.random.RandomState(11)
    moved = [[{"W": (l["W"] + 0.05 * rng.randn(*l["W"].shape)).astype(np.float32),
               "b": (0.05 * rng.randn(*l["b"].shape)).astype(np.float32)}
              for l in stage] for stage in init]
    for step, params in ((0, init), (8, moved)):
        tckpt.save_checkpoint(tckpt.step_checkpoint_path(path, step), params, spec, 0,
                              step_in_epoch=step, global_step=step)
    return path


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    return _write_ck(tmp_path_factory.mktemp("ck"), SIZES)


def _sessions(data_dir, **kw):
    kw = dict(sizes=SIZES, global_batch_size=GBS, predict_slot_ladder=(1, 2, 4), **kw)
    return JaxSession(data_dir=data_dir, **kw), TorchSession(device="cpu", **kw)


def _row(rate, p99_ms, achieved):
    return {"offered_rps": rate, "p99_latency_s": None if p99_ms is None else p99_ms / 1e3,
            "achieved_rps": achieved}


KNEE_ROWS = {
    "tail": [_row(100, 5, 100), _row(200, 20, 199), _row(400, 80, 390)],
    "throughput": [_row(100, 5, 100), _row(200, 6, 150), _row(400, 7, 390)],
    "none": [_row(100, 5, 100), _row(200, 6, 199)],
    "unmeasured": [_row(100, None, None), _row(200, 9, 200)],
}


@pytest.mark.parametrize("case", sorted(KNEE_ROWS))
@pytest.mark.parametrize("slo_ms", [10.0, None])
def test_find_knee_equals_jax(case, slo_ms):
    rows = KNEE_ROWS[case]
    assert tbench.find_knee(rows, slo_ms) == jbench.find_knee(rows, slo_ms)
    assert tbench.SWEEP_ROW_FIELDS == jbench.SWEEP_ROW_FIELDS
    assert tbench.BENCH_VERSION == jbench.BENCH_VERSION


def _keys(obj):
    """A record's key structure (dicts recursively, the first row of lists)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_keys(obj[0])]
    return None


def test_sweep_record_has_the_jax_keys_and_serves_bitwise(data_dir):
    """Two rates through both packages' sweep: the same record structure
    and config; every port response of every rate terminal and "ok", and
    bitwise a direct predict()."""
    js, ts = _sessions(data_dir)
    kw = dict(rates=[2000.0, 500.0], n_requests=12, seed=1, slo_ms=1000.0)
    jrec = jbench.sweep(js, **kw)
    checked = []

    def on_rate(rate, payloads, done):
        # the engine numbers requests across rates: a rate's i-th is id % n
        assert sorted(r.id % 12 for r in done) == list(range(12))
        for r in done:
            assert r.verdict == "ok"
            assert np.array_equal(r.result, ts.predict(payloads[r.id % 12]))
        checked.append(rate)

    trec = tbench.sweep(ts, on_rate=on_rate, **kw)
    assert _keys(trec) == _keys(jrec)
    assert trec["config"] == jrec["config"] and checked == [500.0, 2000.0]
    assert [r["offered_rps"] for r in trec["sweep"]] == [500.0, 2000.0]
    assert [r["completed"] for r in trec["sweep"]] == [12, 12]
    assert trec["knee_rps"] == tbench.find_knee(trec["sweep"], 1000.0)
    assert trec["latency_bound_source"] == "nominal-cpu-default"
    json.dumps(trec, allow_nan=False)


def test_chaos_soak_invariants_and_jax_keys(data_dir, ck):
    """die/slow/nan/error + one mid-traffic watcher reload: zero lost,
    bitwise parity under the weights active at each dispatch, the die
    absorbed once, breaker then recovery, every fault fired — and the JAX
    record's keys."""
    js, ts = _sessions(data_dir)
    kw = dict(faults=CHAOS, n_requests=30, rate=300.0, seed=0, slo_ms=10_000,
              reload_dir=ck, reload_at=5, loaded_step=0, retry_budget=2,
              breaker_threshold=1, max_slots=2)
    jrec = jbench.chaos_soak(js, **kw)
    rec = tbench.chaos_soak(ts, **kw)
    assert _keys(rec) == _keys(jrec) and rec["config"] == jrec["config"]
    assert rec["bench"] == "serving_chaos" and rec["submitted"] == 30
    assert rec["silently_lost"] == [] and rec["parity_mismatches"] == 0
    assert rec["crashes_recovered"] == 1 and rec["faults_unfired"] == 0
    assert rec["breaker_trips"] >= 1 and rec["reloads"] >= 2
    assert rec["recovery_s"] is not None and not rec["degraded_at_exit"]
    assert rec["recompiles"] is None and rec["predict_cache_stable"]
    assert rec["verdicts"].get("ok", 0) >= 1 and rec["goodput_retention"] is not None
    json.dumps(rec, allow_nan=False)


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tbench.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_sweep_and_chaos(tmp_path):
    """The CLI's two modes on the flagship: the sweep's record, and the
    JAX chaos recipe (cut to 24 requests) with its gate passed and its
    stream rendered by the report."""
    from shallowspeed_tpu_torch.observability import report

    out = tmp_path / "bench.json"
    rc, text, _ = _main(["--device", "cpu", "--rates", "400,1600", "--requests", "8",
                         "--slo-ms", "1000", "--out", str(out)])
    assert rc == 0 and "saturation knee:" in text
    rec = json.loads(out.read_text())
    assert rec["bench"] == "serving" and len(rec["sweep"]) == 2
    ck = _write_ck(tmp_path / "ck", FLAGSHIP_SIZES)
    chaos_out, stream = tmp_path / "chaos.json", tmp_path / "chaos.jsonl"
    rc, text, err = _main([
        "--device", "cpu", "--chaos", CHAOS, "--reload-dir", str(ck),
        "--reload-at", "5", "--requests", "24", "--rates", "300",
        "--slo-ms", "2000", "--max-slots", "2", "--chaos-out", str(chaos_out),
        "--metrics-out", str(stream),
    ])
    assert rc == 0, err
    rec = json.loads(chaos_out.read_text())
    assert rec["silently_lost"] == [] and rec["parity_mismatches"] == 0
    assert rec["reloads"] >= 2 and rec["crashes_recovered"] == 1
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main([str(stream), "--format", "md"])
    text = buf.getvalue()
    assert "### Degradation" in text and "## Tracing" in text


@pytest.mark.parametrize(
    "flag",
    [["--fleet", "3"], ["--kill-after", "20"], ["--no-scale-up"],
     ["--fleet-policy", "p2c"], ["--fleet-retry", "3"], ["--fleet-out", "f.json"],
     ["--aot-cache", "cache"]],
    ids=lambda f: f[0],
)
def test_fleet_flags_refused_with_exit_2(flag):
    rc, out, err = _main(["--device", "cpu"] + flag)
    assert rc == 2 and out == ""
    assert err.count("\n") == 1 and "ROADMAP.md §A item" in err and flag[0] in err
