"""The port's serving slice against the JAX package: session predict, the
engine, load generation, checkpoints, the CLI and the device rule.

The port runs on the CPU (``device="cpu"``, its plain path). Request
payloads and arrival times come from the seeded load generators of both
packages, which are checked to agree bit for bit.
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu import checkpoint as jckpt
from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import retry as jretry
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import stats as jstats
from shallowspeed_tpu.serving import engine as jengine
from shallowspeed_tpu.serving import loadgen as jloadgen
from shallowspeed_tpu.serving import slots as jslots
from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch import retry as tretry
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession
from shallowspeed_tpu_torch.checkpoint import CheckpointError, load_checkpoint
from shallowspeed_tpu_torch.observability import stats as tstats
from shallowspeed_tpu_torch.serving import __main__ as tcli
from shallowspeed_tpu_torch.serving import engine as tengine
from shallowspeed_tpu_torch.serving import loadgen as tloadgen
from shallowspeed_tpu_torch.serving import slots as tslots

# softmax probabilities of the flagship: the two packages sum in different
# orders; measured 3e-8 on the CPU
PROB_ATOL = 1e-6


@pytest.fixture()
def data_dir(tmp_path):
    """The JAX session loads a training split at construction; the port's
    serving session does not."""
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 256), ("val", 64)):
        x = rng.randn(n, FLAGSHIP_SIZES[0]).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
        np.save(tmp_path / f"x_{suffix}.npy", x)
        np.save(tmp_path / f"y_{suffix}.npy", y)
    return tmp_path


def _payloads(n=24, seed=0, rows=tuple(range(1, 21))):
    return tloadgen.request_payloads(n, FLAGSHIP_SIZES[0], seed=seed, rows_choices=rows)


def test_session_predict_matches_jax(data_dir):
    """Payloads of 1-20 rows (1-3 slots) through both sessions' sequential
    predict, and a batch larger than the top rung (two chunks)."""
    js = JaxSession(data_dir=data_dir)
    ts = TorchSession(device="cpu")
    for p in _payloads():
        np.testing.assert_allclose(ts.predict(p), js.predict(p), rtol=0, atol=PROB_ATOL)
    assert ts.predict(np.zeros((0, 784), np.float32)).shape == (0, 10)
    big = np.random.RandomState(3).randn(8 * 16 + 5, 784).astype(np.float32)
    got = ts.predict(big)  # more than the top rung: two chunks
    assert got.shape == (133, 10)
    np.testing.assert_allclose(got, js.predict(big), rtol=0, atol=PROB_ATOL)
    with pytest.raises(ValueError, match="784"):
        ts.predict(np.zeros((2, 5), np.float32))


def test_session_surface():
    ts = TorchSession(device="cpu", predict_slot_rows=4, predict_slot_ladder=(1, 3))
    assert ts.slot_rows == 4 and ts.slot_ladder == (1, 3)
    assert ts.spec.sizes == FLAGSHIP_SIZES and ts.device == torch.device("cpu")
    # the cost model's floor: one 4-row slot's forward FLOPs over the
    # nominal CPU peak (on the card: its fp32 data-sheet peak)
    bound = ts.inference_latency_bound()
    assert bound["flops"] == 2 * sum(a * b for a, b in zip(FLAGSHIP_SIZES, FLAGSHIP_SIZES[1:])) * 4
    assert bound["seconds"] == bound["flops"] / 2e11
    assert bound["peak_source"] == "nominal-cpu-default"
    with pytest.raises(ValueError, match="ROADMAP"):
        TorchSession(device="cpu", precision="default")
    with pytest.raises(ValueError, match="precision"):
        TorchSession(device="cpu", precision="fast")
    with pytest.raises(ValueError, match="increasing"):
        TorchSession(device="cpu", predict_slot_ladder=(2, 2))
    deep = TorchSession(model="transformer", device="cpu")
    assert deep.spec.act == "gelu" and deep.predict(np.ones((3, 784))).shape == (3, 10)


def test_device_rule(monkeypatch):
    """Without CUDA, every entry point that was not asked for the CPU
    raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--requests", "2"])
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_engines_agree_and_port_is_bitwise(data_dir):
    """One payload stream through both engines: the same verdicts in the
    same order, responses within tolerance of each other, and every port
    response bitwise-equal to the port's own direct predict()."""
    payloads = _payloads(n=30, seed=4, rows=(1, 2, 3, 4, 8, 9, 16))
    js, ts = JaxSession(data_dir=data_dir), TorchSession(device="cpu")
    jdone = jloadgen.run_closed_loop(jengine.ServingEngine(js), payloads, concurrency=5)
    te = tengine.ServingEngine(ts)
    te.warm_ladder()
    tdone = tloadgen.run_closed_loop(te, payloads, concurrency=5)
    assert [(r.id, r.verdict) for r in tdone] == [(r.id, r.verdict) for r in jdone]
    assert all(r.verdict == "ok" for r in tdone)
    by_id = {r.id: r for r in jdone}
    for r in tdone:
        assert np.array_equal(r.result, ts.predict(payloads[r.id]))
        np.testing.assert_allclose(r.result, by_id[r.id].result, rtol=0, atol=PROB_ATOL)
    st = te.stats()
    assert st["completed"] == 30 and st["availability"] == 1.0
    assert st["slots_dispatched"] == sum(-(-p.shape[0] // 8) for p in payloads)
    assert st["p50_latency_s"] is not None and st["goodput_rps"] is None


class _FlakySession:
    """A session stand-in both engines accept: predict raises on the calls
    named in ``fail_calls`` and returns NaN on those in ``nan_calls``."""

    def __init__(self, fail_calls=(), nan_calls=()):
        self.spec = jmodel.make_model_spec((4, 3, 2), 1, 8)
        self.slot_rows, self.slot_ladder, self.sequential = 2, (1, 2, 4), True
        self.calls = 0
        self._fail, self._nan = set(fail_calls), set(nan_calls)

    def predict(self, x):
        k = self.calls
        self.calls += 1
        if k in self._fail:
            raise RuntimeError(f"dispatch {k} failed")
        out = np.tile(np.arange(2, dtype=np.float32), (len(x), 1)) + x[:, :1]
        return np.full_like(out, np.nan) if k in self._nan else out

    def inference_latency_bound(self):
        return {"seconds": None, "ticks": None, "peak_source": "unmeasured"}


@pytest.mark.parametrize(
    "fail_calls,nan_calls,threshold",
    [((0,), (), 3), ((0, 1), (), 3), ((), (1,), 3), ((0, 1, 2, 3), (), 2)],
    ids=["retry", "exhaust", "unhealthy", "breaker"],
)
def test_engine_failure_semantics_match_jax(fail_calls, nan_calls, threshold):
    """Dispatch retry, exhausted budgets, the finiteness gate and the
    breaker give the same verdict sequence and counters in both engines."""
    rng = np.random.RandomState(2)
    payloads = [rng.randn(int(n), 4).astype(np.float32) for n in rng.randint(1, 5, 12)]
    runs = []
    for mod in (jengine, tengine):
        eng = mod.ServingEngine(
            _FlakySession(fail_calls, nan_calls), max_slots=2, retry=2,
            breaker_threshold=threshold,
        )
        reqs = [eng.submit(p) for p in payloads[:6]]
        eng.drain()
        reqs += [eng.submit(p) for p in payloads[6:]]
        eng.drain()
        st = eng.stats()
        keys = ("completed", "dropped", "errors", "unhealthy", "retries",
                "failed_dispatches", "breaker_trips", "dispatches", "degraded")
        runs.append(([r.verdict for r in reqs], {k: st[k] for k in keys}))
        results = [r.result for r in reqs if r.verdict == "ok"]
        runs[-1] += (results,)
    (vj, sj, rj), (vt, stt, rt) = runs
    assert vt == vj and stt == sj
    assert all(np.array_equal(a, b) for a, b in zip(rt, rj))
    assert set(vt) <= set(tengine.TERMINAL_VERDICTS)
    # st is the port engine's (the loop's last): it keeps the error text
    if fail_calls:
        assert st["last_error"].startswith("RuntimeError: dispatch")
    else:
        assert st["last_error"] is None


def test_engine_sheds_passed_deadlines_and_refuses_oversize():
    """A head request whose deadline has passed is shed as "expired"
    before costing a slot; the next one still serves."""
    clock = iter(np.arange(0.0, 100.0, 0.01)).__next__
    eng = tengine.ServingEngine(_FlakySession(), clock=clock)
    late = eng.submit(np.ones((1, 4)), deadline_ms=1.0, arrival_t=-1.0)
    eng.submit(np.ones((1, 4)))
    done = eng.step()
    assert [r.verdict for r in done] == ["expired", "ok"] and late.result is None
    with pytest.raises(ValueError, match="split it"):
        eng.submit(np.ones((9, 4)))
    with pytest.raises(ValueError, match="top rung"):
        tengine.ServingEngine(_FlakySession(), max_slots=5)
    rec = eng.record_summary(offered_rps=10.0)
    assert rec["latency_bound_source"] == "unmeasured" and rec["expired"] == 1


def test_loadgen_slots_stats_retry_copies_match_jax():
    """The pure-Python copies give the JAX package's exact outputs."""
    a_t = tloadgen.poisson_arrivals(250.0, 40, seed=3)
    assert np.array_equal(a_t, jloadgen.poisson_arrivals(250.0, 40, seed=3))
    for pt, pj in zip(_payloads(seed=6), jloadgen.request_payloads(
        24, 784, seed=6, rows_choices=tuple(range(1, 21))
    )):
        assert np.array_equal(pt, pj)
    assert tslots.DEFAULT_SLOT_LADDER == jslots.DEFAULT_SLOT_LADDER
    for dp in (1, 2, 3):
        assert tslots.default_slot_rows(dp) == jslots.default_slot_rows(dp)
    for n in (1, 8, 9, 31):
        assert tslots.slots_needed(n, 8) == jslots.slots_needed(n, 8)
        assert tslots.rung_for(-(-n // 8), (1, 2, 4)) == jslots.rung_for(-(-n // 8), (1, 2, 4))
    slots = np.random.RandomState(1).randn(3, 4, 2)
    assert np.array_equal(tslots.pack_slots(slots, 2), jslots.pack_slots(slots, 2))
    samples = [0.3, None, 0.1, 0.7, 0.2]
    assert tstats.percentile(samples, 99) == jstats.percentile(samples, 99)
    assert tstats.percentile([None], 50) is None
    w = tstats.ThroughputWindow()
    w.note_enqueue(2.0), w.note_enqueue(1.0), w.note_complete(4.0)
    assert w.window_s == 3.0
    pol_t = tretry.RetryPolicy(attempts=4, base=0.5, seed=7)
    pol_j = jretry.RetryPolicy(attempts=4, base=0.5, seed=7)
    assert [pol_t.delay(i) for i in range(4)] == [pol_j.delay(i) for i in range(4)]
    assert pol_t.exhausted(4) and not pol_t.exhausted(3)


def test_open_loop_drive_and_graceful_stop():
    ts = TorchSession(device="cpu")
    eng = tengine.ServingEngine(ts, slo_ms=1e4)
    payloads = _payloads(n=12, seed=8, rows=(1, 3, 8))
    done = tloadgen.run_open_loop(eng, payloads, np.zeros(12))
    assert [r.id for r in done] == list(range(12))
    st = eng.stats()
    assert st["slo_met"] == 12 and st["goodput_rps"] > 0
    polls = iter([False, True]).__next__
    stopped = tloadgen.run_closed_loop(
        tengine.ServingEngine(ts), payloads, concurrency=2, should_stop=polls
    )
    assert 0 < len(stopped) < 12


def _jax_checkpoint(tmp_path):
    """A v2 snapshot written by the JAX package, with weights away from the
    init (so a loader that ignored them would be caught)."""
    spec = jmodel.make_model_spec(FLAGSHIP_SIZES, 1, 128)
    rng = np.random.RandomState(11)
    params = [
        [
            {
                "W": (l["W"] + 0.05 * rng.randn(*l["W"].shape)).astype(np.float32),
                "b": (0.05 * rng.randn(*l["b"].shape)).astype(np.float32),
            }
            for l in stage
        ]
        for stage in jmodel.init_model(spec)
    ]
    path = tmp_path / "ck.npz"
    jckpt.save_checkpoint(path, params, spec, epoch=3)
    return path, params


def test_jax_checkpoint_serves_in_port(tmp_path, data_dir):
    path, params = _jax_checkpoint(tmp_path)
    ts = TorchSession(device="cpu", resume=path)
    for got, want in zip(ts.params()[0], params[0]):
        assert np.array_equal(got["W"], want["W"]) and np.array_equal(got["b"], want["b"])
    js = JaxSession(data_dir=data_dir, resume=str(path))
    x = np.random.RandomState(12).randn(13, 784).astype(np.float32)
    np.testing.assert_allclose(ts.predict(x), js.predict(x), rtol=0, atol=PROB_ATOL)
    fresh = TorchSession(device="cpu")
    meta = fresh.load_weights(path)
    assert meta["epoch"] == 3
    assert np.array_equal(fresh.predict(x), ts.predict(x))
    # the same arrays through the already-verified assembly path
    p2, spec2, _ = load_checkpoint(path, 2)
    assert len(p2) == 2 and spec2.n_stages == 2
    with pytest.raises(ValueError, match="sizes"):
        TorchSession(device="cpu", model="mlp-wide", resume=path)


@pytest.mark.parametrize("damage", ["truncate", "empty", "bitflip", "foreign"])
def test_damaged_checkpoint_raises(tmp_path, damage):
    path, _ = _jax_checkpoint(tmp_path)
    raw = bytearray(path.read_bytes())
    if damage == "truncate":
        path.write_bytes(bytes(raw[: len(raw) // 2]))
    elif damage == "empty":
        path.write_bytes(b"")
    elif damage == "bitflip":
        arrays = dict(np.load(path))
        arrays["w0"] = arrays["w0"].copy()
        arrays["w0"][0, 0] += 1.0
        np.savez(path, **arrays)
    else:
        np.savez(path, w0=np.zeros(3))
    with pytest.raises(CheckpointError, match=str(path.name)):
        TorchSession(device="cpu", resume=path)


def test_cli_verify_on_cpu(capsys):
    rc = tcli.main(["--device", "cpu", "--requests", "20", "--rate", "2000", "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "20/20 responses bitwise-equal" in out
    assert "completed 20/20" in out and "model floor 0.01 ms (nominal-cpu-default)" in out
