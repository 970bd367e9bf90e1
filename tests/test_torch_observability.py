"""The port's copies of the JAX package's observability modules, held to
the originals on the same inputs: the JSONL writer (lines equal apart from
their ``ts``/``created`` stamps and spans' wall seconds, and each package's
``read_jsonl`` reads the other's files), the flight recorder, the health
monitor (the same findings on the same loss and norm sequences), the
rollups and alert rules behind ``LiveTelemetry``, the report and watch
CLIs (the same text on the same file) and the divergence CLI (the same
attribution and exit code). The digest checksum is bitwise the JAX
package's on adversarial float32 bit patterns.

The one deliberate text difference: a report or CLI hint names its own
package's module (``python -m shallowspeed_tpu_torch.observability.
divergence``), so rendered texts are compared with the port's package name
mapped onto the JAX one's.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from shallowspeed_tpu import utils as jutils
from shallowspeed_tpu.observability import divergence as jdiv
from shallowspeed_tpu.observability import flight as jflight
from shallowspeed_tpu.observability import health as jhealth
from shallowspeed_tpu.observability import metrics as jmetrics
from shallowspeed_tpu.observability import report as jreport
from shallowspeed_tpu.observability import rollup as jrollup
from shallowspeed_tpu.observability import slo as jslo
from shallowspeed_tpu.observability import watch as jwatch
from shallowspeed_tpu_torch import trainer as ttrainer
from shallowspeed_tpu_torch import utils as tutils
from shallowspeed_tpu_torch.observability import divergence as tdiv
from shallowspeed_tpu_torch.observability import flight as tflight
from shallowspeed_tpu_torch.observability import health as thealth
from shallowspeed_tpu_torch.observability import metrics as tmetrics
from shallowspeed_tpu_torch.observability import report as treport
from shallowspeed_tpu_torch.observability import rollup as trollup
from shallowspeed_tpu_torch.observability import slo as tslo
from shallowspeed_tpu_torch.observability import watch as twatch

NAN, INF = float("nan"), float("inf")


def _lines(path):
    """A JSONL file's records without their wall-clock stamps."""
    out = []
    for rec in jmetrics.read_jsonl(path):
        rec.pop("ts", None)
        rec.pop("created", None)
        if rec.get("kind") == "span":
            rec.pop("seconds", None)
        out.append(rec)
    return out


def _drive(mod, path):
    """One fixed sequence of recorder calls, non-finite values included
    (strict JSON goes through ``_json_safe``)."""
    m = mod.JsonlMetrics(path)
    m.counter("samples_trained", 128)
    m.counter("samples_trained", 256)
    m.gauge("mfu", 0.25)
    m.observe("epoch.seconds", 0.5)
    m.event("cost_model", flops_per_sample=1082052, peak_flops_per_chip=6.7e13,
            peak_source="datasheet", xla_flops_per_epoch=None, n_devices=1)
    m.event("epoch", epoch=0, loss=NAN, samples_per_sec=1000.0, wall_s=2.0,
            includes_compile=True, mfu=1e-4)
    m.event("epoch", epoch=1, loss=0.5, samples_per_sec=2000.0, wall_s=1.0, mfu=2e-4)
    m.step("train", step=0, epoch=0, loss=INF, grad_norm=-INF, param_norm=1.5)
    m.step("train", step=1, epoch=0, loss=0.75, grad_norm=0.1, param_norm=1.5)
    m.health("non_finite", action="record", epoch=0, step=0, value=NAN, detail="loss=nan")
    m.checkpoint("step", path="ck/step-4.npz", epoch=0, step_in_epoch=4, global_step=4,
                 bytes=1234, wall_s=0.01, verify_s=0.001, write_s=0.002)
    m.recovery("resumed", resumed_from="ck/step-4.npz", epoch=0, step_in_epoch=4,
               global_step=4, skipped=[{"path": "ck/step-8.npz", "cause": "non-finite"}])
    m.digest("train", step=0, epoch=0, layers=2, crc_w=[1, 2**32 - 1], crc_b=[3, 4],
             pnorm_w=[0.5, NAN], pnorm_b=[0.1, 0.2], gnorm_w=[0.0, 1.0], gnorm_b=[0.0, 0.5])
    m.static_analysis("epoch_program", passes=["send_recv"], findings=0)
    m.event("dispatch_overhead", program="epoch_program", dispatch_overhead=0.9,
            device_busy_s=0.01, host_wall_s=0.1, repeats=2, op_events=100,
            op_source="device", profiler_inflation=1.5, window_valid=True,
            window_invalid_reason=None, events_per_batch=3.0)
    with m.span("train_epoch"):
        with m.span("eval"):
            pass
    summary = m.summary()
    m.close()
    summary.pop("spans", None)
    return summary


def test_jsonl_writer_lines_and_summary_equal_and_cross_readable(tmp_path):
    jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    assert _drive(jmetrics, jp) == _drive(tmetrics, tp)
    assert _lines(jp) == _lines(tp)
    assert tmetrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION == 13
    assert tmetrics.SCHEMA_KINDS == jmetrics.SCHEMA_KINDS
    # each package reads the other's file
    assert len(jmetrics.read_jsonl(tp)) == len(tmetrics.read_jsonl(jp)) == len(_lines(jp))
    assert tmetrics.replica_shard_path("m.jsonl", 3) == jmetrics.replica_shard_path("m.jsonl", 3)
    # one process: the path stays bare
    assert tmetrics.JsonlMetrics(tmp_path / "x.jsonl").path == str(tmp_path / "x.jsonl")


def test_flight_recorder_equal():
    rng = np.random.RandomState(0)
    losses, gns, pns = rng.rand(3, 40)
    losses[7] = NAN
    outs = []
    for mod in (jflight, tflight):
        fr = mod.FlightRecorder(capacity=16)
        s0 = fr.record_epoch(0, losses[:20], gns[:20], pns[:20], first_step=0)
        s1 = fr.record_epoch(1, losses[20:], gns[20:], pns[20:], first_step=20)
        outs.append((s0, s1, fr.last(5), fr.snapshot(), fr.total_steps))
    assert json.dumps(outs[0], default=str) == json.dumps(outs[1], default=str)


def _health_sequences():
    """Losses and norms that trip every check: a NaN, a divergence after a
    flat history, a grad-norm spike, an Inf param norm."""
    losses = np.full(40, 0.5)
    losses[10] = NAN
    losses[25:28] = 4.0
    gns = np.full(40, 0.05)
    gns[18] = 5.0
    pns = np.full(40, 27.7)
    pns[33] = INF
    return losses, gns, pns


@pytest.mark.parametrize("policy", ["record", "warn", "halt"])
def test_health_monitor_same_findings(policy, tmp_path):
    losses, gns, pns = _health_sequences()
    results = []
    for name, mod, mmod in (("j", jhealth, jmetrics), ("t", thealth, tmetrics)):
        mon = mod.make_monitor(policy)
        rec = mmod.JsonlMetrics(tmp_path / f"{name}.jsonl")
        err = None
        found = mon.check_epoch(0, losses, gns, pns, first_step=0)
        stderr = io.StringIO()
        with contextlib.redirect_stderr(stderr):
            try:
                mon.dispatch(found, rec)
            except mod.HealthError as e:
                err = str(e)
        run = mon.check_run(1, [0.5, NAN], [0.1, 0.2])
        rec.close()
        results.append((found, run, err, stderr.getvalue(), _lines(tmp_path / f"{name}.jsonl")))
    j, t = results
    assert json.dumps(j, default=str) == json.dumps(t, default=str)
    assert {f["check"] for f in j[0]} >= {"non_finite", "loss_divergence", "grad_spike"}
    assert (j[2] is not None) == (policy == "halt")


def test_live_telemetry_rollups_and_alerts_equal(tmp_path):
    for name, smod, mmod in (("j", jslo, jmetrics), ("t", tslo, tmetrics)):
        rec = mmod.JsonlMetrics(tmp_path / f"{name}.jsonl")
        tel = smod.LiveTelemetry("train", metrics=rec, rules=smod.default_training_rules())
        for i in range(30):
            t = 0.25 * i
            tel.note_step(t, loss=1.0 / (i + 1), step_s=0.2, throughput=640.0, mfu=1e-3)
            if i % 7 == 3:
                tel.note_checkpoint(t, 0.15)
            if i == 20:
                tel.note_health(t, "non_finite")
        tel.flush()
        rec.close()
    assert _lines(tmp_path / "j.jsonl") == _lines(tmp_path / "t.jsonl")
    kinds = {r["kind"] for r in _lines(tmp_path / "t.jsonl")}
    assert {"rollup", "alert"} <= kinds


def test_quantile_sketch_equal():
    rng = np.random.RandomState(1)
    vals = rng.lognormal(-6, 1, 500)
    sk = []
    for mod in (jrollup, trollup):
        a, b = mod.QuantileSketch(), mod.QuantileSketch()
        for v in vals[:250]:
            a.add(float(v))
        for v in vals[250:]:
            b.add(float(v))
        a.merge(b)
        sk.append((a.to_dict(), a.summary(), a.percentile(99)))
    assert sk[0] == sk[1]


def _cli_text(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().replace("shallowspeed_tpu_torch.", "shallowspeed_tpu.")


@pytest.mark.parametrize("fmt", ["md", "text", "json"])
def test_report_renders_the_same_text(fmt, tmp_path):
    path = tmp_path / "run.jsonl"
    _drive(tmetrics, path)
    assert _cli_text(treport.main, [str(path), "--format", fmt]) == _cli_text(
        jreport.main, [str(path), "--format", fmt]
    )


def test_watch_once_renders_the_same_text(tmp_path):
    # finite step records only: both copies of the watcher fold a step's
    # loss into a min/max gauge, and a non-finite loss (written as the
    # string "Infinity") stops them both with a TypeError (ROADMAP.md §C)
    path = tmp_path / "run.jsonl"
    _digest_stream(jmetrics, path)
    rec = tmetrics.JsonlMetrics(tmp_path / "live.jsonl")
    tel = tslo.LiveTelemetry("train", metrics=rec, rules=tslo.default_training_rules())
    for i in range(12):
        tel.note_step(0.5 * i, loss=0.9 - 0.01 * i, step_s=0.1, throughput=1280.0, mfu=1e-3)
    tel.flush()
    rec.close()
    for p in (path, tmp_path / "live.jsonl"):
        for fmt in ("text", "json"):
            argv = [str(p), "--once", "--format", fmt]
            assert _cli_text(twatch.main, argv) == _cli_text(jwatch.main, argv)


def _digest_stream(mod, path, flip_at=None):
    """Six steps of two-layer digest records; ``flip_at`` changes layer 1's
    W checksum (by one) and norm (by one ulp's worth) from that step on."""
    m = mod.JsonlMetrics(path)
    m.event("digest_config", sizes=[4, 3, 2], dp=1, pp=1, tp=1)
    for s in range(6):
        crc_w = [1000 + s, 2000 + s]
        pw = [1.0 + s, 2.0 + s]
        if flip_at is not None and s >= flip_at:
            crc_w[1] += 1
            pw[1] *= 1 + 1e-10
        m.digest("train", step=s, epoch=0, layers=2, crc_w=crc_w, crc_b=[7, 8],
                 pnorm_w=pw, pnorm_b=[0.5, 0.5], gnorm_w=[0.1, 0.1], gnorm_b=[0.0, 0.0])
    m.close()


def test_divergence_cli_same_attribution(tmp_path):
    a, b, c = (tmp_path / f"{n}.jsonl" for n in "abc")
    _digest_stream(tmetrics, a)
    _digest_stream(tmetrics, b, flip_at=3)
    _digest_stream(jmetrics, c)
    got = _cli_text(tdiv.main, [str(a), str(b)])
    assert got == _cli_text(jdiv.main, [str(a), str(b)])
    assert got[0] == 2 and "step 3" in got[1] and "layer 1" in got[1]
    same = _cli_text(tdiv.main, [str(a), str(c)])
    assert same == _cli_text(jdiv.main, [str(a), str(c)]) and same[0] == 0
    sa, sb = tdiv.digest_stream(tmetrics.read_jsonl(a)), tdiv.digest_stream(tmetrics.read_jsonl(b))
    assert tdiv.first_divergence(sa, sb) == jdiv.first_divergence(sa, sb)


# float32 words a checksum must treat as plain bits: +0, -0, the smallest
# denormal, the largest finite, +-Inf, quiet and signalling NaN payloads,
# all ones
ADVERSARIAL_WORDS = np.array(
    [0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x7F7FFFFF, 0x7F800000,
     0xFF800000, 0x7FC00001, 0x7F800001, 0xFFFFFFFF, 0x3F800000],
    np.uint32,
)


@pytest.mark.parametrize("n", [11, 4096 + 11])
def test_block_checksum_bitwise_on_adversarial_bits(n):
    rng = np.random.RandomState(n)
    words = np.concatenate([ADVERSARIAL_WORDS, rng.randint(0, 2**32, n - 11, dtype=np.uint64).astype(np.uint32)])
    arr = words.view(np.float32)
    want = jutils.block_checksum(arr)
    assert tutils.block_checksum(arr) == want
    assert int(ttrainer.block_crc(torch.from_numpy(arr.copy()))) == want
    rows = torch.from_numpy(np.stack([arr, arr[::-1].copy()]))
    assert ttrainer.row_crcs(rows).tolist() == [want, jutils.block_checksum(arr[::-1].copy())]
    # the JAX device-side digest (trainer._digest_aux's bitcast uint32 sum)
    dev = jnp.sum(lax.bitcast_convert_type(jnp.asarray(words), jnp.uint32), dtype=jnp.uint32)
    assert int(dev) == want
