"""The port's program audit (``shallowspeed_tpu_torch/observability/
program_audit.py``) against the JAX module, on the CPU.

- The pure functions (``expected_comms``, ``zero_peak_forecast``,
  ``check_census``, ``census_of_ops``, ``format_bytes``) are EXACTLY equal
  to the JAX module's, on the JAX test's inputs
  (``tests/test_program_audit.py``) and on each lattice point below, at
  ``platform="cpu"``.
- The census the executor's data movers give is clean (``census_ok``) at
  every lattice point, with the contract's required kinds present and its
  forbidden kinds absent, the tp floor met, and the JAX ``check_census``
  giving the same verdict. A kind JAX compiles but the contract does not
  demand need not appear (the pp = 1 self-loop permute).
- Negative controls under ``audit=True``: a no-op ``dp_sum``, a relay that
  drops the backward send, the ZeRO-1 gather turned into an all-reduce and
  a rung that writes its params each raise ``AuditMismatchError`` before
  the first step, with params and optimizer state bitwise unchanged.
- Audit on and off end bitwise equal; ``hbm_per_chip("gpu")`` without a
  card raises.

The JAX bucketed census is not an oracle here (its bucketed-census tests
fail on every run, ROADMAP.md §C): the bucketed cases are held to the
port's own contract.
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import schedules as jS
from shallowspeed_tpu.observability import program_audit as jpa
from shallowspeed_tpu.parallel import gradsync as jgs
from shallowspeed_tpu.parallel import lowering as jlow
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import schedules as tS
from shallowspeed_tpu_torch.api import TrainingSession
from shallowspeed_tpu_torch.observability import program_audit as pa
from shallowspeed_tpu_torch.observability.metrics import MetricsRecorder
from shallowspeed_tpu_torch.parallel import executor as E
from shallowspeed_tpu_torch.parallel import gradsync as tgs
from shallowspeed_tpu_torch.parallel import lowering as tlow
from shallowspeed_tpu_torch.serving import slots

SIZES = (24, 20, 18, 16, 14, 12, 11, 10)
N, GBS, M = 256, 64, 4


class Recorder(MetricsRecorder):
    """The in-memory recorder, keeping every record."""

    def __init__(self):
        super().__init__()
        self.records = []

    def _emit(self, record):
        self.records.append(record)

    def audits(self, name=None):
        return [
            r for r in self.records
            if r["kind"] == "xla_audit" and (name is None or r["name"] == name)
        ]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("audit_data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", N), ("val", 96)):
        x = rng.randn(n, SIZES[0]).astype(np.float32)
        y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], n)]
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", y)
    return path


def _session(data_dir, **kw):
    return TrainingSession(
        sizes=SIZES, global_batch_size=GBS, mubatches=M, lr=0.01, data_dir=data_dir,
        record_steps=False, device="cpu", **kw,
    )


# ---------------------------------------------------------------------------
# the pure functions, exactly the JAX module's
# ---------------------------------------------------------------------------

_PKGS = {
    "jax": (jmodel, jS, jlow, jgs, jpa),
    "port": (tmodel, tS, tlow, tgs, pa),
}

# (id, layout) — the lattice of the census tests below, plus the JAX
# test's extra inputs (zero 1 at dp = 1, the bucketed 2048 plans, opt
# state parts, an inference rung of 4 slots)
CONTRACTS = [
    ("seq", dict()),
    ("dp2", dict(dp=2)),
    ("gpipe-pp4", dict(pp=4)),
    ("zero1", dict(dp=2, pp=2, zero=1)),
    ("zero1-dp1", dict(pp=2, zero=1)),
    ("zero2", dict(dp=2, pp=2, zero=2, parts=2)),
    ("zero3", dict(dp=2, pp=2, zero=3, parts=1)),
    ("zero3-recompute", dict(dp=2, pp=2, zero=3, rec=True)),
    ("dp2-bucketed-65536", dict(dp=2, bucket=65536)),
    ("dp2pp2-bucketed-2048", dict(dp=2, pp=2, bucket=2048)),
    ("zero1-bucketed-2048", dict(dp=2, pp=2, zero=1, bucket=2048)),
    ("zero2-bucketed-2048", dict(dp=2, pp=2, zero=2, bucket=2048, parts=2)),
    ("tp2", dict(tp=2)),
    ("dp2-tp2", dict(dp=2, tp=2)),
    ("dp2pp2tp2-zero2", dict(dp=2, pp=2, tp=2, zero=2)),
    ("split-pp4", dict(pp=4, schedule="pipedream", split=True)),
    ("recompute-pp4", dict(pp=4, rec=True)),
    ("recompute-pp2tp2", dict(pp=2, tp=2, rec=True)),
    ("interleaved-pp2v2", dict(pp=2, schedule="interleaved", V=2)),
    ("infer-pp4", dict(pp=4, infer=1)),
    ("infer-pp4-rung4", dict(pp=4, infer=4)),
    ("infer-dp2pp2tp2", dict(dp=2, pp=2, tp=2, infer=1)),
    ("infer-dp2", dict(dp=2, infer=2)),
    ("infer-pp2v2", dict(pp=2, V=2, infer=1)),
]


def _contract(pkg, dp=1, pp=1, tp=1, zero=0, bucket=0, schedule="gpipe", V=1,
              split=False, rec=False, infer=None, parts=0, mb=8):
    model, S, low, gs, mod = _PKGS[pkg]
    spec = model.make_model_spec(SIZES, pp * V, GBS)
    if (dp, pp, tp, V) == (1, 1, 1, 1):
        return mod.expected_comms(spec, 1, 1, platform="cpu", precision="highest")
    if infer is not None:
        sched = S.InterleavedInferenceSchedule if V > 1 else S.InferenceSchedule
        prog = low.lower_schedule(sched, infer, pp, training=False, virtual=V)
    else:
        prog = low.lower_schedule(
            S.SCHEDULES[schedule], M, pp, virtual=V, backward_split=split, recompute=rec
        )
        mb = GBS // dp // M
    plan = gs.plan_buckets(spec, dp, pp, bucket, zero=zero, tp=tp) if bucket else None
    return mod.expected_comms(
        spec, dp, pp, prog=prog, zero=zero, mubatch_size=mb, platform="cpu",
        precision="highest", grad_bucket_plan=plan, tp=tp, opt_state_parts=parts,
    )


@pytest.mark.parametrize("layout", [c[1] for c in CONTRACTS], ids=[c[0] for c in CONTRACTS])
def test_expected_comms_equals_the_jax_contract(layout):
    mine, ref = _contract("port", **layout), _contract("jax", **layout)
    assert mine == ref


@pytest.mark.parametrize(
    "dp, pp, tp, parts, chunks, bucketed",
    [(2, 2, 1, 0, 1, False), (2, 4, 1, 2, 1, False), (4, 2, 2, 1, 2, True),
     (2, 2, 2, 2, 1, True), (1, 2, 1, 1, 1, False), (2, 1, 1, 0, 1, False)],
)
def test_zero_peak_forecast_equals_the_jax_forecast(dp, pp, tp, parts, chunks, bucketed):
    out = []
    for model, mod in ((jmodel, jpa), (tmodel, pa)):
        spec = model.make_model_spec(SIZES, pp * chunks, GBS)
        out.append(mod.zero_peak_forecast(
            spec, dp, pp, tp=tp, state_parts=parts, num_chunks=chunks, bucketed=bucketed
        ))
    assert out[0] == out[1]


# the JAX test's check_census inputs (test_check_census_contract_rules,
# test_verify_census_raises_loudly_on_mismatch, test_check_census_bucketed_rules)
_SEQ = {"required": [], "forbidden": ["all_reduce", "collective_permute"]}
_DP = {"required": ["all_reduce", "collective_permute"], "forbidden": ["reduce_scatter", "all_gather"]}
_OK = {"all_reduce": {"count": 14, "bytes": 1}, "collective_permute": {"count": 2, "bytes": 1}}
_BUCKETED = {
    "dp": 2, "zero1": False, "required": ["all_reduce"], "forbidden": [],
    "axes": {"dp": {"mode": "bucketed", "num_buckets": 3, "bucket_census_bytes": [1024, 512, 256]}},
}
_Z1 = {
    "dp": 2, "zero1": True, "required": ["reduce_scatter", "all_gather"], "forbidden": [],
    "axes": {"dp": {"mode": "bucketed", "num_buckets": 2, "bucket_census_bytes": [256, 128]}},
}


def _ops(kind, sizes):
    return [{"kind": kind, "bytes": b} for b in sizes]


CENSUS_CASES = [
    ({}, _SEQ, None),
    ({"all_reduce": {"count": 3, "bytes": 1}}, _SEQ, None),
    (_OK, _DP, None),
    ({"collective_permute": {"count": 2, "bytes": 1}}, _DP, None),
    (dict(_OK, reduce_scatter={"count": 1, "bytes": 9}), _DP, None),
    (dict(_OK, collective_permute={"count": 1, "bytes": 1}), _DP, None),
    ({"all_gather": {"count": 1, "bytes": 64}}, {"required": ["all_reduce"], "forbidden": ["all_gather"]}, None),
    (None, _BUCKETED, _ops("all_reduce", (1024, 512, 256, 4))),
    (None, _BUCKETED, _ops("all_reduce", (1536, 256))),
    (None, _BUCKETED, _ops("all_reduce", (1792,))),
    (None, _BUCKETED, _ops("all_reduce", (1280, 512))),
    (None, _BUCKETED, _ops("all_reduce", (700, 324, 400, 112, 200, 56))),
    (None, _BUCKETED, _ops("all_reduce", (700, 836))),
    (None, _Z1, _ops("reduce_scatter", (256, 128)) + _ops("all_gather", (512,))),
    ({}, dict(_BUCKETED, dp=1, required=[]), []),
    (None, _BUCKETED, "no-ops"),
    # the inference and tp legs
    ({"all_reduce": {"count": 2, "bytes": 8}}, {"inference": True, "required": [], "forbidden": []}, None),
    ({"all_reduce": {"count": 3, "bytes": 8}},
     {"inference": True, "required": ["all_reduce"], "forbidden": [],
      "axes": {"tp": {"hlo_min_all_reduce_ops": 4, "sites_fwd": 4, "sites_bwd": 0}}}, None),
    ({"all_reduce": {"count": 6, "bytes": 8}},
     {"inference": True, "required": ["all_reduce"], "forbidden": [],
      "axes": {"tp": {"hlo_min_all_reduce_ops": 4, "sites_fwd": 4, "sites_bwd": 0}}}, None),
    ({"all_gather": {"count": 2, "bytes": 8}, "reduce_scatter": {"count": 1, "bytes": 8}},
     {"dp": 2, "required": ["reduce_scatter", "all_gather"], "forbidden": [],
      "axes": {"dp": {"hlo_min_all_gather_ops": 3}}}, None),
]


@pytest.mark.parametrize("census, expected, ops", CENSUS_CASES, ids=range(len(CENSUS_CASES)))
def test_check_census_equals_the_jax_check(census, expected, ops):
    if ops == "no-ops":
        census, ops = pa.census_of_ops(_ops("all_reduce", (1024, 512, 256))), None
    elif census is None:
        census = pa.census_of_ops(ops)
        assert census == jpa.census_of_ops(ops)
    mine = pa.check_census(census, expected, ops=ops)
    assert mine == jpa.check_census(census, expected, ops=ops)
    if mine:
        with pytest.raises(pa.AuditMismatchError, match="disagrees with the layout contract"):
            pa.verify_census(census, expected, ops=ops)
    else:
        pa.verify_census(census, expected, ops=ops)


@pytest.mark.parametrize("n", [None, float("nan"), 0, 512, 4096, 3 * 2**20 + 7, 5 * 2**30, -2048])
def test_format_bytes_equals_the_jax_format(n):
    assert pa.format_bytes(n) == jpa.format_bytes(n)


# ---------------------------------------------------------------------------
# the movers' census at every lattice point
# ---------------------------------------------------------------------------

LATTICE = [
    ("seq", dict()),
    ("dp2", dict(dp=2)),
    ("gpipe-pp4", dict(pp=4, schedule="gpipe")),
    ("zero1", dict(dp=2, pp=2, schedule="gpipe", zero1=True)),
    ("zero2", dict(dp=2, pp=2, zero=2, optimizer="momentum")),
    ("zero3", dict(dp=2, pp=2, zero=3)),
    ("dp2-bucketed", dict(dp=2, grad_bucket_bytes=65536)),
    ("dp2-bucketed-2048", dict(dp=2, pp=2, grad_bucket_bytes=2048)),
    ("zero1-bucketed-2048", dict(dp=2, pp=2, zero=1, grad_bucket_bytes=2048)),
    ("zero2-bucketed-2048", dict(dp=2, pp=2, zero=2, grad_bucket_bytes=2048)),
    ("tp2", dict(tp=2)),
    ("dp2-tp2", dict(dp=2, tp=2)),
    ("split-pp4", dict(pp=4, schedule="pipedream", backward_split=True)),
    ("recompute-pp4", dict(pp=4, recompute=True)),
    ("recompute-pp2tp2-zero3", dict(dp=2, pp=2, tp=2, zero=3, recompute=True)),
    ("interleaved-pp2v2", dict(pp=2, schedule="interleaved", virtual_stages=2)),
]


def _check_record(rec):
    """A record's census holds its contract, in both modules' words."""
    assert rec["census_ok"] is True, rec["mismatches"]
    assert rec["hlo_available"] is False and rec["census_source"] == "movers"
    census, exp = rec["census"], rec["expected"]
    for kind in exp["required"]:
        assert census.get(kind, {}).get("count", 0) >= 1, (kind, census)
    for kind in exp["forbidden"]:
        assert kind not in census, (kind, census)
    ops = [{"kind": k, "bytes": b} for k, b in rec["census_sites"].values()]
    assert pa.census_of_ops(ops) == census
    assert jpa.check_census(census, exp, ops=ops) == []
    tp_axis = exp["axes"].get("tp")
    if tp_axis:
        assert census["all_reduce"]["count"] >= tp_axis["hlo_min_all_reduce_ops"]
    # the CPU has no device allocator: every memory value is None, with why
    mem = rec["memory"]
    assert mem["peak_hbm_bytes"] is None and "reason" in mem
    assert rec["platform"] == "cpu" and "nominal" in rec["hbm_source"]


@pytest.mark.parametrize("layout", [c[1] for c in LATTICE], ids=[c[0] for c in LATTICE])
def test_mover_census_holds_the_contract(data_dir, layout):
    rec = Recorder()
    s = _session(data_dir, metrics=rec, audit=True, **layout)
    s.train_steps(1)
    (audit,) = rec.audits("chunk_program")
    _check_record(audit)
    census, exp = audit["census"], audit["expected"]
    sites = audit["census_sites"]
    if s.pp > 1:
        # the relay is two sites, one per direction
        assert {"relay.fwd", "relay.bwd"} <= set(sites)
        assert census["collective_permute"]["count"] == 2
    else:
        # the pp = 1 self-loop permute JAX compiles is not demanded, and
        # the port's movers make none
        assert "collective_permute" not in census
    if exp["sequential"]:
        assert census == {}
    dp_axis = exp["axes"].get("dp") or {}
    if dp_axis.get("mode") == "bucketed":
        # ONE sync site of the anchor sum's total bytes, no per-bucket op
        kind = "reduce_scatter" if exp["zero"] else "all_reduce"
        site = "zero_sum" if exp["zero"] else "dp_sum"
        assert sites[site] == [kind, sum(dp_axis["bucket_census_bytes"])]
    if exp["zero"] == 3:
        branches = 3 if s._recompute else 2
        assert census["all_gather"]["count"] == branches
        assert dp_axis["hlo_min_all_gather_ops"] == branches


@pytest.mark.parametrize(
    "layout",
    [dict(pp=4, schedule="gpipe"), dict(dp=2, pp=2, tp=2), dict(dp=2), dict(pp=2, schedule="interleaved", virtual_stages=2)],
    ids=["pp4", "dp2pp2tp2", "dp2", "pp2v2"],
)
def test_inference_rung_census_holds_the_forward_only_contract(data_dir, layout):
    rec = Recorder()
    s = _session(data_dir, metrics=rec, audit=True, **layout)
    rows = np.random.RandomState(1).randn(3 * s.slot_rows, SIZES[0]).astype(np.float32)
    s.predict(rows)
    s.predict(rows)  # one record a rung
    (audit,) = rec.audits("inference_program")
    _check_record(audit)
    exp, census = audit["expected"], audit["census"]
    assert exp["inference"] is True
    assert "reduce_scatter" in exp["forbidden"] and "all_gather" in exp["forbidden"]
    need = (exp["axes"].get("tp") or {}).get("hlo_min_all_reduce_ops", 0)
    assert census.get("all_reduce", {}).get("count", 0) <= need + 1
    if s.pp > 1:
        assert census["collective_permute"]["count"] == 1  # forward only
    assert audit["dispatch_safety"]["mismatches"] == []
    assert audit["dispatch_safety"]["params_checked"] > 0
    # the contract is the rung's: the JAX function on the same program
    rung = slots.rung_for(3, s.slot_ladder)
    assert exp == _contract(
        "jax", dp=s.dp, pp=s.pp, tp=s.tp, V=s.V, infer=rung, mb=s.slot_rows // s.dp,
    )


def test_session_contract_is_the_jax_sessions(data_dir):
    """The session builds its contract as the JAX session does (the same
    function on its spec, program, plan, tp and optimizer parts)."""
    s = _session(data_dir, dp=2, pp=2, zero=2, grad_bucket_bytes=2048, optimizer="adam")
    spec = jmodel.make_model_spec(SIZES, 2, GBS)
    prog = jlow.lower_schedule(jS.SCHEDULES["gpipe"], M, 2)
    ref = jpa.expected_comms(
        spec, 2, 2, prog=prog, zero=2, mubatch_size=GBS // 2 // M, platform="cpu",
        precision="highest", grad_bucket_plan=jgs.plan_buckets(spec, 2, 2, 2048, zero=2),
        opt_state_parts=2,
    )
    assert s._expected_comms == ref


# ---------------------------------------------------------------------------
# negative controls: each raises before any state changes
# ---------------------------------------------------------------------------


def _state(s):
    st = s.opt_state_logical()
    return s.params(), st


def _assert_same(a, b):
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _dropped_bwd_relay(orig):
    def relay(mailbox, slot, payload, direction="fwd"):
        if direction == "bwd":  # the send is lost: the receiver reads zeros
            mailbox[slot] = torch.zeros_like(payload)
            return
        orig(mailbox, slot, payload, direction)

    return relay


def _gather_as_all_reduce(orig):
    def gather(vec, tree, tp=1):
        census, pa.active = pa.active, None
        try:
            orig(vec, tree, tp)
        finally:
            pa.active = census
        if census is not None:
            census.note("all_reduce", "zero1_gather", pa.nbytes(vec) // vec.shape[0])

    return gather


NEGATIVE = [
    ("dp_sum-noop", dict(dp=2, optimizer="momentum"), "dp_sum",
     lambda orig: (lambda trees, ranks=1: trees[0]), "required collective 'all_reduce'"),
    ("relay-dropped-bwd", dict(pp=4, schedule="gpipe", optimizer="momentum"), "relay",
     _dropped_bwd_relay, "BOTH directions"),
    ("zero1-gather-as-all-reduce", dict(dp=2, pp=2, zero=1, optimizer="adam"),
     "_unflat_rows_into", _gather_as_all_reduce, "required collective 'all_gather'"),
]


@pytest.mark.parametrize(
    "layout, attr, patch, match", [c[1:] for c in NEGATIVE], ids=[c[0] for c in NEGATIVE]
)
def test_negative_control_raises_before_any_state_changes(data_dir, monkeypatch, layout, attr, patch, match):
    rec = Recorder()
    s = _session(data_dir, metrics=rec, audit=True, **layout)
    before = _state(s)
    monkeypatch.setattr(E, attr, patch(getattr(E, attr)))
    for entry in (lambda: s.train_epoch(), lambda: s.train_steps(1)):
        with pytest.raises(pa.AuditMismatchError, match=match):
            entry()
    assert s.global_step == 0
    _assert_same(before, _state(s))
    # the evidence was recorded, every time (a failure is never latched)
    bad = [r for r in rec.audits() if r["census_ok"] is False]
    assert len(bad) == 2 and all(match in "; ".join(r["mismatches"]) for r in bad)


def test_rung_that_writes_its_params_fails_dispatch_safety(data_dir, monkeypatch):
    s = _session(data_dir, pp=2, audit=True)
    before = s.params()
    orig = E._stage_fwd

    def writes(Ws, bs, *args):
        bs[0].add_(1.0)  # an in-place write of a param the rung reads
        return orig(Ws, bs, *args)

    monkeypatch.setattr(E, "_stage_fwd", writes)
    rows = np.zeros((3, SIZES[0]), np.float32)
    with pytest.raises(pa.AuditMismatchError, match="writes its input buffers in place"):
        s.predict(rows)
    _assert_same(before, s.params())
    monkeypatch.setattr(E, "_stage_fwd", orig)
    s.predict(rows)  # the honest rung serves


def test_strict_contract_violation_is_never_latched(data_dir):
    """A broken contract (forced here, not the movers) raises before the
    first dispatch, and again on a retry."""
    s = _session(data_dir, dp=2, audit=True)
    s._expected_comms = dict(s._expected_comms, required=["all_to_all"], forbidden=["all_reduce"])
    for _ in range(2):
        with pytest.raises(pa.AuditMismatchError, match="all_to_all"):
            s.train_epoch()
    assert s.epoch == 0


@pytest.mark.parametrize(
    "layout",
    [dict(dp=2, pp=2, zero=2, optimizer="momentum"), dict(pp=4, recompute=True, optimizer="adam"),
     dict(dp=2, tp=2, zero=1)],
    ids=["zero2", "recompute", "dp2tp2-zero1"],
)
def test_audit_on_and_off_end_bitwise_equal(data_dir, layout):
    plain = _session(data_dir, **layout)
    audited = _session(data_dir, metrics=Recorder(), audit=True, **layout)
    recorded = _session(data_dir, metrics=Recorder(), **layout)
    for s in (plain, audited, recorded):
        s.train_epoch()
        s.train_steps(2)
    for s in (audited, recorded):
        _assert_same(_state(plain), _state(s))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_hbm_per_chip_gpu_without_a_card_raises(monkeypatch):
    monkeypatch.delenv(pa.ENV_HBM, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never assumed"):
        pa.hbm_per_chip("gpu")
    cap, src = pa.hbm_per_chip("cpu")
    assert (cap, src) == (jpa.hbm_per_chip("cpu")) and "nominal" in src
    bw, src = pa.interconnect_bytes_per_sec("gpu")
    assert bw is None and "one-card" in src
    assert pa.interconnect_bytes_per_sec("cpu") == jpa.interconnect_bytes_per_sec("cpu")
    assert "unknown-platform" in pa.hbm_per_chip("rocm")[1]
    monkeypatch.setenv(pa.ENV_HBM, "456")
    assert pa.hbm_per_chip("gpu") == (456.0, f"env:{pa.ENV_HBM}")


def test_census_recorder_and_memory_record():
    assert pa.active is None
    with pa.recording(torch.device("cpu"), argument_bytes=99) as (census, memory):
        assert pa.active is census
        with pytest.raises(RuntimeError, match="already recording"):
            with pa.recording("cpu"):
                pass
        census.note("all_reduce", "a", 8)
        census.note("all_reduce", "a", 16)  # the largest execution counts
        census.branch = "bwd"
        census.note("collective_permute", census.here("r"), 4)
        with pytest.raises(ValueError, match="unknown collective kind"):
            census.note("all-reduce", "b", 4)
        with pytest.raises(ValueError, match="moved all_reduce and all_gather"):
            census.note("all_gather", "a", 4)
    assert pa.active is None
    assert census.ops() == [
        {"kind": "all_reduce", "bytes": 16, "site": "a"},
        {"kind": "collective_permute", "bytes": 4, "site": "bwd/r"},
    ]
    assert memory["peak_hbm_bytes"] is None and "reason" in memory
    card = pa.memory_stats(1000, 24)
    assert card["peak_hbm_bytes"] == 1000 and card["argument_size_in_bytes"] == 24
    assert card["output_size_in_bytes"] is None and card["temp_size_in_bytes"] is None
    rec = pa.audit_program(census, memory, expected={"required": ["all_reduce"], "forbidden": []},
                           platform="cpu")
    assert rec["census"] == {"all_reduce": {"count": 1, "bytes": 16},
                             "collective_permute": {"count": 1, "bytes": 4}}
    assert rec["census_ok"] is True and rec["hlo_available"] is False
    assert "hbm_headroom_fraction" not in rec  # no peak measured
    assert rec["recorded_run_s"] == census.wall_s >= 0.0


def test_dispatch_safety_reads_the_write_counters():
    w = torch.zeros(3)
    tree = {"W": (w,), "b": (torch.zeros(2),)}
    before = pa.tensor_versions(tree)
    assert len(before) == 2
    assert pa.check_dispatch_safety(before, pa.tensor_versions(tree)) == []
    w[1:].add_(0.0)  # a write through a view counts on the base
    msgs = pa.check_dispatch_safety(before, pa.tensor_versions(tree), context="rung")
    assert msgs and msgs[0].startswith("rung: program writes its input buffers in place")
    clone = pa.clone_tree(tree)
    assert clone["W"][0] is not w and torch.equal(clone["W"][0], w)
