"""The port's AOT program cache (``shallowspeed_tpu_torch/aot_cache.py``)
against the JAX package's ``aot_cache.py`` and against the port's own
contracts.

The JAX store and load paths fail four of their seven tests on every run
(ROADMAP.md §C), so they are no oracle here. What is held to the JAX
module: ``content_hash`` and ``cache_key`` (the same hex on the same
inputs), the key's sensitivity to each of its parts, the on-disk format
(an entry the port writes parses in the JAX loader) and the ``aot_cache``
records' names and fields. What is held to the port's contracts: the
store's round trip and every failure mode (miss, corrupt bytes, a torn
file, a stale fingerprint, an unpicklable payload giving ``disabled``
once), a warm session serving and training bitwise its cold twin with no
``miss``/``store`` and each program audited before its first dispatch, a
bad entry giving a clean fallback and a rewrite, ``warm_run`` leaving the
state bitwise as it was, the library payload written into ``build/``
without ``nvcc``, and the ``--aot-cache`` CLI.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from shallowspeed_tpu import aot_cache as JAC
from shallowspeed_tpu.api import TrainingSession as JaxSession
from shallowspeed_tpu.observability import JsonlMetrics as JaxJsonl
from shallowspeed_tpu.observability import read_jsonl as jax_read_jsonl
from shallowspeed_tpu_torch import _build
from shallowspeed_tpu_torch import aot_cache as AC
from shallowspeed_tpu_torch import faults
from shallowspeed_tpu_torch import train as tcli
from shallowspeed_tpu_torch.api import TrainingSession
from shallowspeed_tpu_torch.observability import (
    SCHEMA_VERSION,
    JsonlMetrics,
    MetricsRecorder,
    read_jsonl,
)
from shallowspeed_tpu_torch.observability import program_audit as A
from shallowspeed_tpu_torch.observability.metrics import SCHEMA_KINDS
from shallowspeed_tpu_torch.parallel import executor as E

SIZES = (24, 20, 18, 16)
GBS = 64


class Recorder(MetricsRecorder):
    """The in-memory recorder, keeping every record it is handed."""

    def __init__(self):
        super().__init__()
        self.records = []

    def _emit(self, record):
        self.records.append(record)


@pytest.fixture(scope="module")
def flagship_dir(tmp_path_factory):
    """A small split at the flagship's widths (784 in, 10 classes) for the
    CLI, which trains the flagship MLP."""
    d = tmp_path_factory.mktemp("aot_flagship")
    rng = np.random.RandomState(1)
    for suffix, n in (("train", 128), ("val", 32)):
        np.save(d / f"x_{suffix}.npy", rng.rand(n, 784).astype(np.float32))
        np.save(d / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return d


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("aot_data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 256), ("val", 96)):
        np.save(d / f"x_{suffix}.npy", rng.randn(n, SIZES[0]).astype(np.float32))
        np.save(d / f"y_{suffix}.npy", np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], n)])
    return d


def _session(data_dir, cache, **kw):
    kw.setdefault("sizes", SIZES)
    kw.setdefault("global_batch_size", GBS)
    return TrainingSession(data_dir=data_dir, aot_cache_dir=cache, device="cpu", **kw)


ROWS = np.random.RandomState(7).rand(20, SIZES[0]).astype(np.float32)
LAYOUTS = {"seq": {}, "dp2": dict(dp=2), "pp2": dict(pp=2)}


# ---------------------------------------------------------------------------
# the key functions: the JAX module's
# ---------------------------------------------------------------------------

KEY_INPUTS = [
    ("p", (1, 2), {"jax": "0.0.0", "jaxlib": "0.0.0", "platform": "cpu"}, "module {}"),
    ("inference_r4", ((784, 128, 10), "relu", 2, 4, 1, 1, "gpipe", 128, 4, "highest", "pallas", 8, False),
     {"torch": "2.13.0", "cuda": "12.4", "format": 1, "platform": "cuda",
      "device_name": "NVIDIA H100 80GB HBM3", "capability": [9, 0], "nvcc": "release 12.4"},
     '{"program": "inference_r4", "tables": [[0, 1], [1, 0]]}'),
    ("epoch_program", (), {}, ""),
    ("ünïcode", ("x", None, 3.5), {"nested": {"b": [1, 2], "a": None}}, "ünïcode text\n"),
]


@pytest.mark.parametrize("case", range(len(KEY_INPUTS)))
def test_content_hash_and_cache_key_are_the_jax_functions(case):
    program, layout, fingerprint, text = KEY_INPUTS[case]
    assert AC.content_hash(text) == JAC.content_hash(text)
    assert AC.cache_key(program, layout, fingerprint, AC.content_hash(text)) == JAC.cache_key(
        program, layout, fingerprint, JAC.content_hash(text)
    )
    assert (AC.MAGIC, AC.CACHE_FORMAT_VERSION, AC._HEADER_LEN.format) == (
        JAC.MAGIC, JAC.CACHE_FORMAT_VERSION, JAC._HEADER_LEN.format
    )


@pytest.mark.parametrize("mod", [AC, JAC], ids=["port", "jax"])
def test_cache_key_is_stable_and_input_sensitive(mod):
    """The JAX test's shape, on both modules: every key ingredient matters."""
    fp = {"torch": "0.0.0", "cuda": None, "platform": "cpu"}
    k1 = mod.cache_key("p", (1, 2), fp, mod.content_hash("module {}"))
    assert k1 == mod.cache_key("p", (1, 2), fp, mod.content_hash("module {}")) and len(k1) == 64
    assert k1 != mod.cache_key("q", (1, 2), fp, mod.content_hash("module {}"))
    assert k1 != mod.cache_key("p", (1, 4), fp, mod.content_hash("module {}"))
    assert k1 != mod.cache_key("p", (1, 2), fp, mod.content_hash("module {x}"))
    assert k1 != mod.cache_key("p", (1, 2), {**fp, "torch": "9.9.9"}, mod.content_hash("module {}"))


def test_program_text_is_deterministic_and_covers_tables_and_libraries():
    from shallowspeed_tpu_torch import schedules as S
    from shallowspeed_tpu_torch.parallel.lowering import lower_schedule

    a = lower_schedule(S.SCHEDULES["gpipe"], 4, 2)
    b = lower_schedule(S.SCHEDULES["gpipe"], 4, 2)
    c = lower_schedule(S.SCHEDULES["pipedream"], 4, 2)
    text = AC.program_text("epoch_program", "xla", a, ["linear_act_fwd-00"])
    assert text == AC.program_text("epoch_program", "xla", b, ["linear_act_fwd-00"])
    assert text != AC.program_text("epoch_program", "xla", c, ["linear_act_fwd-00"])
    assert text != AC.program_text("epoch_program", "pallas", a, ["linear_act_fwd-00"])
    assert text != AC.program_text("epoch_program", "xla", a, ["linear_act_fwd-01"])
    assert text != AC.program_text("chunk_program_2", "xla", a, ["linear_act_fwd-00"])
    assert AC.program_text("p", "xla", (a, None), []) != AC.program_text("p", "xla", (a, c), [])


def test_fingerprint_off_the_card():
    fp = AC.backend_fingerprint("cpu")
    assert fp["platform"] == "cpu" and fp["format"] == AC.CACHE_FORMAT_VERSION
    assert fp["device_name"] is None and fp["capability"] is None
    assert set(fp) == {"torch", "cuda", "format", "platform", "device_name", "capability", "nvcc"}


# ---------------------------------------------------------------------------
# the store itself
# ---------------------------------------------------------------------------


def _stored(tmp_path, payload=None):
    cache = AC.AotCache(tmp_path / "aot", device="cpu")
    key = cache.key_for("p", (1,), "program text")
    path = cache.store(key, {"tables": [1, 2], "verdict": None, "libraries": {}} if payload is None else payload,
                       program="p")
    return cache, key, path


def test_store_load_roundtrip(tmp_path):
    cache, key, path = _stored(tmp_path)
    assert path == cache.entry_path(key) and path.name == f"{key}.aotx" and path.exists()
    assert cache.load(key, program="p") == {"tables": [1, 2], "verdict": None, "libraries": {}}
    assert (cache.counts["store"], cache.counts["hit"]) == (1, 1)
    stats = cache.stats()
    assert stats["lookups"] == 1 and stats["hit_rate"] == 1.0 and stats["disabled_reason"] is None
    assert not list(path.parent.glob("*.tmp"))  # the atomic write left no temp


def _corrupt(path):
    faults.corrupt_checkpoint_bytes(path, seed=1)


def _torn(path):
    path.write_bytes(path.read_bytes()[:16])


def _bad_magic(path):
    raw = path.read_bytes()
    path.write_bytes(b"NOTAOT\n" + raw[len(AC.MAGIC):])


def _unpicklable_blob(path):
    """A well-formed entry whose (checksummed) payload does not unpickle."""
    raw = path.read_bytes()
    off = len(AC.MAGIC)
    (hlen,) = AC._HEADER_LEN.unpack(raw[off: off + AC._HEADER_LEN.size])
    header = json.loads(raw[off + AC._HEADER_LEN.size: off + AC._HEADER_LEN.size + hlen])
    blob = b"\x80\x04not a pickle"
    header["sha256"] = hashlib.sha256(blob).hexdigest()
    h = json.dumps(header).encode()
    path.write_bytes(AC.MAGIC + AC._HEADER_LEN.pack(len(h)) + h + blob)


@pytest.mark.parametrize(
    "damage, outcome",
    [(_corrupt, "corrupt"), (_torn, "corrupt"), (_bad_magic, "corrupt"),
     (_unpicklable_blob, "corrupt"), (None, "stale"), ("missing", "miss")],
    ids=["corrupt-bytes", "torn", "bad-magic", "unpickle", "stale", "miss"],
)
def test_load_failure_modes_are_recorded_and_never_raise(tmp_path, damage, outcome):
    cache, key, path = _stored(tmp_path)
    reader = AC.AotCache(tmp_path / "aot", device="cpu")
    if damage == "missing":
        path.unlink()
    elif damage is None:
        reader._fingerprint = {**cache.fingerprint(), "torch": "0.0.0-other"}
    else:
        damage(path)
    assert reader.load(key, program="p") is None
    assert reader.counts[outcome] == 1 and reader.counts["hit"] == 0
    # a rewrite heals it
    if damage is not None:
        cache.store(key, {"tables": None}, program="p")
        assert AC.AotCache(tmp_path / "aot", device="cpu").load(key, program="p") == {"tables": None}


def test_unpicklable_payload_disables_the_cache_once(tmp_path):
    m = Recorder()
    cache = AC.AotCache(tmp_path / "aot", metrics=m, device="cpu")
    key = cache.key_for("p", (1,), "t")
    assert cache.supported
    assert cache.store(key, {"fn": lambda: None}, program="p") is None
    assert not cache.supported and "lambda" in cache.disabled_reason
    # a no-op from here on, and recorded once
    assert cache.store(key, {"tables": None}, program="p") is None
    assert cache.load(key, program="p") is None
    assert cache.counts["disabled"] == 1 and cache.counts["miss"] == 0
    assert [r["name"] for r in m.records if r["kind"] == "aot_cache"] == ["disabled"]
    assert not (tmp_path / "aot").exists()


def test_store_failure_records_fallback(tmp_path):
    blocker = tmp_path / "aot"
    blocker.write_text("a file where the cache directory should be")
    cache = AC.AotCache(blocker, device="cpu")
    assert cache.store(cache.key_for("p", (1,), "t"), {"tables": None}, program="p") is None
    assert cache.counts["fallback"] == 1 and cache.counts["store"] == 0


def _same_ops(mod, metrics, root, port_entry):
    """One sequence of store-side outcomes on ``mod``'s ``AotCache``: a
    miss, a bad-magic entry, an entry written by the port's store (a hit
    for the port, stale for the JAX loader, whose fingerprint differs), a
    store failure, an audit mismatch and its fallback."""
    cache = mod.AotCache(root / "aot", metrics=metrics)
    if mod is AC:
        cache._device = "cpu"
    key = port_entry[0]
    cache.load("0" * 64, program="inference_r1")
    (root / "aot" / ("1" * 64 + ".aotx")).write_bytes(b"garbage")
    cache.load("1" * 64, program="inference_r1")
    cache.load(key, program="predict_seq")
    cache.record("audit_mismatch", program="predict_seq", key=key, reason="census")
    cache.record("fallback", program="predict_seq", key=key, reason="audit_mismatch")
    return cache


def test_records_have_the_jax_modules_names_and_fields(tmp_path):
    """The same outcomes through both modules' ``AotCache`` into each
    package's JSONL sink: the same record names with the same fields (the
    JAX loader reads the port's entry format, and reads the port's
    fingerprint as stale)."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    writer = AC.AotCache(port_root / "aot", device="cpu")
    key = writer.key_for("predict_seq", (1,), "t")
    writer.store(key, {"tables": None, "verdict": None, "libraries": {}}, program="predict_seq")
    (jax_root / "aot").mkdir(parents=True)
    (jax_root / "aot" / f"{key}.aotx").write_bytes(writer.entry_path(key).read_bytes())
    with JsonlMetrics(port_root / "m.jsonl") as m:
        _same_ops(AC, m, port_root, (key,))
    with JaxJsonl(jax_root / "m.jsonl") as m:
        jcache = _same_ops(JAC, m, jax_root, (key,))
    port = [r for r in read_jsonl(port_root / "m.jsonl") if r["kind"] == "aot_cache"]
    jax = [r for r in jax_read_jsonl(jax_root / "m.jsonl") if r["kind"] == "aot_cache"]
    assert [r["name"] for r in port] == ["miss", "corrupt", "hit", "audit_mismatch", "fallback"]
    assert [r["name"] for r in jax] == ["miss", "corrupt", "stale", "audit_mismatch", "fallback"]
    assert jcache.counts["stale"] == 1
    for p, j in zip(port, jax):
        assert p["v"] == SCHEMA_VERSION and p["v"] >= SCHEMA_KINDS["aot_cache"] == 8
        fields = set(p) - {"ts", "wall_s"}
        if p["name"] == j["name"]:
            assert fields == set(j) - {"ts", "wall_s"}
            assert {k: p[k] for k in fields - {"v"}} == {k: j[k] for k in fields - {"v"}}
    assert set(port[2]) - {"ts"} == {"v", "kind", "name", "program", "key", "wall_s"}


# ---------------------------------------------------------------------------
# the session: cold, warm, corrupt
# ---------------------------------------------------------------------------


class _Order:
    """Counts the dispatches of every inference program the session builds
    (the mesh's rung steps through ``executor.make_pipeline_step``, the
    sequential slot program through the session's ``_predict``) and, at
    each ``xla_audit`` record, how many had run."""

    def __init__(self, monkeypatch):
        self.calls = 0
        self.at_audit = []
        real = E.make_pipeline_step

        def make_step(*a, **kw):
            step = real(*a, **kw)

            def counted(*args):
                self.calls += 1
                return step(*args)

            return counted

        monkeypatch.setattr(E, "make_pipeline_step", make_step)

    def wrap_predict(self, session):
        real = session._predict

        def counted(*args):
            self.calls += 1
            return real(*args)

        session._predict = counted

    def metrics(self):
        order = self

        class Ordered(Recorder):
            def audit(self, name, **fields):
                order.at_audit.append((name, order.calls, fields.get("census_ok")))
                super().audit(name, **fields)

        return Ordered()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_warm_start_serves_ladder_bitwise_with_zero_misses(data_dir, tmp_path, monkeypatch, layout):
    """The cold session resolves, audits and stores each program it
    serves; a second session over the same directory serves the same rows
    bitwise with only hits, no miss and no store, and each program's
    ``xla_audit`` record lands after its probe and before its first real
    dispatch."""
    kw = LAYOUTS[layout]
    cache = tmp_path / "aot"
    cold = _session(data_dir, cache, **kw)
    p_cold = cold.predict(ROWS)
    p_cold_big = cold.predict(np.tile(ROWS, (3, 1)))
    assert cold._aot.counts["miss"] == cold._aot.counts["store"] >= 1
    stored = cold._aot.counts["store"]

    order = _Order(monkeypatch)
    m = order.metrics()
    warm = _session(data_dir, cache, metrics=m, **kw)
    if warm.sequential:
        order.wrap_predict(warm)
    p_warm = warm.predict(ROWS)
    p_warm_big = warm.predict(np.tile(ROWS, (3, 1)))
    np.testing.assert_array_equal(p_cold, p_warm)
    np.testing.assert_array_equal(p_cold_big, p_warm_big)
    c = warm._aot.counts
    assert (c["hit"], c["miss"], c["store"], c["corrupt"], c["fallback"]) == (stored, 0, 0, 0, 0)
    # one record a program, each census-clean; the first lands after its
    # probe and before any real dispatch, and each later one after its own
    # probe: one more call than every dispatch before it
    inference = [a for a in order.at_audit if a[0] == "inference_program"]
    assert len(inference) == stored and all(ok for _, _, ok in inference)
    assert inference[0][1] == 1
    assert all(b[1] > a[1] for a, b in zip(inference, inference[1:]))
    assert [r["name"] for r in m.records if r["kind"] == "aot_cache"] == ["hit"] * stored


@pytest.mark.parametrize("damage", [_corrupt, _torn], ids=["corrupt-bytes", "torn"])
def test_corrupt_entry_falls_back_and_rewrites(data_dir, tmp_path, damage):
    """A damaged entry costs a recorded ``corrupt``, a build from source and
    a rewrite — never a crash, never served — with bitwise the same
    answers; the rewritten entry serves the next session from the cache."""
    cache = tmp_path / "aot"
    cold = _session(data_dir, cache, dp=2)
    p0 = cold.predict(ROWS)
    loss0 = cold.train_epoch()
    (entry,) = [p for p in cache.glob("*.aotx") if p.stat().st_size == min(
        q.stat().st_size for q in cache.glob("*.aotx"))][:1]
    damage(entry)
    s = _session(data_dir, cache, dp=2)
    p1 = s.predict(ROWS)
    loss1 = s.train_epoch()
    assert s._aot.counts["corrupt"] == 1 and s._aot.counts["store"] == 1
    assert s._aot.counts["hit"] == cold._aot.counts["store"] - 1
    np.testing.assert_array_equal(p0, p1)
    assert loss0 == loss1 and cold.model_hash() == s.model_hash()
    healed = _session(data_dir, cache, dp=2)
    healed.predict(ROWS)
    healed.train_epoch()
    assert healed._aot.counts["miss"] == healed._aot.counts["store"] == 0
    assert healed._aot.counts["corrupt"] == 0 and healed.model_hash() == s.model_hash()


def test_hit_with_a_broken_census_is_lowered_again_and_rewritten(data_dir, tmp_path, monkeypatch):
    """A hit whose probe census breaks the contract is recorded
    ``audit_mismatch`` then ``fallback``, lowered again, probed under the
    session's rules and its entry rewritten; the state and the answers are
    bitwise the cold twin's."""
    cache = tmp_path / "aot"
    cold = _session(data_dir, cache, dp=2, pp=2)
    loss0 = cold.train_epoch()
    real = A.audit_program
    broken = {"left": 1}

    def once_broken(*a, **kw):
        rec = real(*a, **kw)
        if broken["left"]:
            broken["left"] -= 1
            rec = dict(rec, census_ok=False, mismatches=["forced by the test"])
        return rec

    monkeypatch.setattr(A, "audit_program", once_broken)
    m = Recorder()
    warm = _session(data_dir, cache, dp=2, pp=2, metrics=m)
    relowered = []
    real_lower = warm._lower_train_prog
    warm._lower_train_prog = lambda: relowered.append(1) or real_lower()
    loss1 = warm.train_epoch()
    names = [r["name"] for r in m.records if r["kind"] == "aot_cache"]
    assert names == ["hit", "audit_mismatch", "fallback", "store"]
    assert relowered == [1] and loss0 == loss1 and cold.model_hash() == warm.model_hash()
    audits = [r for r in m.records if r["kind"] == "xla_audit"]
    assert [(r["name"], r["census_ok"]) for r in audits] == [("epoch_program", True)]


def test_fresh_program_breaking_its_contract_still_raises_under_audit(data_dir, tmp_path, monkeypatch):
    """With a cache and ``audit=True`` a freshly built program that breaks
    its contract raises ``AuditMismatchError`` before it dispatches, with
    the state as it was and nothing stored."""
    monkeypatch.setattr(E, "dp_sum", lambda parts, *a, **kw: parts)
    s = _session(data_dir, tmp_path / "aot", dp=2, audit=True)
    before = s.model_hash()
    with pytest.raises(A.AuditMismatchError):
        s.train_epoch()
    assert s.model_hash() == before and s.epoch == 0
    assert s._aot.counts["store"] == 0 and not list((tmp_path / "aot").glob("*.aotx"))


TRAIN_LAYOUTS = {
    "seq": {},
    "seq-fused": dict(fuse_mubatches=True, optimizer="momentum"),
    "dp2pp2": dict(dp=2, pp=2),
    "pp2-pallas": dict(pp=2, kernel_backend="pallas"),
    "mpmd-pp2": dict(pp=2, runtime="mpmd"),
}


@pytest.mark.parametrize("layout", list(TRAIN_LAYOUTS))
def test_epoch_and_stage_programs_ride_the_cache(data_dir, tmp_path, layout):
    """The epoch program (and a chunk program), and under mpmd every stage
    program through the runners' ``warm``, store cold and load warm: the
    warm twin trains bitwise the cold one with only hits."""
    kw = TRAIN_LAYOUTS[layout]
    cache = tmp_path / "aot"
    runs = []
    for _ in range(2):
        s = _session(data_dir, cache, **kw)
        s.train_steps(1)
        s.train_steps(s.batches_per_epoch)
        loss = s.train_epoch()
        runs.append((s, loss, s.predict(ROWS)))
    (cold, l0, p0), (warm, l1, p1) = runs
    assert cold._aot.counts["store"] == cold._aot.counts["miss"] >= 3
    assert warm._aot.counts["hit"] == cold._aot.counts["store"]
    assert warm._aot.counts["miss"] == warm._aot.counts["store"] == 0
    assert l0 == l1 and cold.model_hash() == warm.model_hash()
    np.testing.assert_array_equal(p0, p1)
    if layout.startswith("mpmd"):
        assert cold._aot.counts["store"] > 4  # every planned stage program


def test_jax_session_and_the_port_agree_on_a_cached_epoch(data_dir, tmp_path):
    """The cache changes nothing the JAX session computes: a cache-warm port
    epoch stays within the cross-engine class of the JAX session's."""
    cache = tmp_path / "aot"
    _session(data_dir, cache).train_epoch()
    warm = _session(data_dir, cache)
    loss = warm.train_epoch()
    jax = JaxSession(sizes=SIZES, global_batch_size=GBS, data_dir=data_dir)
    assert abs(loss - float(jax.train_epoch())) <= 2e-4 * abs(loss) + 2e-6
    for a, b in zip(warm.params(), jax.params()):
        for la, lb in zip(a, b):
            np.testing.assert_allclose(la["W"], np.asarray(lb["W"]), rtol=2e-4, atol=2e-6)


# ---------------------------------------------------------------------------
# warm_run
# ---------------------------------------------------------------------------


def _state(s):
    return (s.model_hash(), s.epoch, s.step_in_epoch, s.global_step,
            [np.asarray(v).copy() for v in _opt_leaves(s)])


def _opt_leaves(s):
    import torch

    return [t.detach().cpu().numpy() for t in _flatten(s._opt_state) if isinstance(t, torch.Tensor)]


def _flatten(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _flatten(t)
    else:
        yield tree


WARM_RUN = {
    "seq": dict(optimizer="momentum"),
    "seq-noeval": dict(with_eval=False),
    "dp2pp2-cache": dict(dp=2, pp=2, cache=True),
    "seq-audit": dict(audit=True, cache=True),
}


@pytest.mark.parametrize("case", list(WARM_RUN))
def test_warm_run_leaves_state_and_the_next_run_bitwise(data_dir, tmp_path, case):
    kw = dict(WARM_RUN[case])
    with_eval = kw.pop("with_eval", True)
    cache = tmp_path / "aot" if kw.pop("cache", False) else None
    twin = _session(data_dir, None, **kw)
    s = _session(data_dir, cache, **kw)
    before = _state(s)
    s.warm_run(2, with_eval=with_eval)
    after = _state(s)
    assert before[:4] == after[:4]
    for a, b in zip(before[4], after[4]):
        np.testing.assert_array_equal(a, b)
    if cache is not None:
        assert s._aot.counts["store"] == 1
        assert ("run", (with_eval, 2)) in s._audit_done  # probed before the dispatch
    got = s.train_run(2, with_eval=with_eval)
    want = twin.train_run(2, with_eval=with_eval)
    assert got == want and s.model_hash() == twin.model_hash()
    if cache is not None:
        assert s._aot.counts["store"] == 1 and s._aot.counts["miss"] == 1


@pytest.mark.parametrize(
    "kw, epochs",
    [(dict(), 0), (dict(pp=2, runtime="mpmd"), 1)],
    ids=["epochs", "mpmd"],
)
def test_warm_run_refusals_in_the_jax_words(data_dir, kw, epochs):
    s = _session(data_dir, None, **kw)
    with pytest.raises(ValueError) as port:
        s.warm_run(epochs)
    jkw = dict(kw)
    if jkw.get("runtime") == "mpmd":
        jkw.update(dp=1)
    j = JaxSession(sizes=SIZES, global_batch_size=GBS, data_dir=data_dir, **jkw)
    with pytest.raises(ValueError) as jax:
        j.warm_run(epochs)
    assert str(port.value) == str(jax.value)


# ---------------------------------------------------------------------------
# the library payload and the build count
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (``$CUDA_HOME/bin/nvcc``) that writes a small
    library file to its ``-o`` path, and a private ``BUILD_DIR``."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = \"--version\" ]; then echo 'Cuda compilation tools, release 0.0, V0.0'; exit 0; fi\n"
        "  if [ \"$1\" = \"-o\" ]; then shift; printf 'lib:%s' \"$1\" > \"$1\"; fi\n"
        "  shift\n"
        "done\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.reset_builds()
    yield tmp_path / "build"
    _build.reset_builds()


def test_build_count_and_library_install(fake_nvcc):
    names = ["linear_act_fwd", "linear_act_bwd"]
    logs = _build.build_all(names)
    assert set(logs) == set(names) and _build.BUILDS == dict.fromkeys(names, 1)
    assert set(_build.BUILD_WALL_S) == set(names) and all(v >= 0 for v in _build.BUILD_WALL_S.values())
    assert _build.build_all(names) == {} and _build.BUILDS == dict.fromkeys(names, 1)
    path = _build.library_path("linear_act_fwd")
    data = path.read_bytes()
    path.unlink()
    assert _build.install_library(path.stem, data) and path.read_bytes() == data
    assert not _build.install_library(path.stem, b"other")  # never overwrites
    assert _build.build_all(names) == {} and _build.BUILDS == dict.fromkeys(names, 1)
    assert not list(fake_nvcc.glob("*.tmp"))


def test_warm_start_writes_the_libraries_and_builds_nothing(data_dir, tmp_path, fake_nvcc, monkeypatch):
    """The library payload, driven on the CPU with a stand-in compiler: the
    cold session builds each library its programs launch once and stores
    the bytes; with ``build/`` emptied (a fresh checkout) the warm session
    writes them back from the cache and runs no build at all."""
    monkeypatch.setattr(TrainingSession, "_train_kernels",
                        lambda self, with_eval=False: ("linear_act_fwd", "linear_act_bwd"))
    monkeypatch.setattr(TrainingSession, "_infer_kernels", lambda self: ("linear_act_fwd",))
    cache = tmp_path / "aot"
    cold = _session(data_dir, cache)
    cold.predict(ROWS)
    cold.train_epoch()
    assert _build.BUILDS == {"linear_act_fwd": 1, "linear_act_bwd": 1}
    libs = {p.name: p.read_bytes() for p in fake_nvcc.glob("*.so")}
    assert len(libs) == 2
    for p in fake_nvcc.glob("*.so"):
        p.unlink()
    _build.reset_builds()
    warm = _session(data_dir, cache)
    warm.predict(ROWS)
    warm.train_epoch()
    assert _build.BUILDS == {} and warm._aot.counts["miss"] == 0
    assert {p.name: p.read_bytes() for p in fake_nvcc.glob("*.so")} == libs
    assert warm.model_hash() == cold.model_hash()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(argv, capsys):
    rc = tcli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize(
    "extra",
    [[], pytest.param(["--dp", "2", "--pp", "2"], marks=pytest.mark.slow), ["--fused-run"]],
    ids=["seq", "dp2pp2", "fused-run"],
)
def test_trainer_cli_aot_cache_warm_twin(flagship_dir, tmp_path, capsys, extra):
    """``--aot-cache``: the cold run stores, the warm run loads and stores
    nothing new, and both end on the hash line of a session trained without
    the cache."""
    argv = ["--device", "cpu", "--data-dir", str(flagship_dir), "--epochs", "1", "--no-eval",
            "--global-batch-size", str(GBS), "--mubatches", "2", "--aot-cache", str(tmp_path / "aot")]
    hashes, entries = [], []
    for _ in range(2):
        rc, out = _cli(argv + extra, capsys)
        assert rc == 0, out
        hashes.append(out.splitlines()[-1])
        entries.append(sorted((tmp_path / "aot").glob("*.aotx")))
    kw = dict(dp=2, pp=2) if "--dp" in extra else {}
    twin = TrainingSession(data_dir=flagship_dir, global_batch_size=GBS, mubatches=2,
                           device="cpu", **kw)
    if "--fused-run" in extra:
        twin.train_run(1, with_eval=False)
    else:
        twin.train_epoch()
    assert hashes == [f"final model hash: {twin.model_hash()}"] * 2
    assert entries[0] and entries[0] == entries[1]


def test_trainer_cli_warms_the_fused_run_before_a_profile(flagship_dir, tmp_path, capsys, monkeypatch):
    """``--fused-run --profile-dir``: ``warm_run`` runs before the profiled
    ``train_run``, as the root CLI's does."""
    calls = []
    real_warm, real_run = TrainingSession.warm_run, TrainingSession.train_run
    monkeypatch.setattr(TrainingSession, "warm_run",
                        lambda self, *a, **kw: calls.append(("warm", a, kw)) or real_warm(self, *a, **kw))
    monkeypatch.setattr(TrainingSession, "train_run",
                        lambda self, *a, **kw: calls.append(("run", a, kw)) or real_run(self, *a, **kw))
    rc, out = _cli(["--device", "cpu", "--data-dir", str(flagship_dir), "--epochs", "1",
                    "--global-batch-size", str(GBS), "--mubatches", "2", "--fused-run",
                    "--no-eval", "--profile-dir", str(tmp_path / "prof"),
                    "--aot-cache", str(tmp_path / "aot")], capsys)
    assert rc == 0, out
    assert calls == [("warm", (1,), {"with_eval": False}), ("run", (1,), {"with_eval": False})]


def test_aot_cache_is_on_the_cli_like_the_root_cli():
    from shallowspeed_tpu_torch.train import build_parser

    ns = build_parser().parse_args(["--aot-cache", "d"])
    assert ns.aot_cache == "d"
    root = Path(__file__).resolve().parent.parent / "train.py"
    assert '"--aot-cache"' in root.read_text()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_recorded_mesh_session_with_a_cache_keeps_its_records(data_dir, tmp_path, warm):
    """A recorded mesh session with a cache writes what an uncached one does
    (the ``pipeline_program`` event, one ``static_analysis`` and one
    ``xla_audit`` record of its epoch program, from the build or from the
    entry) beside its ``aot_cache`` records."""
    cache = tmp_path / "aot"
    if warm:
        _session(data_dir, cache, dp=2, pp=2).train_epoch()
    m = Recorder()
    s = _session(data_dir, cache, dp=2, pp=2, metrics=m)
    s.train_epoch()
    kinds = [(r["kind"], r.get("name")) for r in m.records]
    assert ("event", "pipeline_program") in kinds
    assert kinds.count(("static_analysis", "epoch_program")) == 1
    assert kinds.count(("xla_audit", "epoch_program")) == 1
    want = ["hit"] if warm else ["miss", "store"]
    assert [r["name"] for r in m.records if r["kind"] == "aot_cache"] == want
