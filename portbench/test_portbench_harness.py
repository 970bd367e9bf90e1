"""The harness: driven by data, within the contract's characters, the check
failing on a broken program, and the command's refusals."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import check, harness

ROOT = Path(harness.__file__).resolve().parent.parent


def _digest(folder):
    return {
        p.relative_to(folder).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def test_the_benchmark_validates_and_keeps_to_the_contracts_characters():
    bench = harness.Bench(ROOT)
    assert bench.validate() == []
    spec = bench.spec
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", n) for n in names), names
    assert len(set(names[: len(spec["configs"])])) == len(spec["configs"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"]), m
    for text in [w["why"] for w in spec["workloads"]] + [m["layer"] for m in spec["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", path.relative_to(ROOT).as_posix())
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}


def test_a_new_cell_and_metric_are_found_by_their_names_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # what a later change adds: a traffic file, a cell file, a metric file
    # and its reader, and their entries in BENCHMARK.json
    traffic = json.loads((tmp_path / "portbench/traffic/seq-b1024.json").read_text())
    traffic["global_batch_size"], traffic["chunk_steps"] = 128, 4
    (tmp_path / "portbench/traffic/seq-b128.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/workloads/mlp-deep.seq-b128.json").write_text(json.dumps(
        {"why": "host issue", "trace_chunks": 5,
         "limits": {"grad": 1e-3, "change": 1e-3}}
    ))
    (tmp_path / "portbench/readers/steps.py").write_text(
        "def read(ctx, spec):\n    return float(ctx['stretch']['steps'])\n"
    )
    (tmp_path / "portbench/metrics/session.steps.json").write_text(json.dumps({"reader": "steps"}))
    spec["workloads"].append({"name": "mlp-deep.seq-b128", "config": "mlp-deep",
                              "traffic": "seq-b128", "chips": 1, "why": "host issue"})
    spec["per_layer"].append({"name": "session.steps", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "Session",
                              "moves": "train_samples_per_s",
                              "workloads": ["mlp-deep.seq-b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(tmp_path)
    assert bench.validate() == []
    assert "mlp-deep.seq-b128" in bench.cells
    cell = bench.cell("mlp-deep.seq-b128")
    assert cell["traffic"]["chunk_steps"] == 4
    assert [m["name"] for m in bench.per_layer_of("mlp-deep.seq-b128")] == ["session.steps"]
    reader = bench.reader(bench.metric_file("session.steps")["reader"])
    assert reader.read({"stretch": {"steps": 7}}, {}) == 7.0
    assert {m["name"] for m in bench.end_to_end_of("mlp-deep.seq-b128")} == {
        "train_samples_per_s", "chunk_ms_p95", "setup_s"
    }
    # nothing that was there changed
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_validate_names_what_is_wrong(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["per_layer"][0]["unit"] = "per cent"
    spec["per_layer"].append(dict(spec["per_layer"][1], name="no.file"))
    spec["workloads"].append(dict(spec["workloads"][0], name="bad name"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bad = harness.Bench(tmp_path).validate()
    assert any("bad unit" in b for b in bad)
    assert any("no.file" in b for b in bad)
    assert any("bad name 'bad name'" in b for b in bad)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["shallowspeed_tpu_torch", "shallowspeed_tpu_torch.api", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax.numpy", "shallowspeed_tpu.api", "flax"]) == [
        "flax", "jax.numpy", "shallowspeed_tpu.api"
    ]


CELLS = ("mnist-mlp.epoch-kernel", "mlp-deep.seq-b1024", "mlp-deep.pp4-gpipe-b1024")


@pytest.mark.parametrize("fault", [None, "half_batch", "stale_state"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_a_broken_program_is_not_correct(tiny_root, cell, fault):
    """The whole run past the look for a card, on the CPU at a small size,
    with the timed path broken underneath: every fault a training cell can
    have makes ``correct`` false, and the sound program passes."""
    bench = harness.Bench(tiny_root)
    result = harness.run(bench, cell, 2**31 + 5, 0.3, False, device="cpu", fault=fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_samples_per_s", "chunk_ms_p95", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_judge_needs_every_limited_number():
    ok = (True, {"grad": {"value": 1e-6, "limit": 1e-3}})
    assert check.judge({"grad": 1e-6}, {"grad": 1e-3}) == ok
    assert check.judge({"grad": float("nan")}, {"grad": 1e-3})[0] is False
    assert check.judge({}, {"grad": 1e-3})[0] is False


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a host without one")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""},
    )
    assert proc.returncode != 0 and proc.stdout == ""
