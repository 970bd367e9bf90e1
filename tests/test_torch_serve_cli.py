"""The port's serve CLI against the JAX package's: the mesh, tp and
schedule layouts with ``--verify`` (the same exit codes and layout lines),
the fleet mode on CPU replica workers, the flag the port refuses with
exit 2 and a ROADMAP pointer, and a JAX serve command line parsing to the
same values.
"""

import argparse
import contextlib
import io

import numpy as np
import pytest

from shallowspeed_tpu.serving import __main__ as jcli
from shallowspeed_tpu_torch.serving import __main__ as tcli


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The JAX CLI's session loads a training split (784 wide, the
    flagship's); the port's serves without one but reads it when given."""
    path = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for suffix, n in (("train", 128), ("val", 32)):
        np.save(path / f"x_{suffix}.npy", rng.randn(n, 784).astype(np.float32))
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])
    return path


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


@pytest.mark.parametrize(
    "layout",
    [
        ["--dp", "2", "--pp", "2", "--tp", "2"],
        ["--dp", "2", "--pp", "4", "--schedule", "gpipe"],
        ["--pp", "2", "--schedule", "interleaved", "--virtual-stages", "2"],
    ],
    ids=["dp2-pp2-tp2", "dp2-pp4-gpipe", "pp2-interleaved-v2"],
)
def test_mesh_layouts_verify_like_jax(layout, data_dir):
    """Each layout serves every response bitwise its direct predict() and
    prints the JAX CLI's layout line; both CLIs exit 0."""
    argv = layout + ["--requests", "12", "--rate", "400", "--slo-ms", "2000",
                     "--verify", "--slot-ladder", "1,2", "--data-dir", str(data_dir)]
    jrc, jout, _ = _run(jcli.main, argv)
    trc, tout, terr = _run(tcli.main, ["--device", "cpu"] + argv)
    assert (trc, jrc) == (0, 0), terr
    assert tout[0] == jout[0] and tout[0].startswith("serving: DP=")
    assert "verify: 12/12 responses bitwise-equal to direct predict()" in tout


@pytest.mark.fleet
@pytest.mark.parametrize("policy", ["least_queue", "p2c"])
def test_fleet_verify_on_cpu_workers(policy, data_dir, tmp_path):
    """``serve --fleet 2 --device cpu --verify``: two replica worker
    processes, every response bitwise its serving replica's direct
    predict(), the routing line, the shards beside the parent's stream,
    exit 0."""
    stream = tmp_path / "fleet.jsonl"
    rc, out, err = _run(tcli.main, [
        "--device", "cpu", "--fleet", "2", "--fleet-policy", policy, "--verify",
        "--requests", "16", "--rate", "400", "--slo-ms", "2000", "--slot-ladder", "1,2",
        "--data-dir", str(data_dir), "--metrics-out", str(stream)])
    assert rc == 0, err
    assert out[0] == (
        f"fleet: 2 replicas x (DP=1 x PP=1 x TP=1, gpipe), policy {policy}, 16 requests "
        "@ 400.0 rps Poisson (seed 0)")
    assert out[1].startswith("completed 16/16, dropped 0, expired 0, errors 0, unhealthy 0")
    assert out[2].startswith("routing: r0: ") and "r1: " in out[2]
    assert "verify: 16/16 responses bitwise-equal to the serving replica's direct predict()" in out
    assert stream.exists() and (tmp_path / "fleet.jsonl.r0").exists()


@pytest.mark.parametrize(
    "flag",
    [["--aot-cache", "cache"]],
    ids=lambda f: f[0],
)
def test_refused_flags_exit_2_with_a_roadmap_pointer(flag):
    rc, out, err = _run(tcli.main, ["--device", "cpu", "--requests", "2"] + flag)
    assert rc == 2 and out == []
    assert err.count("\n") == 1 and "ROADMAP.md §A item" in err and flag[0] in err


def test_jax_command_line_parses_to_the_same_values(tmp_path, monkeypatch):
    """A JAX serve command line (every flag but the refused ones) parses
    in the port to the JAX CLI's values."""
    argv = [
        "--dp", "2", "--pp", "4", "--tp", "1", "--schedule", "interleaved",
        "--virtual-stages", "2", "--global-batch-size", "64", "--mubatches", "4",
        "--data-dir", "d", "--checkpoint", "ck.npz", "--requests", "10",
        "--rate", "50", "--seed", "3", "--rows", "1,2", "--slo-ms", "50",
        "--knee-rps", "900", "--deadline-ms", "40", "--closed-loop", "2",
        "--max-slots", "4", "--slot-rows", "8", "--slot-ladder", "1,2,4",
        "--faults", "error@dispatch=4", "--retry-budget", "3", "--breaker", "2",
        "--fleet", "2", "--fleet-policy", "p2c", "--fleet-retry", "3",
        "--fleet-max-queue", "4", "--verify", "--metrics-out", str(tmp_path / "m.jsonl"),
    ]
    seen = []

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.append(vars(real(self, args, namespace)))
        raise Parsed

    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed):
        jcli.main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    jax_ns = seen[0]
    port_ns = vars(tcli.build_parser().parse_args(argv))
    refused = {"aot_cache"}
    assert set(port_ns) - {"device"} == set(jax_ns)
    for dest, value in jax_ns.items():
        if dest not in refused:
            assert port_ns[dest] == value, dest
    assert port_ns["device"] == "cuda"
