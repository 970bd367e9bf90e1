"""Nothing a run loads is JAX or the JAX package, by whole top-level name."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import portbench.run  # noqa: F401  (what the command loads first)
from portbench import control, harness
bench = harness.Bench(root)
harness.run(bench, sys.argv[2], 7, 0.2, False, device="cpu")
for name in bench.per_layer_of(sys.argv[2]):
    bench.reader(bench.metric_file(name["name"])["reader"])
import portbench.readers.mfu, portbench.readers.roofline  # noqa: E401,F401
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize(
    "cell", ["mnist-mlp.epoch-kernel", "mlp-deep.seq-b1024", "mlp-deep.pp4-gpipe-b1024"]
)
def test_a_run_loads_no_jax_and_not_the_jax_package(tiny_root, cell):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, str(tiny_root), cell],
        cwd=tiny_root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "shallowspeed_tpu_torch" in tops  # the program ran
    assert not tops & {"jax", "jaxlib", "flax", "shallowspeed_tpu"}, sorted(tops)
