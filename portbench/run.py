"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the GPUs the cell asks for.
The last line of standard output is the result's JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error and the result's last key. Exits non-zero, printing no result, when
CUDA is not available, when fewer GPUs are present than the cell asks for,
or when a module of JAX or of the JAX package is loaded once the window has
closed.
"""

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from portbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cells.get(args.workload)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(
            f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}",
            file=sys.stderr,
        )
        return 2
    result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"portbench: JAX or the JAX package is loaded: {leaked}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])  # the line stays strict JSON
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
