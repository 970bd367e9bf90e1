"""What the benchmark's limits and bounds were set from; not run by the
benchmark's own runs.

    python3 -m portbench.control readings --workload <cell> --seeds 1,2,3 [--faults]

in one process, for each seed: the numbers of ``check.py`` for the sound
program (the lower readings of each limit), for the control (the reference
computed with TF32 products, put in the program's place: the upper
readings) and, with ``--faults``, for the program with half of each batch
left out (``harness.plant``). One JSON line a seed and kind.

    python3 -m portbench.control sets --workload <cell> --seeds 1,2,3 --seconds 20 [--trace 1]

runs ``python3 -m portbench.run`` once a seed, one after another, keeps each
result's line and prints, for each metric, the median and the spread (the
distance between the first and the third quartile over the median, as
``statistics.quantiles`` gives them). ``--out`` appends the lines to a file.
"""

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from portbench import harness


def readings(bench, name, seeds, faults, device="cuda", out=sys.stdout):
    """Print the sound, control and (with ``faults``) half-batch numbers of
    each seed."""
    for seed in seeds:
        tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
        try:
            t0 = time.perf_counter()
            cell, session, prog, _, _ = harness.prepare(bench, name, seed, device, tmp)
            del session
            harness.free(device)
            p0, ref = harness.reference_readings(cell, seed, tmp, device)
            _, ctl = harness.reference_readings(cell, seed, tmp, device, tf32=True)
            rows = [
                ("sound", harness.numbers_of(cell, p0, prog, ref, device)),
                ("control_tf32", harness.numbers_of(cell, p0, ctl, ref, device)),
            ]
            if faults:
                shutil.rmtree(tmp)
                tmp.mkdir()
                _, session, bad, _, _ = harness.prepare(
                    bench, name, seed, device, tmp, fault="half_batch"
                )
                del session
                harness.free(device)
                rows.append(("half_batch", harness.numbers_of(cell, p0, bad, ref, device)))
            for kind, numbers in rows:
                line = {"workload": name, "seed": seed, "kind": kind, "numbers": numbers,
                        "seconds": time.perf_counter() - t0}
                out.write(json.dumps(line) + "\n")
                out.flush()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            harness.free(device)


def spread(values):
    """``(median, (q3 - q1) / median)`` with ``statistics.quantiles``."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("inf")


def sets(name, seeds, seconds, trace_on, out_path=None):
    """Run the cell once a seed in fresh processes; return the result lines
    and print the spread of each metric."""
    results = []
    for seed in seeds:
        cmd = [sys.executable, "-m", "portbench.run", "--workload", name, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", str(int(trace_on))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=harness.ROOT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        rec = {"workload": name, "seed": seed, "trace": int(trace_on), "rc": proc.returncode,
               "wall_s": wall, "stderr_tail": proc.stderr[-1500:]}
        if proc.returncode == 0 and lines:
            rec["result"] = json.loads(lines[-1])
        results.append(rec)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        got = rec.get("result", {})
        print(f"{name} seed {seed} rc {proc.returncode} wall {wall:.1f} s correct "
              f"{got.get('correct')} {json.dumps(got.get('metrics', {}))}", flush=True)
    good = [r["result"] for r in results if "result" in r]
    for metric in sorted({m for r in good for m in r["metrics"]}):
        vals = [r["metrics"][metric]["value"] for r in good if metric in r["metrics"]]
        med, spr = spread(vals)
        print(f"{name} {metric}: n {len(vals)} median {med!r} spread {spr!r}", flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("mode", choices=("readings", "sets"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.mode == "readings":
        bench = harness.Bench()
        if args.out:
            with open(args.out, "a") as f:
                readings(bench, args.workload, seeds, args.faults, out=f)
        else:
            readings(bench, args.workload, seeds, args.faults)
    else:
        sets(args.workload, seeds, args.seconds, args.trace, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
