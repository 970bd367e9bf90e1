#!/usr/bin/env python3
"""Where the port's serving time goes on the GPU: a torch.profiler trace of
the chip_smoke serving drive, plus the plain version's kernels at one slot.

    python3 scripts/torch_serving_profile.py [--requests 200] [--rate 1000]

Drives the flagship exactly as ``chip_smoke.py``'s phase 4 does
(``TrainingSession()`` -> ``ServingEngine`` -> ``run_open_loop`` over
seeded requests of 1-8 rows) inside ``torch.profiler`` with CPU and CUDA
activity, and reports over the drive's window: the wall time, the device's
busy time (the union of every GPU activity interval) and idle share, the
GPU time by kernel name, and the host wall per dispatched slot. Then it
lists the GPU kernels of one call of the plain version
(``cuda_ops.linear_act_fwd_reference``) at each flagship layer's 8-row
shape. The profiler adds host overhead, so the drive's wall here is longer
than an unprofiled run's; the device times are the GPU's own.

Prints a readable table and, as its last line, one JSON object. Needs a
CUDA device; exits non-zero without one.
"""

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


DRIVE = "serving_drive"  # the record_function label around the drive


def _union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gpu_events(prof, window=None):
    """(name, start_us, end_us) of every GPU activity — kernels, memcpys,
    memsets — clipped to ``window``; the drive's own label, which the
    trace also mirrors onto the GPU timeline, is not an activity."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name == DRIVE:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        if window is not None:
            s, e = max(s, window[0]), min(e, window[1])
            if e <= s:
                continue
        out.append((ev.name, s, e))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=1000.0)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 1
    from shallowspeed_tpu_torch import cuda_ops
    from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES, TrainingSession
    from shallowspeed_tpu_torch.serving import loadgen
    from shallowspeed_tpu_torch.serving.engine import ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    session = TrainingSession(device="cuda")
    engine = ServingEngine(session, slo_ms=50.0)
    payloads = loadgen.request_payloads(
        args.requests, session.spec.in_dim, seed=0, rows_choices=tuple(range(1, 9))
    )
    arrivals = loadgen.poisson_arrivals(args.rate, args.requests, seed=0)
    engine.warm_ladder()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(DRIVE):
            t0 = time.perf_counter()
            done = loadgen.run_open_loop(engine, payloads, arrivals)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    if sum(r.verdict == "ok" for r in done) != args.requests:
        print("torch_serving_profile: not every request was served", file=sys.stderr)
        return 1
    drive = [
        ev for ev in prof.events()
        if ev.name == DRIVE and ev.device_type == DeviceType.CPU
    ][0]
    window = (drive.time_range.start, drive.time_range.end)
    gpu = _gpu_events(prof, window)
    if not gpu:
        print("torch_serving_profile: the trace holds no GPU activity", file=sys.stderr)
        return 1
    busy_us = _union_us([(s, e) for _, s, e in gpu])
    window_us = window[1] - window[0]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in gpu:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    rec = engine.stats()
    slots = rec["slots_dispatched"]
    print(
        f"serving drive: {args.requests} requests @ {args.rate:.0f} rps, "
        f"{rec['dispatches']} dispatches, {slots} slots; window "
        f"{window_us / 1e3:.3f} ms (profiled), device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / window_us:.4f}; host wall per slot "
        f"{wall_s / slots * 1e3:.4f} ms"
    )
    print("  count   gpu_ms      per_slot_us  name")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in top[:12]:
        print(f"  {count:5d} {us / 1e3:9.4f} {us / slots:13.3f}  {name[:90]}")

    plain = {}
    gen = torch.Generator().manual_seed(0)
    for k, n in zip(FLAGSHIP_SIZES[:-2], FLAGSHIP_SIZES[1:-1]):
        x = torch.randn(8, k, generator=gen).cuda()
        w = torch.randn(n, k, generator=gen).cuda()
        b = torch.randn(n, generator=gen).cuda()
        for _ in range(3):
            cuda_ops.linear_act_fwd_reference(x, w, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p1:
            cuda_ops.linear_act_fwd_reference(x, w, b)
            torch.cuda.synchronize()
        kernels = [(name, e - s) for name, s, e in _gpu_events(p1)]
        plain[f"8x{k}->{n}"] = [(name[:100], us) for name, us in kernels]
        print(
            f"plain 8x{k}->{n}: "
            + "; ".join(f"{name[:60]} {us:.2f} us" for name, us in kernels)
        )
    print(
        json.dumps(
            {
                "card": card,
                "requests": args.requests,
                "rate_rps": args.rate,
                "dispatches": rec["dispatches"],
                "slots": slots,
                "window_ms": window_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "idle_share": 1 - busy_us / window_us,
                "host_wall_per_slot_ms": wall_s / slots * 1e3,
                "gpu_ms_by_name": {n[:100]: v[1] / 1e3 for n, v in top},
                "plain_kernels_us": plain,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
