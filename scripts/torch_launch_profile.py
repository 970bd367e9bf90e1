#!/usr/bin/env python3
"""The host's cost of one call of each linear-kernel wrapper on the GPU.

    python3 scripts/torch_launch_profile.py

The port's microbatch, mesh and serving paths are host-bound: Python issues
every GPU operation, and the device idles most of a step. So a wrapper's
host time per call counts as much as its kernel's device time. For each
entry (``linear_act_fwd``/``linear_act_bwd`` and the executor's
``linear_flag_fwd``/``linear_flag_bwd``) at the main path's few-row shapes,
and for ``torch.addmm`` as a yardstick, it calls the function ``CALLS``
times back to back, reading the host clock around the loop with no
synchronize inside it, then synchronizes. One call's device work is
shorter than its host cost there, so the loop runs at the host's pace and
the wall over the count is the host's microseconds per call. Median of
``REPEATS``. Beside it the device's clock over the same loop (CUDA
events): equal to the host's when the host sets the pace, longer when the
device does.

Prints a readable table and, as its last line, one JSON object. Needs a
CUDA device; exits non-zero without one.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CALLS = 2000
REPEATS = 7
# (rows, K, N): a serving slot's first layer, a DP=2 x PP=4 slot 0, a
# microbatch's first layer, a 128-wide layer at 16 rows
SHAPES = ((8, 784, 128), (16, 784, 128), (32, 784, 128), (16, 128, 127))


def per_call(torch, fn):
    """(host us, device us) per call of ``fn``: medians over REPEATS loops
    of CALLS calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(REPEATS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        start = time.perf_counter()
        for _ in range(CALLS):
            fn()
        host.append((time.perf_counter() - start) / CALLS * 1e6)
        t1.record()
        t1.synchronize()
        device.append(t0.elapsed_time(t1) / CALLS * 1e3)
    host.sort()
    device.sort()
    return host[REPEATS // 2], device[REPEATS // 2]


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_launch_profile: no CUDA device", file=sys.stderr)
        return 1
    from shallowspeed_tpu_torch import cuda_ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    gen = torch.Generator().manual_seed(0)
    records = []
    print("  rows     K     N  call               host_us/call  device_clock_us/call")
    for rows, k, n in SHAPES:
        x = torch.randn(rows, k, generator=gen).cuda()
        w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).cuda()
        b = (0.1 * torch.randn(1, n, generator=gen)).cuda()
        g = torch.randn(rows, n, generator=gen).cuda()
        mask = cuda_ops.linear_act_fwd(x, w, b)[1]
        calls = {
            "linear_act_fwd": lambda: cuda_ops.linear_act_fwd(x, w, b),
            "linear_flag_fwd": lambda: cuda_ops.linear_flag_fwd(x, w, b, 1),
            "torch.addmm": lambda: torch.addmm(b, x, w.T),
            "linear_act_bwd": lambda: cuda_ops.linear_act_bwd(g, mask, x, w),
            "linear_flag_bwd": lambda: cuda_ops.linear_flag_bwd(g, mask, x, w, 1),
        }
        for name, fn in calls.items():
            host, device = per_call(torch, fn)
            records.append(dict(rows=rows, K=k, N=n, call=name, host_us=host, device_us=device))
            print(f"  {rows:4d} {k:5d} {n:5d}  {name:17s} {host:13.3f} {device:15.3f}")
    print(json.dumps({"card": card, "calls": CALLS, "repeats": REPEATS, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
