#!/usr/bin/env python3
"""Where the port's training time goes on the GPU: a torch.profiler trace of
one steady-state epoch of the flagship recipe.

    python3 scripts/torch_training_profile.py [--fuse-mubatches]

Writes the seeded synthetic split of ``chip_smoke.py``'s phase 6
(``chip_smoke.TRAIN_BATCHES`` batches of 128 rows) into a temporary
directory, builds ``TrainingSession(device="cuda", data_dir=...)`` for the
flagship (B=128,
M=4, SGD at lr 0.006), trains one epoch to warm up, times one unprofiled
epoch (samples/s, host clock around ``train_epoch``, which returns after
the device), then traces one more epoch with CPU and CUDA activity and
reports over that epoch's window: the wall time, the device's busy time
(the union of every GPU activity interval) and idle share, and the GPU time
by kernel name per training step. The profiler adds host overhead, so the
traced epoch's wall is longer than the unprofiled one; the device times
are the GPU's own.

Prints a readable table and, as its last line, one JSON object. Needs a
CUDA device; exits non-zero without one.
"""

import argparse
import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

EPOCH = "training_epoch"  # the record_function label around the traced epoch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fuse-mubatches", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_training_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import TRAIN_BATCHES, write_split
    from torch_serving_profile import _union_us

    from shallowspeed_tpu_torch import cuda_ops
    from shallowspeed_tpu_torch.api import TrainingSession

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        write_split(Path(tmp), TRAIN_BATCHES * 128, 128)
        session = TrainingSession(
            device="cuda", data_dir=tmp, fuse_mubatches=args.fuse_mubatches
        )
    steps = session.batches_per_epoch
    session.train_epoch()  # warm-up: kernel load, allocator, cuBLAS handles
    t0 = time.perf_counter()
    session.train_epoch()
    epoch_s = time.perf_counter() - t0
    cuda_ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(EPOCH):
            t1 = time.perf_counter()
            session.train_epoch()
            traced_s = time.perf_counter() - t1
    launches = dict(cuda_ops.LAUNCHES)
    span = [
        ev for ev in prof.events()
        if ev.name == EPOCH and ev.device_type == DeviceType.CPU
    ][0]
    window = (span.time_range.start, span.time_range.end)
    gpu = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name == EPOCH:
            continue
        s, e = max(ev.time_range.start, window[0]), min(ev.time_range.end, window[1])
        if e > s:
            gpu.append((ev.name, s, e))
    if not gpu:
        print("torch_training_profile: the trace holds no GPU activity", file=sys.stderr)
        return 1
    busy_us = _union_us([(s, e) for _, s, e in gpu])
    window_us = window[1] - window[0]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in gpu:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    sps = steps * 128 / epoch_s
    print(
        f"training epoch: {steps} steps of 128 rows "
        f"({'fused' if args.fuse_mubatches else '4 microbatches'}); unprofiled "
        f"{epoch_s * 1e3:.3f} ms = {sps:.1f} samples/s ({epoch_s / steps * 1e3:.4f} "
        f"ms per step); traced window {window_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / window_us:.4f}; "
        f"kernel launches {launches}"
    )
    print("  count  gpu_ms     per_step_us  name")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in top[:16]:
        print(f"  {count:5d} {us / 1e3:9.4f} {us / steps:13.3f}  {name[:90]}")
    print(
        json.dumps(
            {
                "card": card,
                "steps": steps,
                "fuse_mubatches": args.fuse_mubatches,
                "epoch_ms": epoch_s * 1e3,
                "samples_per_s": sps,
                "traced_epoch_ms": traced_s * 1e3,
                "window_ms": window_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "idle_share": 1 - busy_us / window_us,
                "launches": launches,
                "gpu_us_per_step_by_name": {
                    n[:100]: v[1] / steps for n, v in top
                },
                "gpu_count_by_name": {n[:100]: v[0] for n, v in top},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
