#!/usr/bin/env python3
"""Where the port's training time goes on the GPU: a torch.profiler trace of
one steady-state epoch of the flagship recipe, for each training path.

    python3 scripts/torch_training_profile.py

Writes the seeded synthetic split of ``chip_smoke.py``'s phase 6
(``chip_smoke.TRAIN_BATCHES`` batches of 128 rows) into a temporary
directory. For each path it builds ``TrainingSession(device="cuda",
data_dir=...)`` for the flagship (B=128, M=4, SGD at lr 0.006): ``scanned``
the 4-microbatch loop, ``fused`` ``fuse_mubatches=True`` (both through the
B1/B3 kernels and torch ops), ``megakernel`` the fused train kernel once per
batch, ``epoch_kernel`` once per epoch; then the five pipeline executor
configs with ``kernel_backend="pallas"`` (every slot through the flag
kernels, B5-B8): ``dp4-naive``, ``pp4-naive``, ``pp4-gpipe``,
``dp2pp4-gpipe`` and ``pp4-pipedream``. It trains one epoch to warm up,
times one unprofiled epoch (samples/s, host clock around ``train_epoch``,
which returns after the device), then traces one more epoch with CPU and
CUDA activity and reports over that epoch's window: the wall time, the
device's busy time (the union of every GPU activity interval) and idle
share, and the GPU time by kernel name per training step. The profiler adds
host overhead, so the traced epoch's wall is longer than the unprofiled
one; the device times are the GPU's own.

Then the fused train kernel's floor: the device ms per step of one
epoch-mode launch (16 batches of 128 rows, CUDA graph, CUDA events) for the
flagship and for a model of the flagship's depth whose every width is 16
(784 in, so the same input, then 16 wide: ``FLOOR_SIZES``). The narrow
model does almost no arithmetic but crosses the same barriers and phases a
batch, so its time is the kernel's cost of phases and barriers. And the
split of a step: the kernel built a second time with
``FUSED_TRAIN_PHASE_STAMPS`` (a library beside the main path's, which never
has the macro), whose block 0 stamps the device clock at each pass boundary
of every batch of one epoch-mode launch: the group pass (block 0's cluster,
from the batch's start to its arrival at the first grid barrier), the wait
at that barrier (the other clusters' lag and the barrier), the
weight-gradient pass and update, and the wait at the last barrier; and
block 0's group pass phase by phase (each forward layer, the head, each dX
layer: its work, then the cluster barrier after it); the median of each over
the batches after the first.

Prints a readable table per path and, as its last line, one JSON object
with every path. Needs a CUDA device; exits non-zero without one.
"""

import collections
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

EPOCH = "training_epoch"  # the record_function label around the traced epoch
FLOOR_SIZES = (784, 16, 16, 16, 16, 16, 16, 10)  # the flagship's depth, 16 wide
PATHS = {
    "scanned": {},
    "fused": dict(fuse_mubatches=True),
    "megakernel": dict(fuse_mubatches=True, megakernel=True),
    "epoch_kernel": dict(fuse_mubatches=True, epoch_kernel=True),
    "dp4-naive": dict(dp=4, pp=1, schedule="naive", kernel_backend="pallas"),
    "pp4-naive": dict(dp=1, pp=4, schedule="naive", kernel_backend="pallas"),
    "pp4-gpipe": dict(dp=1, pp=4, schedule="gpipe", kernel_backend="pallas"),
    "dp2pp4-gpipe": dict(dp=2, pp=4, schedule="gpipe", kernel_backend="pallas"),
    "pp4-pipedream": dict(dp=1, pp=4, schedule="pipedream", kernel_backend="pallas"),
}


def profile_path(torch, session, steps):
    """One warm-up epoch, one timed, one traced; returns the path's record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from shallowspeed_tpu_torch import cuda_ops
    from torch_serving_profile import _union_us

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
        raise RuntimeError("the trace holds no GPU activity")
    busy_us = _union_us([(s, e) for _, s, e in gpu])
    window_us = window[1] - window[0]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in gpu:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "steps": steps,
        "epoch_ms": epoch_s * 1e3,
        "samples_per_s": steps * 128 / epoch_s,
        "traced_epoch_ms": traced_s * 1e3,
        "window_ms": window_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / window_us,
        "gpu_ops_per_step": len(gpu) / steps,
        "launches": launches,
        "gpu_us_per_step_by_name": {n[:100]: v[1] / steps for n, v in top},
        "gpu_count_by_name": {n[:100]: v[0] for n, v in top},
    }


def fused_kernel_ms(torch, sizes, X, Y):
    """Device ms per step of the fused train kernel in epoch mode over the
    batches of X (nb, 128, in) for an SGD-trained MLP of ``sizes``."""
    from chip_smoke import MUBATCH_ROWS, device_ms

    from shallowspeed_tpu_torch import convert, cuda_ops
    from shallowspeed_tpu_torch import model as model_mod

    spec = model_mod.make_model_spec(sizes, 1, 128)
    stage = model_mod.param_tree(convert.params_from_numpy(model_mod.init_model(spec), "cuda"))[0]
    kw = dict(
        epoch_mode=True, relu_flags=spec.stages[0].relu_flags, group_rows=MUBATCH_ROWS,
        batch_size=128, lr=0.006, weight_decay=0.0,
    )
    ms = device_ms(torch, lambda: cuda_ops.fused_train_call(stage, X, Y, **kw), reps=2, iters=7)
    return ms / X.shape[0]


STAMPS_MACRO = "FUSED_TRAIN_PHASE_STAMPS"
STAMP_SPANS = ("group_pass", "first_barrier", "weight_pass", "last_barrier")


def _stamps_per_batch():
    from shallowspeed_tpu_torch import cuda_ops

    return 5 + 4 * cuda_ops.FUSED_MAX_LAYERS  # fused_train.cu's STAMPS


def fused_kernel_split(torch, sizes, X, Y):
    """Median device µs per batch of each span of ``STAMP_SPANS`` over one
    epoch-mode launch of the stamped build (the batches after the first),
    for an SGD-trained MLP of ``sizes``."""
    from chip_smoke import MUBATCH_ROWS

    from shallowspeed_tpu_torch import _build, convert, cuda_ops
    from shallowspeed_tpu_torch import model as model_mod

    lib = _build.load("fused_train", defines=(STAMPS_MACRO,))
    stamped = cuda_ops._bind(lib, "fused_train")
    read = lib.fused_train_stamps
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    spec = model_mod.make_model_spec(sizes, 1, 128)
    stage = model_mod.param_tree(convert.params_from_numpy(model_mod.init_model(spec), "cuda"))[0]
    kw = dict(
        epoch_mode=True, relu_flags=spec.stages[0].relu_flags, group_rows=MUBATCH_ROWS,
        batch_size=128, lr=0.006, weight_decay=0.0,
    )
    plain_fn = cuda_ops._fn
    cuda_ops._fn = lambda name: stamped if name == "fused_train" else plain_fn(name)
    try:
        for _ in range(3):
            cuda_ops.fused_train_call(stage, X, Y, **kw)
        torch.cuda.synchronize()
    finally:
        cuda_ops._fn = plain_fn
    nb, per = X.shape[0], _stamps_per_batch()
    buf = (ctypes.c_ulonglong * (per * nb))()
    if read(buf, per * nb) != 0:
        raise RuntimeError("fused_train_stamps failed")
    L = len(sizes) - 1
    phases = [f"forward {l}" for l in range(L)] + ["head"] + [f"dX {l}" for l in range(L - 1, 0, -1)]
    spans = {name: [] for name in STAMP_SPANS}
    work = {name: [] for name in phases}
    wait = {name: [] for name in phases[:-1]}
    for b in range(1, nb):
        t = buf[per * b : per * (b + 1)]
        for i, name in enumerate(STAMP_SPANS):
            spans[name].append((t[i + 1] - t[i]) / 1e3)
        for i, name in enumerate(phases):
            work[name].append((t[6 + 2 * i] - t[5 + 2 * i]) / 1e3)
            if name in wait:
                wait[name].append((t[7 + 2 * i] - t[6 + 2 * i]) / 1e3)
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    out = {name: med(v) for name, v in spans.items()}
    out["batch"] = sum(out.values())
    out["phases"] = {name: [med(work[name]), med(wait[name]) if name in wait else None]
                     for name in phases}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_training_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import TRAIN_BATCHES, write_split

    from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES, TrainingSession

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_split(Path(tmp), TRAIN_BATCHES * 128, 128)
        for path in PATHS:
            session = TrainingSession(device="cuda", data_dir=tmp, **PATHS[path])
            rec = records[path] = profile_path(torch, session, session.batches_per_epoch)
            print(
                f"{path}: {rec['steps']} steps of 128 rows; unprofiled "
                f"{rec['epoch_ms']:.3f} ms = {rec['samples_per_s']:.1f} samples/s "
                f"({rec['epoch_ms'] / rec['steps']:.4f} ms per step); traced window "
                f"{rec['window_ms']:.3f} ms, device busy {rec['device_busy_ms']:.3f} ms, "
                f"idle share {rec['idle_share']:.4f}, {rec['gpu_ops_per_step']:.1f} GPU "
                f"operations per step; kernel launches {rec['launches']}"
            )
            print("  count  gpu_ms     per_step_us  name")
            for name, us in list(rec["gpu_us_per_step_by_name"].items())[:12]:
                count = rec["gpu_count_by_name"][name]
                print(f"  {count:5d} {us * rec['steps'] / 1e3:9.4f} {us:13.3f}  {name[:90]}")
        X = torch.from_numpy(np.load(Path(tmp) / "x_train.npy")).cuda().reshape(TRAIN_BATCHES, 128, -1)
        Y = torch.from_numpy(np.load(Path(tmp) / "y_train.npy")).cuda().reshape(TRAIN_BATCHES, 128, -1)
        floor = {
            "flagship_ms_per_step": fused_kernel_ms(torch, FLAGSHIP_SIZES, X, Y),
            "narrow_ms_per_step": fused_kernel_ms(torch, FLOOR_SIZES, X, Y),
            "flagship_split_us": fused_kernel_split(torch, FLAGSHIP_SIZES, X, Y),
            "narrow_split_us": fused_kernel_split(torch, FLOOR_SIZES, X, Y),
        }
    print(
        f"fused train kernel, epoch mode, device ms per step: flagship "
        f"{floor['flagship_ms_per_step']:.5f}, the same depth 16 wide "
        f"{floor['narrow_ms_per_step']:.5f} (phases and barriers)"
    )
    for model in ("flagship", "narrow"):
        split = floor[f"{model}_split_us"]
        print(
            f"  {model} batch split, median device µs (stamped build): "
            + ", ".join(f"{name} {split[name]:.3f}" for name in (*STAMP_SPANS, "batch"))
        )
        print(
            f"    block 0's group pass, µs of work (then of cluster barrier): "
            + ", ".join(
                f"{name} {w:.3f}" + ("" if b is None else f" ({b:.3f})")
                for name, (w, b) in split["phases"].items()
            )
        )
    print(json.dumps({"card": card, "paths": records, "fused_kernel": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
