#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port's main paths — the
flagship MLP served, and trained, through ``shallowspeed_tpu_torch`` — and
holds every CUDA kernel of those paths against its plain PyTorch version,
in phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the TF32 flags, which must be off;
2. build: every kernel of the path from ``shallowspeed_tpu_torch/csrc/``
   (one nvcc per source, all at once), with the build seconds;
3. kernel vs plain version on the card at the path's shapes — every
   flagship layer and mlp-deep's layers at 8 and 128 rows, and a ragged
   shape with the activation off and on: ``y`` within
   ``rtol=1e-5, atol=1e-5*ceil(K/784)``, ``mask`` equal wherever
   ``|z| > 1e-5``, two launches bitwise equal; then the kernel's time,
   the plain version's, ``torch.addmm``'s (a yardstick the port never
   calls), and the bound max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s fp32),
   beside the launch plan (``cuda_ops.fwd_plan``: row x column tile, K in
   chunks over a cluster, grid); then the row-independence rule: the same
   seeded rows at M = 1, 4, 8, 16, 32, 128 and 1000 (784 -> 128 and 2048
   -> 2048, relu on and off), every row's ``y`` and ``mask`` bitwise the
   same row of the 1000-row launch, failing on the first M that differs;
3b. the backward kernel vs its plain version at the training path's
   shapes — every flagship relu layer and mlp-deep's layers at 32 rows (a
   microbatch) and 128 (fused microbatches), and a ragged shape with the
   activation off and on: dx, dW and db within ``rtol=1e-5,
   atol=1e-5*ceil(L/784)`` for a reduction of length L, a NaN or Inf in
   ``g`` at a masked position poisoning exactly what it poisons in the
   plain version, two launches bitwise equal; then the times as in phase 3
   (the yardstick: ``torch.mm(ge, W)`` + ``torch.mm(ge.T, x)`` +
   ``ge.sum(0)``) and the bound max(bytes / 3.35 TB/s, 4*M*N*K / 67
   TFLOP/s), beside the launch plan (``cuda_ops.bwd_plan``: dx's row x
   column tile, N in chunks over a cluster, dx blocks + dW tiles); then
   the forward kernel, with phase 3's checks, times and plans, at
   the shapes training gives it that phase 3 does not: every flagship relu
   layer at 32 rows and at the 1000-row eval chunk, mlp-deep's at 32 rows;
4. serving (the main path): ``TrainingSession()`` -> ``ServingEngine`` ->
   ``run_open_loop`` over 200 seeded requests of 1-8 rows: 200/200 "ok",
   every response bitwise equal to a direct ``predict()``, the kernel's
   launch count over the drive alone equal to 6 x slots dispatched, and
   the first 64 responses within 1e-6 of the port's CPU plain path;
5. wide model: ``TrainingSession(model="mlp-deep")`` predicting 16 slots
   against the CPU plain path (1e-5), 22 launches per slot;
6. training (the main path): ``TrainingSession(device="cuda",
   data_dir=...)`` on a seeded synthetic split written as ``.npy``,
   flagship at full width, B=128, M=4, SGD at lr 0.006, 2 epochs of 16
   batches with ``accuracy()`` after each: the backward kernel's launches
   over the drive alone exactly 6 x 4 x steps, losses and params within
   ``rtol=2e-4, atol=2e-6`` (the cross-engine class of
   ``tests/test_torch_oracle.py``) of the port's CPU path and accuracies
   within one sample, a second card run bitwise equal. The run moves the
   loss by less than that loss tolerance, so the loss's fall is held to
   the CPU's within 5%, and every param leaf must have moved from init by
   at least 10 times the difference allowed there, so that a card that
   trained wrongly or not at all fails the params check. Then one
   ``fuse_mubatches`` epoch (6 launches per step) and 4 momentum and 4
   Adam steps, each against its CPU run and each moving some leaf 10
   allowed differences; samples/s of the steady (second) epoch;
7. wide training: two mlp-deep steps (22 x 4 launches each) against the
   CPU path, with the same least move;
8a. the fused train kernel (``csrc/fused_train.cu``, TPU kernels B9-B11)
   against its plain version on the card: one flagship step (B=128, head
   groups of 32) for SGD, momentum, Adam, Adam with a binding clip and SGD
   with a weight decay that shrinks every param 1.2% a step, from seeded
   nonzero biases and optimizer state, and for SGD also the 16-batch epoch
   and the 2-epoch run: each param and mirror leaf's change from where it
   started within 1e-3 (a step) or 5e-2 (an epoch, a run) of the plain
   version's largest change in that leaf, plus one float32 rounding, t
   equal, the loss within ``rtol=1e-4``, two launches bitwise equal; then
   one SGD step of two more shapes of the kernel's partition with the same
   checks (a ragged ``(29, 23, 17, 10)`` MLP at 24 rows in groups of 8, the
   flagship as one group of 128 rows); the kernel's time beside its time
   before the redesign (``FUSED_BEFORE_MS``), the plain version's, the
   bound (operations over 67 TFLOP/s fp32 against bytes over 3.35 TB/s),
   and the device time of the fused-microbatch step without the fused
   kernel (the B1/B3 kernels and torch ops);
8b. the kernel paths of the training main path, phase 6's split for 2
   epochs with ``fuse_mubatches=True``: ``megakernel`` (exactly 16 launches
   an epoch), ``epoch_kernel`` (1 an epoch) and ``run_kernel`` with
   ``train_run(2, with_eval=False)`` (1 for the run), none of the B1-B4
   kernels but eval's forwards; each against the CPU path with phase 6's
   checks and a bitwise second card run; the epoch kernel bitwise 16 step
   kernels, the run kernel bitwise 2 epoch kernels, ``train_steps`` in two
   chunks bitwise one epoch; momentum and Adam 4 steps through the epoch
   kernel against the CPU; mlp-deep refused before any launch; samples/s;
9a. the pipeline executor's flag entries (``linear_flag_fwd`` /
   ``linear_flag_bwd``, TPU kernels B5-B8, which launch the two kernels
   above with the relu chosen per call) against their plain versions at
   every slot of every drive of 9b and 9c, derived from the executor's
   stacked layout: each Linear at its slot's padded dims with its own flag
   and zeros beyond its own widths — the flagship's 7 Linears at 8 rows
   (DP=4, unpadded, 123 -> 10 without the relu), 32 rows (PP=4), 16 rows
   (DP=2 x PP=4) and 4 rows (that session's eval and predict slots), and
   mlp-deep's at 32 rows (PP=4) — and a ragged shape with the flag off and
   on: phase 3's and 3b's checks, times and plans. 9b and 9c record the (rows,
   K, N, flag) of every flag launch they make, and the script fails if one
   of them was not checked here;
9b. training through the executor (``TrainingSession(dp, pp, schedule,
   kernel_backend="pallas")``) on phase 6's split for DP=4 naive, PP=4
   naive, PP=4 GPipe, DP=2 x PP=4 GPipe (2 epochs with ``accuracy()``
   after each, phase 6's checks and a bitwise second run) and PP=4
   PipeDream (1 epoch each): each flag entry launches exactly dp x 4
   microbatches x 7 Linears a step (plus eval's forwards), no other kernel;
   params within the cross-engine class of the port's CPU path and within
   ``rtol=3e-4, atol=3e-6`` (the executor's cross-layout class) of the
   card's sequential run; then at DP=2 x PP=4 ``train_steps`` in two
   chunks bitwise one epoch and 4 Adam steps with a binding clip against
   the CPU, and 2 mlp-deep steps at PP=4 (the 2048-wide slots) against the
   CPU with the least move; samples/s per config;
9c. ``predict`` on a DP=2 x PP=4 session (the inference program, flag
   forward launches exact) against the card's sequential ``predict`` and
   the CPU mesh path on the same weights, within 1e-6.

Times come from CUDA events around a CUDA graph of repeated launches, so
they are device times without the host's launch overhead, with the
operands warm in L2 (a slot's weights are re-read by every request).

The last two lines are JSON: the kernels (for each: ``launches`` over its
path's drive — the serving drive of phase 4 for the forward, the training
drive of phase 6 for the backward, phase 8b's drives for the fused train
kernel's three modes; ``ms``/``plain_ms``/``library_ms``/``bound_ms`` summed
over one flagship slot's six relu layers at 8 rows for the forward, one
flagship microbatch's at 32 rows for the backward, and for the fused kernel
one launch of its mode: a step, a 16-batch epoch, a 2-epoch run, with no
library call; the flag entries' ``launches`` over phase 9b's five card
drives and their times summed over one DP=2 x PP=4 microbatch's 7 slots at
16 rows; ``max_abs_err`` over every shape or recipe of phase 3, 3b, 8a or
9a), then ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before either; so does a machine without CUDA, or a directory without the
package.
"""

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
MLP_DEEP_SHAPES = ((784, 2048), (2048, 2048))  # (K, N) of its relu layers
SLOT_ROWS = 8
WIDE_ROWS = 128
MUBATCH_ROWS = 32  # one microbatch of the flagship recipe (128 / 4)
TRAIN_BATCHES = 16  # batches per epoch of the synthetic training split
VAL_ROWS = 1000  # rows of its validation split
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-6  # cross-engine class (tests/test_torch_oracle.py)
MIN_MOVE = 10.0  # least move from init, in allowed card-vs-CPU differences
LOSS_DROP_RTOL = 0.05  # card's loss drop vs the CPU's, relative
STATEFUL_RECIPES = (("momentum", 0.006), ("adam", 2e-4))  # 4-step runs

KERNELS = {
    "linear_act_fwd": dict(
        route="cuda",
        source="shallowspeed_tpu_torch/csrc/linear_act_fwd.cu",
        replaces="shallowspeed_tpu/pallas_ops.py:132",
    ),
    "linear_act_bwd": dict(
        route="cuda",
        source="shallowspeed_tpu_torch/csrc/linear_act_bwd.cu",
        replaces="shallowspeed_tpu/pallas_ops.py:184",
    ),
    "fused_train": dict(
        route="cuda",
        source="shallowspeed_tpu_torch/csrc/fused_train.cu",
        replaces="shallowspeed_tpu/pallas_ops.py:862",
    ),
    # the executor's flag entries launch the two kernels above with the relu
    # chosen per call (TPU kernels B5/B6 and B7/B8)
    "linear_flag_fwd": dict(
        route="cuda",
        source="shallowspeed_tpu_torch/csrc/linear_act_fwd.cu",
        replaces="shallowspeed_tpu/pallas_ops.py:215",
    ),
    "linear_flag_bwd": dict(
        route="cuda",
        source="shallowspeed_tpu_torch/csrc/linear_act_bwd.cu",
        replaces="shallowspeed_tpu/pallas_ops.py:322",
    ),
}
# the fused train kernel's modes: its step, epoch and run (TPU kernels B9-B11)
FUSED_MODES = ("step", "epoch", "run")
RUN_EPOCHS = 2
# The fused train kernel vs its plain version on the card is held on what a
# call changes, since one step moves a param by ~1e-6 of its value: each
# param and mirror leaf's change from where it started within
# FUSED_UPD_RTOL of the plain version's largest change in that leaf, plus
# one float32 rounding at the leaf's largest value (both round p - step).
# The two differ by summation order only (~1e-6 of a gradient). An epoch or
# a run compounds that over 16-32 steps, and a relu that flips on one side
# only moves a few elements by a whole gradient term (~1e-2 of the largest
# change on an H100). The loss within FUSED_LOSS_RTOL, Adam's t equal.
FUSED_UPD_RTOL = {"step": 1e-3, "epoch": 5e-2, "run": 5e-2}
# two more shapes of the kernel's partition, one SGD step each: (label,
# sizes, rows, group_rows) — a ragged MLP with odd widths in three head
# groups of 8 rows (one cluster item of whole groups), and the flagship as
# one group of all 128 rows (one item of four row tiles)
FUSED_SHAPES = (
    ("ragged 29-23-17-10", (29, 23, 17, 10), 24, 8),
    ("flagship one group", FLAGSHIP, 128, 128),
)
# the kernel's device ms before its redesign (commit 291c44b), for
# comparison: measured by this script's phase 8a on an NVIDIA H100 80GB
# HBM3 at 700 W
FUSED_BEFORE_MS = {"step": 0.11489, "epoch": 1.79526, "run": 3.51667}
FUSED_LOSS_RTOL = 1e-4
FLT_EPS = 2.0**-23
FUSED_CASES = (
    ("sgd", dict(optimizer="sgd", lr=0.006)),
    ("momentum", dict(optimizer="momentum", lr=0.006)),
    ("adam", dict(optimizer="adam", lr=2e-4)),
    # the flagship's gradient norm at init is ~0.048 on the split below:
    # a clip of 0.01 binds on every batch
    ("adam+clip", dict(optimizer="adam", lr=2e-4, clip_norm=0.01)),
    # lr * wd = 0.012: a step shrinks every param by 1.2%, far more than
    # the step's own change, so a kernel that skipped the decay fails
    ("sgd+decay", dict(optimizer="sgd", lr=0.006, weight_decay=2.0)),
)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(line):
    print(line, flush=True)


def device_ms(torch, fn, reps=20, iters=15):
    """Median device ms of one ``fn()``: a CUDA graph of ``reps`` calls,
    replayed ``iters`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    times.sort()
    return times[len(times) // 2]


def bound_ms(m, k, n):
    """Least time for one linear_act_fwd: x, W, b read once, y (fp32) and
    mask (1 byte) written once; 2*m*n*k FLOPs on the fp32 pipes."""
    nbytes = 4 * (m * k + n * k + n) + 5 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_bound_ms(m, k, n, relu=True):
    """Least time for one linear_act_bwd: g, x, W (and the 1-byte mask)
    read once, dx, dW, db written once; 4*m*n*k FLOPs (two products)."""
    nbytes = 4 * (m * n + m * k + n * k + m * k + n * k + n) + (m * n if relu else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * m * n * k / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def plan_str(plan):
    """A launch plan in one column: row x column tile, the reduction's
    chunks x chunk length (= the cluster size), the grid; for the backward
    its dx and dW blocks, and dW's chunks of M when M is split."""
    grid = "x".join(str(g) for g in plan["grid"])
    out = (
        f"{plan['row_tile']}x{plan['col_tile']} {plan['chunks']}x{plan['chunk_len']} "
        f"grid {grid}"
    )
    if "dx_blocks" in plan:
        out += f" = {plan['dx_blocks']} dx + {plan['blocks'] - plan['dx_blocks']} dW"
        if plan["dw_chunk_len"]:
            out += f" (M {plan['chunks']}x{plan['dw_chunk_len']})"
    return out


def phase_device(torch, resolve_device):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    resolve_device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(tf32):
        fail(f"TF32 is on (matmul, cudnn) = {tf32}")
    say(card)
    say(
        f"phase 1 device: ok: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, TF32 matmul/cudnn off"
    )


def phase_build(build):
    sources = sorted({Path(k["source"]).stem for k in KERNELS.values()})
    t0 = time.perf_counter()
    logs = build.build_all(sources)
    secs = time.perf_counter() - t0
    regs = []
    for name in sources:
        for line in (logs.get(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                regs.append(f"{name}: {line.strip()}")
    say(
        f"phase 2 build: ok: {len(sources)} kernel(s) in {secs:.2f} s "
        f"({len(logs)} compiled, {len(sources) - len(logs)} already built)"
    )
    for line in regs:
        say(f"  {line}")


FWD_HEADER = (
    "  rows     K     N relu  tag        max_abs_err   kernel_ms    "
    "plain_ms    addmm_ms    bound_ms  bound_by    plan (tile chunks grid)"
)


def _check_fwd(torch, cuda_ops, gen, rows, k, n, relu, tag):
    """One forward shape on seeded operands: ``y`` within ``rtol=1e-5,
    atol=1e-5*ceil(K/784)`` of the plain version, ``mask`` equal where
    ``|z| > 1e-5``, two launches bitwise equal; then the three times and the
    bound, printed as a table row. Returns (err, ms, plain, lib, bound, by)."""
    x = torch.randn(rows, k, generator=gen).cuda()
    w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).cuda()
    b = (0.1 * torch.randn(n, generator=gen)).cuda()
    y, mask = cuda_ops.linear_act_fwd(x, w, b, relu)
    y2, mask2 = cuda_ops.linear_act_fwd(x, w, b, relu)
    torch.cuda.synchronize()
    y_ref, mask_ref = cuda_ops.linear_act_fwd_reference(x, w, b, relu)
    z = torch.addmm(b, x, w.T)
    atol = 1e-5 * math.ceil(k / 784)
    err = (y - y_ref).abs().max().item()
    if not torch.allclose(y, y_ref, rtol=1e-5, atol=atol):
        fail(f"y of {rows}x{k}->{n} relu={relu}: max |err| {err} > tolerance")
    stable = z.abs() > 1e-5
    if not torch.equal(mask[stable], mask_ref[stable]):
        fail(f"mask of {rows}x{k}->{n} relu={relu} differs where |z| > 1e-5")
    if not (torch.equal(y, y2) and torch.equal(mask, mask2)):
        fail(f"two launches of {rows}x{k}->{n} differ")
    ms = device_ms(torch, lambda: cuda_ops.linear_act_fwd(x, w, b, relu))
    plain = device_ms(torch, lambda: cuda_ops.linear_act_fwd_reference(x, w, b, relu))
    lib = device_ms(torch, lambda: torch.addmm(b, x, w.T))
    bnd, by = bound_ms(rows, k, n)
    say(
        f"  {rows:4d} {k:5d} {n:5d} {relu:4d}  {tag:9s} {err:12.3e} "
        f"{ms:11.5f} {plain:11.5f} {lib:11.5f} {bnd:11.5f}  {by:10s}  "
        f"{plan_str(cuda_ops.fwd_plan(rows, n, k))}"
    )
    return err, ms, plain, lib, bnd, by


def phase_kernels(torch, cuda_ops):
    """Kernel vs plain version at the path's shapes; returns the per-slot
    sums for the kernels line and the largest error seen."""
    gen = torch.Generator().manual_seed(0)
    shapes = []  # (rows, K, N, apply_relu, tag)
    for rows in (SLOT_ROWS, WIDE_ROWS):
        for k, n in zip(FLAGSHIP[:-2], FLAGSHIP[1:-1]):
            shapes.append((rows, k, n, 1, "flagship"))
        for k, n in MLP_DEEP_SHAPES:
            shapes.append((rows, k, n, 1, "mlp-deep"))
    shapes += [(37, 29, 23, 0, "ragged"), (37, 29, 23, 1, "ragged")]
    max_err = 0.0
    slot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    slot_bound_by = set()
    say(FWD_HEADER)
    for rows, k, n, relu, tag in shapes:
        err, ms, plain, lib, bnd, by = _check_fwd(torch, cuda_ops, gen, rows, k, n, relu, tag)
        max_err = max(max_err, err)
        if tag == "flagship" and rows == SLOT_ROWS:
            slot["ms"] += ms
            slot["plain_ms"] += plain
            slot["library_ms"] += lib
            slot["bound_ms"] += bnd
            slot_bound_by.add(by)
    say(
        f"phase 3 kernels: ok: {len(shapes)} shapes within tolerance, mask "
        f"equal where |z| > 1e-5, launches bitwise repeatable; max |err| "
        f"{max_err:.3e}; one flagship slot's 6 layers at {SLOT_ROWS} rows: "
        f"kernel {slot['ms']:.5f} ms, plain {slot['plain_ms']:.5f} ms, addmm "
        f"{slot['library_ms']:.5f} ms, bound {slot['bound_ms']:.5f} ms"
    )
    slot["bound_by"] = "bytes" if slot_bound_by == {"bytes"} else "operations"
    return slot, max_err


ROW_COUNTS = (1, 4, 8, 16, 32, 128, 1000)  # the row-independence check's M


def phase_row_independence(torch, cuda_ops):
    """The forward's row-independence rule on the card: the same seeded rows
    through the kernel at every M of ``ROW_COUNTS``, 784 -> 128 and 2048 ->
    2048, relu on and off; each launch's ``y`` and ``mask`` bitwise the same
    rows of the largest launch. Fails naming the first M that differs."""
    gen = torch.Generator().manual_seed(3)
    top = max(ROW_COUNTS)
    tiles = sorted({cuda_ops.fwd_plan(m, 1, 1)["row_tile"] for m in ROW_COUNTS})
    for k, n in ((FLAGSHIP[0], FLAGSHIP[1]), MLP_DEEP_SHAPES[1]):
        x = torch.randn(top, k, generator=gen).cuda()
        w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).cuda()
        b = (0.1 * torch.randn(n, generator=gen)).cuda()
        for relu in (1, 0):
            y_top, mask_top = cuda_ops.linear_act_fwd(x, w, b, relu)
            for m in ROW_COUNTS:
                y, mask = cuda_ops.linear_act_fwd(x[:m], w, b, relu)
                same = torch.equal(y.view(torch.int32), y_top[:m].view(torch.int32))
                if not (same and torch.equal(mask, mask_top[:m])):
                    fail(
                        f"row independence: at M={m} ({k}->{n}, relu={relu}, plan "
                        f"{plan_str(cuda_ops.fwd_plan(m, n, k))}) rows differ from the "
                        f"same rows of the {top}-row launch"
                    )
    say(
        f"phase 3 row independence: ok: M = {', '.join(map(str, ROW_COUNTS))} (row "
        f"tiles {tiles}) x 784->128 and 2048->2048 x relu on/off, every row's y and "
        f"mask bitwise the same row of the {top}-row launch"
    )


def _bwd_operands(torch, gen, rows, k, n):
    g = torch.randn(rows, n, generator=gen).cuda()
    mask = (torch.rand(rows, n, generator=gen) > 0.5).cuda()
    x = torch.randn(rows, k, generator=gen).cuda()
    w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).cuda()
    return g, mask, x, w


def _check_bwd(torch, got, want, rows, n, label):
    """dx (sum over N), dW and db (sums over the rows) against the plain
    version; returns the largest finite error."""
    worst = 0.0
    for name, a, b, length in zip(("dx", "dW", "db"), got, want, (n, rows, rows)):
        if a.shape != b.shape:
            fail(f"{label}: {name} is {tuple(a.shape)}, plain version {tuple(b.shape)}")
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"{label}: {name}'s NaNs differ from the plain version's")
        ok = torch.isfinite(b)
        if not torch.equal(ok, torch.isfinite(a)):
            fail(f"{label}: {name}'s non-finite values differ from the plain version's")
        err = (a[ok] - b[ok]).abs().max().item() if ok.any() else 0.0
        worst = max(worst, err)
        atol = 1e-5 * math.ceil(length / 784)
        if not torch.allclose(a[ok], b[ok], rtol=1e-5, atol=atol):
            fail(f"{label}: {name} max |err| {err} > rtol 1e-5, atol {atol}")
    return worst


def phase_bwd_kernels(torch, cuda_ops):
    """The backward kernel vs its plain version at the training path's
    shapes; returns one flagship microbatch's sums and the largest error."""
    gen = torch.Generator().manual_seed(1)
    shapes = []  # (rows, K, N, apply_relu, tag)
    for rows in (MUBATCH_ROWS, WIDE_ROWS):
        for k, n in zip(FLAGSHIP[:-2], FLAGSHIP[1:-1]):
            shapes.append((rows, k, n, 1, "flagship"))
        for k, n in MLP_DEEP_SHAPES:
            shapes.append((rows, k, n, 1, "mlp-deep"))
    shapes += [(37, 29, 23, 0, "ragged"), (37, 29, 23, 1, "ragged")]
    max_err = 0.0
    mub = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    mub_bound_by = set()
    say(
        "  rows     K     N relu  tag        max_abs_err   kernel_ms    "
        "plain_ms  3-call_ms    bound_ms  bound_by    plan (dx tile, N chunks, grid)"
    )
    for rows, k, n, relu, tag in shapes:
        g, mask, x, w = _bwd_operands(torch, gen, rows, k, n)
        label = f"bwd {rows}x{k}->{n} relu={relu}"
        got = cuda_ops.linear_act_bwd(g, mask, x, w, relu)
        again = cuda_ops.linear_act_bwd(g, mask, x, w, relu)
        torch.cuda.synchronize()
        want = cuda_ops.linear_act_bwd_reference(g, mask, x, w, relu)
        err = _check_bwd(torch, got, want, rows, n, label)
        max_err = max(max_err, err)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"two launches of {label} differ")
        ge = g * mask.to(g.dtype) if relu else g
        ms = device_ms(torch, lambda: cuda_ops.linear_act_bwd(g, mask, x, w, relu))
        plain = device_ms(
            torch, lambda: cuda_ops.linear_act_bwd_reference(g, mask, x, w, relu)
        )
        lib = device_ms(
            torch, lambda: (torch.mm(ge, w), torch.mm(ge.T, x), ge.sum(0))
        )
        bnd, by = bwd_bound_ms(rows, k, n, relu)
        say(
            f"  {rows:4d} {k:5d} {n:5d} {relu:4d}  {tag:9s} {err:12.3e} "
            f"{ms:11.5f} {plain:11.5f} {lib:11.5f} {bnd:11.5f}  {by:10s}  "
            f"{plan_str(cuda_ops.bwd_plan(rows, n, k))}"
        )
        if tag == "flagship" and rows == MUBATCH_ROWS:
            mub["ms"] += ms
            mub["plain_ms"] += plain
            mub["library_ms"] += lib
            mub["bound_ms"] += bnd
            mub_bound_by.add(by)
    # a poisoned gradient where the relu was off: g * mask is NaN there
    g, mask, x, w = _bwd_operands(torch, gen, MUBATCH_ROWS, FLAGSHIP[0], FLAGSHIP[1])
    mask[0, 3] = mask[5, 7] = False
    g[0, 3], g[5, 7] = float("nan"), float("inf")
    got = cuda_ops.linear_relu_bwd(g, mask, x, w)
    torch.cuda.synchronize()
    _check_bwd(
        torch, got, cuda_ops.linear_act_bwd_reference(g, mask, x, w), MUBATCH_ROWS,
        FLAGSHIP[1], "bwd NaN/Inf at masked positions",
    )
    if not (torch.isnan(got[0][[0, 5]]).all() and torch.isnan(got[2][[3, 7]]).all()):
        fail("bwd: a NaN/Inf in g at a masked position did not poison dx and db")
    say(
        f"phase 3b backward kernel: ok: {len(shapes)} shapes within tolerance, "
        f"NaN/Inf at masked positions propagate as in the plain version, "
        f"launches bitwise repeatable; max |err| {max_err:.3e}; one flagship "
        f"microbatch's 6 layers at {MUBATCH_ROWS} rows: kernel {mub['ms']:.5f} "
        f"ms, plain {mub['plain_ms']:.5f} ms, 3-call {mub['library_ms']:.5f} ms, "
        f"bound {mub['bound_ms']:.5f} ms"
    )
    mub["bound_by"] = "bytes" if mub_bound_by == {"bytes"} else "operations"
    return mub, max_err


def phase_train_fwd(torch, cuda_ops):
    """The forward kernel vs its plain version at the shapes training gives
    it and phase 3 does not: every flagship relu layer at 32 rows (a
    microbatch) and at the validation split's one eval chunk, mlp-deep's
    at 32 rows; the checks of phase 3. Returns the largest error."""
    gen = torch.Generator().manual_seed(2)
    shapes = []  # (rows, K, N, apply_relu, tag)
    for rows in (MUBATCH_ROWS, VAL_ROWS):
        for k, n in zip(FLAGSHIP[:-2], FLAGSHIP[1:-1]):
            shapes.append((rows, k, n, 1, "flagship"))
    for k, n in MLP_DEEP_SHAPES:
        shapes.append((MUBATCH_ROWS, k, n, 1, "mlp-deep"))
    say(FWD_HEADER)
    max_err = 0.0
    for shape in shapes:
        max_err = max(max_err, _check_fwd(torch, cuda_ops, gen, *shape)[0])
    say(
        f"phase 3b forward kernel at the training shapes: ok: {len(shapes)} "
        f"shapes within tolerance, mask equal where |z| > 1e-5, launches "
        f"bitwise repeatable; max |err| {max_err:.3e}"
    )
    return max_err


def phase_serving(torch, cuda_ops, TrainingSession, engine_mod, loadgen):
    """The main path. Returns the launch counts of the drive alone."""
    import numpy as np

    n_req, rate, slo_ms = 200, 1000.0, 50.0
    session = TrainingSession(device="cuda")
    engine = engine_mod.ServingEngine(session, slo_ms=slo_ms)
    payloads = loadgen.request_payloads(
        n_req, session.spec.in_dim, seed=0, rows_choices=tuple(range(1, 9))
    )
    arrivals = loadgen.poisson_arrivals(rate, n_req, seed=0)
    engine.warm_ladder()
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    done = loadgen.run_open_loop(engine, payloads, arrivals)
    launches = dict(cuda_ops.LAUNCHES)
    rec = engine.record_summary(offered_rps=rate)
    ok = [r for r in done if r.verdict == "ok"]
    if len(done) != n_req or len(ok) != n_req:
        verdicts = sorted({r.verdict for r in done})
        fail(f"serving: {len(ok)}/{n_req} ok of {len(done)} done ({verdicts})")
    relu_layers = sum(sum(s.relu_flags) for s in session.spec.stages)
    want = relu_layers * rec["slots_dispatched"]
    if launches["linear_act_fwd"] != want:
        fail(
            f"serving: {launches['linear_act_fwd']} kernel launches, want "
            f"{relu_layers} x {rec['slots_dispatched']} slots = {want}"
        )
    for r in ok:
        if not np.array_equal(r.result, session.predict(payloads[r.id])):
            fail(f"serving: response {r.id} differs from a direct predict()")
    cpu = TrainingSession(device="cpu")
    worst = 0.0
    for r in sorted(ok, key=lambda r: r.id)[:64]:
        worst = max(worst, float(np.abs(r.result - cpu.predict(payloads[r.id])).max()))
    if worst > 1e-6:
        fail(f"serving: card vs CPU plain path differ by {worst} > 1e-6")
    say(
        f"phase 4 serving: ok: {len(ok)}/{n_req} ok, bitwise equal to direct "
        f"predict(); {launches['linear_act_fwd']} launches = {relu_layers} x "
        f"{rec['slots_dispatched']} slots over {rec['dispatches']} dispatches; "
        f"card vs CPU max |diff| {worst:.3e} (64 responses); p50 "
        f"{rec['p50_latency_s'] * 1e3:.3f} ms, p99 "
        f"{rec['p99_latency_s'] * 1e3:.3f} ms, goodput "
        f"{rec['goodput_rps']:.1f} rps at {rate:.0f} rps offered (SLO {slo_ms:.0f} ms, "
        f"{rec['slo_met']}/{len(ok)} met)"
    )
    return launches


def phase_wide(torch, cuda_ops, TrainingSession):
    import numpy as np

    gpu = TrainingSession(model="mlp-deep", device="cuda")
    x = np.random.RandomState(1).randn(16 * gpu.slot_rows, gpu.spec.in_dim)
    x = x.astype(np.float32)
    gpu.predict(x[: gpu.slot_rows])  # first-use costs out of the count
    torch.cuda.synchronize()
    before = cuda_ops.LAUNCHES["linear_act_fwd"]
    t0 = time.perf_counter()
    got = gpu.predict(x)
    wall = time.perf_counter() - t0
    launches = cuda_ops.LAUNCHES["linear_act_fwd"] - before
    relu_layers = sum(sum(s.relu_flags) for s in gpu.spec.stages)
    if launches != 16 * relu_layers:
        fail(f"mlp-deep: {launches} launches, want 16 x {relu_layers}")
    want = TrainingSession(model="mlp-deep", device="cpu").predict(x)
    diff = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or diff > 1e-5:
        fail(f"mlp-deep: card vs CPU plain path differ by {diff} > 1e-5")
    say(
        f"phase 5 wide: ok: mlp-deep 16 slots x {gpu.slot_rows} rows, "
        f"{launches} launches ({relu_layers} per slot), card vs CPU max |diff| "
        f"{diff:.3e}, predict wall {wall * 1e3:.2f} ms"
    )


def write_split(path, n_train, n_val, seed=0):
    """A seeded synthetic MNIST-format split (Gaussian class clusters
    scaled into [0, 1]) as .npy: the port reads it as it reads
    ``prepare_data.py``'s output."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1.0, (10, FLAGSHIP[0])).astype(np.float32)
    for suffix, n in (("train", n_train), ("val", n_val)):
        labels = rng.randint(0, 10, n)
        x = centers[labels] + rng.normal(0, 2.0, (n, FLAGSHIP[0])).astype(np.float32)
        x = np.clip((x + 8.0) / 16.0, 0.0, 1.0).astype(np.float32)
        np.save(path / f"x_{suffix}.npy", x)
        np.save(path / f"y_{suffix}.npy", np.eye(10, dtype=np.float32)[labels])


def _params_close(a, b, label):
    """Card vs CPU params (host numpy trees) within the cross-engine class;
    returns the largest difference."""
    import numpy as np

    worst = 0.0
    for sa, sb in zip(a.params(), b.params()):
        for la, lb in zip(sa, sb):
            for key in ("W", "b"):
                if not np.isfinite(la[key]).all():
                    fail(f"{label}: non-finite {key} on the card")
                worst = max(worst, float(np.abs(la[key] - lb[key]).max()))
                if not np.allclose(la[key], lb[key], rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
                    fail(f"{label}: card vs CPU {key} differ by up to {worst}")
    return worst


def _moved(init, gpu, cpu):
    """Per leaf, the card run's largest move from ``init`` in units of the
    card-vs-CPU difference ``_params_close`` allows there (``TRAIN_ATOL +
    TRAIN_RTOL * |CPU value|``). Where a leaf moved 10 such units, a card
    that trained wrongly, or not at all, falls outside the tolerance."""
    import numpy as np

    ratios = []
    for s0, sg, sc in zip(init, gpu.params(), cpu.params()):
        for l0, lg, lc in zip(s0, sg, sc):
            for key in ("W", "b"):
                allowed = TRAIN_ATOL + TRAIN_RTOL * np.abs(lc[key])
                ratios.append(float((np.abs(lg[key] - l0[key]) / allowed).max()))
    return ratios


def _bitwise_equal(a, b):
    import numpy as np

    return all(
        np.array_equal(la[k], lb[k])
        for sa, sb in zip(a.params(), b.params())
        for la, lb in zip(sa, sb)
        for k in ("W", "b")
    )


def _train_2_epochs(TrainingSession, device, with_eval=True, **kw):
    """A session from init trained 2 epochs, ``accuracy()`` after each when
    ``with_eval``. Returns (session, init params, losses, accuracies, epoch
    walls)."""
    session = TrainingSession(device=device, **kw)
    init = session.params()
    losses, accs, walls = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(session.train_epoch())  # returns after the device
        walls.append(time.perf_counter() - t0)
        if with_eval:
            accs.append(session.accuracy())
    return session, init, losses, accs, walls


def _check_card_run(label, card, cpu, again):
    """A card run against the CPU's, both ``_train_2_epochs`` results:
    losses within the cross-engine class, the loss's fall within
    ``LOSS_DROP_RTOL`` of the CPU's (the run moves the loss by less than
    that class), accuracies within one sample, params within the class,
    every leaf moved from init >= ``MIN_MOVE`` allowed differences, and a
    second card run ``again`` bitwise equal. Returns (the largest param
    difference, the moves)."""
    gpu, init, losses, accs, _ = card
    cpu_session, _, closs, caccs, _ = cpu
    for e, (a, b) in enumerate(zip(losses, closs)):
        if not (math.isfinite(a) and abs(a - b) <= TRAIN_ATOL + TRAIN_RTOL * abs(b)):
            fail(f"{label}: epoch {e} loss {a} on the card, {b} on the CPU")
    drop, cdrop = losses[0] - losses[1], closs[0] - closs[1]
    if not (cdrop > 0 and abs(drop - cdrop) <= LOSS_DROP_RTOL * cdrop):
        fail(f"{label}: the loss fell {drop} on the card, {cdrop} on the CPU")
    if any(abs(a - b) * VAL_ROWS > 1.0 + 1e-9 for a, b in zip(accs, caccs)):
        fail(f"{label}: accuracies {accs} on the card, {caccs} on the CPU")
    worst = _params_close(gpu, cpu_session, label)
    moved = _moved(init, gpu, cpu_session)
    if min(moved) < MIN_MOVE:
        fail(
            f"{label}: a leaf moved at most {min(moved):.2f} x its allowed "
            f"card-vs-CPU difference, want >= {MIN_MOVE}"
        )
    if again[2] != losses or not _bitwise_equal(gpu, again[0]):
        fail(f"{label}: a second card run is not bitwise equal to the first")
    return worst, moved


def _side_run(TrainingSession, label, steps, **opts):
    """A card and a CPU session from init, ``steps`` steps each: params
    within tolerance, and the run moved some leaf >= MIN_MOVE units."""
    pair = [TrainingSession(device=d, **opts) for d in ("cuda", "cpu")]
    init = pair[0].params()
    for s in pair:
        s.train_steps(steps)
    diff = _params_close(*pair, label)
    most = max(_moved(init, *pair))
    if most < MIN_MOVE:
        fail(f"{label}: moved at most {most:.2f} x its allowed difference")
    return f"{label} {diff:.3e} (moved {most:.2f})"


def phase_training(torch, cuda_ops, TrainingSession, data_dir):
    """The training main path. Returns the launch counts of the drive alone."""
    B, M = 128, 4
    relu_layers = len(FLAGSHIP) - 2
    steps = 2 * TRAIN_BATCHES

    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    card = _train_2_epochs(TrainingSession, "cuda", data_dir=data_dir)
    launches = dict(cuda_ops.LAUNCHES)
    n_val = VAL_ROWS
    want_bwd = relu_layers * M * steps
    want_fwd = want_bwd + 2 * relu_layers * math.ceil(n_val / 1024)
    if launches["linear_act_bwd"] != want_bwd:
        fail(
            f"training: {launches['linear_act_bwd']} backward launches, want "
            f"{relu_layers} x {M} x {steps} steps = {want_bwd}"
        )
    if launches["linear_act_fwd"] != want_fwd:
        fail(f"training: {launches['linear_act_fwd']} forward launches, want {want_fwd}")
    cpu = _train_2_epochs(TrainingSession, "cpu", data_dir=data_dir)
    again = _train_2_epochs(TrainingSession, "cuda", with_eval=False, data_dir=data_dir)
    worst, moved = _check_card_run("training", card, cpu, again)
    _, _, losses, accs, walls = card
    closs = cpu[2]
    drop, cdrop = losses[0] - losses[1], closs[0] - closs[1]
    sps = TRAIN_BATCHES * B / walls[1]
    say(
        f"phase 6 training: ok: flagship B={B} M={M} SGD lr 0.006, 2 epochs x "
        f"{TRAIN_BATCHES} batches; {launches['linear_act_bwd']} backward launches "
        f"= {relu_layers} x {M} x {steps} steps, {launches['linear_act_fwd']} "
        f"forward (incl. 2 evals of {n_val} rows); losses {losses[0]:.7f} -> "
        f"{losses[1]:.7f} (drop {drop:.7e}, CPU {cdrop:.7e}), accuracy "
        f"{accs[0]:.4f} -> {accs[1]:.4f}; card vs CPU params max |diff| "
        f"{worst:.3e}, losses {closs}; every leaf moved >= {min(moved):.2f} x "
        f"its allowed difference (most {max(moved):.2f}); second card run "
        f"bitwise equal; steady epoch {walls[1] * 1e3:.2f} ms = {sps:.1f} "
        f"samples/s (first {walls[0] * 1e3:.2f} ms)"
    )

    torch.cuda.synchronize()
    before = cuda_ops.LAUNCHES["linear_act_bwd"]
    fused = _side_run(
        TrainingSession, "fused epoch", TRAIN_BATCHES, fuse_mubatches=True, data_dir=data_dir
    )
    n_fused = cuda_ops.LAUNCHES["linear_act_bwd"] - before
    if n_fused != relu_layers * TRAIN_BATCHES:
        fail(f"fused: {n_fused} backward launches, want {relu_layers} x {TRAIN_BATCHES}")
    stateful = [
        _side_run(TrainingSession, opt, 4, optimizer=opt, lr=lr, data_dir=data_dir)
        for opt, lr in STATEFUL_RECIPES
    ]
    say(
        f"  {n_fused} fused backward launches = {relu_layers} x {TRAIN_BATCHES} "
        f"steps; card vs CPU max |diff| (largest move in allowed differences): "
        f"{fused}; 4 steps: {', '.join(stateful)}"
    )
    return launches


def phase_wide_training(torch, cuda_ops, TrainingSession, data_dir):
    gpu = TrainingSession(model="mlp-deep", device="cuda", data_dir=data_dir)
    init = gpu.params()
    relu_layers = sum(sum(s.relu_flags) for s in gpu.spec.stages)
    torch.cuda.synchronize()
    before = cuda_ops.LAUNCHES["linear_act_bwd"]
    t0 = time.perf_counter()
    gpu.train_steps(2)
    wall = time.perf_counter() - t0
    launches = cuda_ops.LAUNCHES["linear_act_bwd"] - before
    if launches != relu_layers * 4 * 2:
        fail(f"mlp-deep training: {launches} launches, want {relu_layers} x 4 x 2")
    cpu = TrainingSession(model="mlp-deep", device="cpu", data_dir=data_dir)
    cpu.train_steps(2)
    worst = _params_close(gpu, cpu, "mlp-deep training")
    most = max(_moved(init, gpu, cpu))
    if most < MIN_MOVE:
        fail(f"mlp-deep training: moved at most {most:.2f} x its allowed difference")
    say(
        f"phase 7 wide training: ok: mlp-deep 2 steps, {launches} backward "
        f"launches ({relu_layers} x 4 per step), card vs CPU params max |diff| "
        f"{worst:.3e}, largest move {most:.2f} x its allowed difference, wall "
        f"{wall * 1e3:.1f} ms"
    )


def fused_bound_ms(widths, rows, batches, n_mirrors):
    """Least time for the fused train kernel over ``batches`` batches of
    ``rows``: per batch the forward (2 rows K N per layer), dW (the same)
    and dx of every layer but the first, on the fp32 pipes; bytes: each
    batch read once, the params and every optimizer mirror read once and
    written once, the loss written. Returns (ms, bound_by)."""
    kn = [k * n for k, n in zip(widths[:-1], widths[1:])]
    flops = batches * 2.0 * rows * (2 * sum(kn) + sum(kn[1:]))
    params = sum(kn) + sum(widths[1:])
    nbytes = 4 * (batches * rows * (widths[0] + widths[-1]) + 2 * params * (1 + n_mirrors) + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _fused_operands(torch, trainer, model, convert, recipe, seed, sizes=FLAGSHIP, rows=128,
                    group_rows=MUBATCH_ROWS):
    """Params of ``sizes`` (the flagship by default) from the port's init on
    the card with seeded nonzero biases (the init's are 0, where a decay has
    nothing to shrink), the recipe's optimizer state seeded nonzero (so the
    update reads it), and the kernel's keyword arguments for batches of
    ``rows`` in head groups of ``group_rows``. Returns (stage, mirrors,
    scalars, kw, n_mirrors)."""
    from shallowspeed_tpu_torch.optimizer import make_optimizer

    spec = model.make_model_spec(sizes, 1, rows)
    stages = convert.params_from_numpy(model.init_model(spec), "cuda")
    opt = make_optimizer(
        recipe["optimizer"], recipe["lr"], weight_decay=recipe.get("weight_decay", 0.0)
    )
    desc = trainer._kernel_opt_descriptor(opt)
    stage = model.param_tree(stages)[0]
    # seeded nonzero state, so the update reads it: momentum's velocity and
    # Adam's m ~ 1e-3 N(0, 1), Adam's v ~ 1e-6 |N(0, 1)| (a second moment)
    gen = torch.Generator().manual_seed(seed)
    for layer in stage:
        layer["b"] = (0.01 * torch.randn(layer["b"].shape, generator=gen)).cuda()
    scales = {"sgd": (), "momentum": (1e-3,), "adam": (1e-3, 1e-6)}[desc["kind"]]
    mirrors = [
        [
            {k: (scale * torch.randn(v.shape, generator=gen)).cuda() for k, v in layer.items()}
            for layer in stage
        ]
        for scale in scales
    ]
    if desc["kind"] == "adam":
        for layer in mirrors[1]:
            for v in layer.values():
                v.abs_()
    n_mirrors = len(mirrors)
    scalars = [torch.full((), 3.0, device="cuda")] if desc["kind"] == "adam" else []
    kw = dict(
        relu_flags=spec.stages[0].relu_flags, group_rows=group_rows, batch_size=rows,
        lr=opt.lr, weight_decay=opt.weight_decay, opt=desc,
        clip_norm=recipe.get("clip_norm"),
    )
    return stage, mirrors, scalars, kw, n_mirrors


def _clone(stage, mirrors, scalars):
    cp = lambda group: [{k: v.clone() for k, v in layer.items()} for layer in group]  # noqa: E731
    return cp(stage), [cp(m) for m in mirrors], [t.clone() for t in scalars]


def _state_leaves(stage, mirrors, scalars):
    """The params, the optimizer mirrors and the scalar slots, in a fixed
    order."""
    leaves = [layer[k] for layer in stage for k in ("W", "b")]
    leaves += [layer[k] for m in mirrors for layer in m for k in ("W", "b")]
    return leaves + list(scalars)


def _fused_close(torch, got, want, init, label, rtol):
    """Kernel vs plain version on what the call changed (see
    ``FUSED_UPD_RTOL``): every leaf's change from ``init`` (stage, mirrors,
    scalars) within ``rtol`` of the plain change's largest magnitude plus
    one float32 rounding at the leaf's largest value, the scalar slots
    equal, the loss within ``FUSED_LOSS_RTOL``. Returns (the largest
    difference, the largest difference over its leaf's largest change)."""
    worst = ratio = 0.0
    leaves = zip(_state_leaves(*got[:3]), _state_leaves(*want[:3]), _state_leaves(*init))
    for i, (a, b, a0) in enumerate(leaves):
        if not torch.isfinite(a).all():
            fail(f"{label}: leaf {i} of the kernel's result is not finite")
        if a.dim() == 0 and not torch.equal(a, b):
            fail(f"{label}: scalar slot {a.item()}, plain version {b.item()}")
        got_change, want_change = a.double() - a0.double(), b.double() - a0.double()
        err = (got_change - want_change).abs().max().item()
        scale = want_change.abs().max().item()
        tol = rtol * scale + FLT_EPS * b.abs().max().item()
        if err > tol:
            fail(
                f"{label}: leaf {i}'s change differs from the plain version's by "
                f"{err}, over {tol} ({rtol} of its largest change {scale})"
            )
        worst = max(worst, err)
        ratio = max(ratio, err / scale if scale else 0.0)
    if not torch.allclose(got[3], want[3], rtol=FUSED_LOSS_RTOL, atol=0.0):
        fail(f"{label}: loss {got[3].tolist()}, plain version {want[3].tolist()}")
    return worst, ratio


def phase_fused_kernels(torch, cuda_ops, data_dir):
    """The fused train kernel against its plain version on the card: one
    flagship step for every recipe, then the SGD recipe's whole epoch and
    2-epoch run; two launches bitwise equal; the times, and the device time
    of the fused-microbatch step without the fused kernel. Returns {mode: {"max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by"}}."""
    import numpy as np

    from shallowspeed_tpu_torch import convert, trainer
    from shallowspeed_tpu_torch import model as model_mod

    X = torch.from_numpy(np.load(Path(data_dir) / "x_train.npy")).cuda()
    Y = torch.from_numpy(np.load(Path(data_dir) / "y_train.npy")).cuda()
    nb = X.shape[0] // 128
    X = X[: nb * 128].reshape(nb, 128, -1)
    Y = Y[: nb * 128].reshape(nb, 128, -1)
    inputs = {"step": (X[0], Y[0]), "epoch": (X, Y), "run": (X, Y)}
    extra = {"step": dict(epoch_mode=False), "epoch": dict(epoch_mode=True),
             "run": dict(epoch_mode=True, n_epochs=RUN_EPOCHS)}
    batches = {"step": 1, "epoch": nb, "run": nb * RUN_EPOCHS}
    out = {}
    lines = []
    for case_i, (label, recipe) in enumerate(FUSED_CASES):
        modes = FUSED_MODES if label == "sgd" else ("step",)
        for mode in modes:
            stage, mirrors, scalars, kw, n_mirrors = _fused_operands(
                torch, trainer, model_mod, convert, recipe, seed=case_i
            )
            kw.update(extra[mode])
            x, y = inputs[mode]
            a = _clone(stage, mirrors, scalars)
            b = _clone(stage, mirrors, scalars)
            p = _clone(stage, mirrors, scalars)
            got = cuda_ops.fused_train_call(a[0], x, y, mirrors=a[1], scalars=a[2], **kw)
            again = cuda_ops.fused_train_call(b[0], x, y, mirrors=b[1], scalars=b[2], **kw)
            torch.cuda.synchronize()
            want = cuda_ops.fused_train_reference(p[0], x, y, mirrors=p[1], scalars=p[2], **kw)
            tag = f"fused {mode} {label}"
            err, ratio = _fused_close(
                torch, got, want, (stage, mirrors, scalars), tag, FUSED_UPD_RTOL[mode]
            )
            if not torch.equal(got[3], again[3]) or not all(
                torch.equal(u, v)
                for u, v in zip(_state_leaves(*got[:3]), _state_leaves(*again[:3]))
            ):
                fail(f"{tag}: two launches differ")
            diff = f"max |kernel - plain| {err:.3e} = {ratio:.3e} of the largest change"
            if label != "sgd":
                lines.append(f"  {tag}: {diff}")
                continue
            reps, iters = (20, 15) if mode == "step" else (2, 5)
            t = _clone(stage, mirrors, scalars)
            ms = device_ms(
                torch,
                lambda: cuda_ops.fused_train_call(t[0], x, y, mirrors=t[1], scalars=t[2], **kw),
                reps=reps, iters=iters,
            )
            q = _clone(stage, mirrors, scalars)
            plain = device_ms(
                torch,
                lambda: cuda_ops.fused_train_reference(q[0], x, y, mirrors=q[1], scalars=q[2], **kw),
                reps=reps, iters=iters,
            )
            bnd, by = fused_bound_ms(FLAGSHIP, 128, batches[mode], n_mirrors)
            out[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
            lines.append(
                f"  {tag}: {batches[mode]} batch(es): {diff}; kernel "
                f"{ms:.5f} ms ({ms / batches[mode]:.5f} per step; before the redesign "
                f"{FUSED_BEFORE_MS[mode]:.5f}), plain {plain:.5f} ms, bound {bnd:.5f} ms ({by})"
            )
    # the partition's other shapes: odd widths in small groups, one big group
    gen = torch.Generator().manual_seed(8)
    for case_i, (label, sizes, rows, group) in enumerate(FUSED_SHAPES):
        stage, mirrors, scalars, kw, _ = _fused_operands(
            torch, trainer, model_mod, convert, FUSED_CASES[0][1], seed=10 + case_i,
            sizes=sizes, rows=rows, group_rows=group,
        )
        kw.update(epoch_mode=False)
        if sizes == FLAGSHIP:
            x, y = X[1][:rows], Y[1][:rows]
        else:
            x = torch.rand((rows, sizes[0]), generator=gen).cuda()
            y = torch.eye(sizes[-1])[torch.randint(0, sizes[-1], (rows,), generator=gen)].cuda()
        a, b, p = (_clone(stage, mirrors, scalars) for _ in range(3))
        got = cuda_ops.fused_train_call(a[0], x, y, mirrors=a[1], scalars=a[2], **kw)
        again = cuda_ops.fused_train_call(b[0], x, y, mirrors=b[1], scalars=b[2], **kw)
        torch.cuda.synchronize()
        want = cuda_ops.fused_train_reference(p[0], x, y, mirrors=p[1], scalars=p[2], **kw)
        tag = f"fused step {label} ({rows} rows, groups of {group})"
        err, ratio = _fused_close(
            torch, got, want, (stage, mirrors, scalars), tag, FUSED_UPD_RTOL["step"]
        )
        if not torch.equal(got[3], again[3]) or not all(
            torch.equal(u, v) for u, v in zip(_state_leaves(*got[:3]), _state_leaves(*again[:3]))
        ):
            fail(f"{tag}: two launches differ")
        out["step"]["max_abs_err"] = max(out["step"]["max_abs_err"], err)
        lines.append(f"  {tag}: max |kernel - plain| {err:.3e} = {ratio:.3e} of the largest change")
    # the "before": the fused-microbatch step without the fused kernel
    spec = model_mod.make_model_spec(FLAGSHIP, 1, 128)
    stages = convert.params_from_numpy(model_mod.init_model(spec), "cuda")
    from shallowspeed_tpu_torch.optimizer import SGD

    opt = SGD(0.006)
    step = trainer._make_batch_step(spec, opt, fuse_mubatches=True)
    xb, yb = X[0].reshape(4, MUBATCH_ROWS, -1), Y[0].reshape(4, MUBATCH_ROWS, -1)
    before = device_ms(torch, lambda: step(stages, (), xb, yb))
    for line in lines:
        say(line)
    say(
        f"phase 8a fused train kernel: ok: {len(FUSED_CASES)} recipes x one flagship "
        f"step (B=128, groups of {MUBATCH_ROWS}), the SGD recipe's {nb}-batch epoch "
        f"and {RUN_EPOCHS}-epoch run, and {len(FUSED_SHAPES)} more shapes of the "
        f"partition within tolerance of the plain version (each "
        f"leaf's change within {FUSED_UPD_RTOL['step']} of its largest change after "
        f"a step, {FUSED_UPD_RTOL['epoch']} after an epoch or run), two launches "
        f"bitwise equal; per step: "
        f"kernel {out['step']['ms']:.5f} ms (in the epoch kernel "
        f"{out['epoch']['ms'] / nb:.5f}; before the redesign {FUSED_BEFORE_MS['step']:.5f} "
        f"and {FUSED_BEFORE_MS['epoch'] / TRAIN_BATCHES:.5f}), plain {out['step']['plain_ms']:.5f} ms, the "
        f"fused-microbatch step without the kernel (B1/B3 kernels + torch ops) "
        f"{before:.5f} ms, bound "
        f"{out['step']['bound_ms']:.5f} ms ({out['step']['bound_by']})"
    )
    return out


def phase_fused_training(torch, cuda_ops, TrainingSession, data_dir):
    """The kernel paths of the training main path: the phase 6 split, 2
    epochs, through the megakernel (16 launches an epoch), the epoch kernel
    (1 an epoch) and the run kernel (1 for the run), each against the CPU
    path. Returns {mode: fused_train launches over its drive}."""
    relu_layers = len(FLAGSHIP) - 2
    kw = dict(data_dir=data_dir, fuse_mubatches=True)
    evals = 2 * relu_layers * math.ceil(VAL_ROWS / 1024)

    cpu = _train_2_epochs(TrainingSession, "cpu", epoch_kernel=True, **kw)
    launches, sessions, report = {}, {}, []
    for mode, flags, per_epoch in (
        ("step", dict(megakernel=True), TRAIN_BATCHES),
        ("epoch", dict(epoch_kernel=True), 1),
    ):
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        card = _train_2_epochs(TrainingSession, "cuda", **flags, **kw)
        counts = dict(cuda_ops.LAUNCHES)
        launches[mode] = counts["fused_train"]
        if counts["fused_train"] != 2 * per_epoch:
            fail(f"fused {mode}: {counts['fused_train']} launches, want 2 x {per_epoch}")
        if counts["linear_act_bwd"] != 0 or counts["linear_act_fwd"] != evals:
            fail(f"fused {mode}: B1-B4 launches {counts}, want only eval's {evals} forwards")
        again = _train_2_epochs(TrainingSession, "cuda", with_eval=False, **flags, **kw)
        worst, moved = _check_card_run(f"fused {mode}", card, cpu, again)
        gpu, _, losses, _, walls = card
        sessions[mode] = gpu
        sps = TRAIN_BATCHES * 128 / min(walls[1], again[4][1])
        report.append(
            f"{mode}: {counts['fused_train']} launches, losses {losses[0]:.7f} -> "
            f"{losses[1]:.7f} (drop {losses[0] - losses[1]:.7e}, CPU "
            f"{cpu[2][0] - cpu[2][1]:.7e}), card vs CPU params {worst:.3e}, every "
            f"leaf moved >= {min(moved):.2f}, steady epoch {sps:.1f} samples/s"
        )
    if not _bitwise_equal(sessions["step"], sessions["epoch"]):
        fail("fused: the epoch kernel is not bitwise 16 step kernels")

    # the whole run in one launch, twice (the second timed warm)
    def whole_run():
        session = TrainingSession(device="cuda", run_kernel=True, **kw)
        init = session.params()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, accs = session.train_run(2, with_eval=False)
        if accs is not None:
            fail(f"fused run: train_run(with_eval=False) gave accuracies {accs}")
        return session, init, losses, [], time.perf_counter() - t0

    cuda_ops.reset_launches()
    run = whole_run()
    counts = dict(cuda_ops.LAUNCHES)
    launches["run"] = counts["fused_train"]
    if {k: v for k, v in counts.items() if v} != {"fused_train": 1}:
        fail(f"fused run: launches {counts}, want one fused_train")
    if not _bitwise_equal(run[0], sessions["epoch"]):
        fail("fused run: not bitwise two epoch-kernel epochs")
    again = whole_run()
    worst, _ = _check_card_run("fused run", run, cpu, again)
    report.append(
        f"run: 1 launch for 2 epochs, losses {run[2]}, card vs CPU params {worst:.3e}, "
        f"{2 * TRAIN_BATCHES * 128 / again[4]:.1f} samples/s (second session)"
    )

    # train_steps in two chunks is one epoch, bitwise
    chunked = TrainingSession(device="cuda", epoch_kernel=True, **kw)
    whole = TrainingSession(device="cuda", epoch_kernel=True, **kw)
    whole.train_epoch()
    chunked.train_steps(5)
    steps, _ = chunked.train_steps(TRAIN_BATCHES)
    if steps != TRAIN_BATCHES - 5 or not _bitwise_equal(chunked, whole):
        fail("fused: train_steps in two chunks is not bitwise one epoch")

    # momentum and Adam, 4 steps each through the epoch kernel
    stateful = [
        _side_run(TrainingSession, f"fused {opt}", 4, epoch_kernel=True, optimizer=opt, lr=lr, **kw)
        for opt, lr in STATEFUL_RECIPES
    ]

    # a configuration over the budget is refused before any launch
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    try:
        TrainingSession(device="cuda", model="mlp-deep", epoch_kernel=True, **kw)
    except ValueError as e:
        refusal = str(e)
    else:
        fail("fused: mlp-deep with epoch_kernel=True was not refused")
    if any(cuda_ops.LAUNCHES.values()):
        fail(f"fused: the refused session launched {cuda_ops.LAUNCHES}")
    for line in report:
        say(f"  {line}")
    say(
        f"phase 8b fused training: ok: 16 / 1 / 1 fused launches per epoch / epoch / "
        f"run, no B1-B4 launch but eval's; the epoch kernel bitwise 16 step kernels, "
        f"the run kernel bitwise 2 epoch kernels, 2 train_steps chunks bitwise one "
        f"epoch; 4 epoch-kernel steps card vs CPU: {', '.join(stateful)}; mlp-deep "
        f"refused ({refusal!r})"
    )
    return launches


# ---------------------------------------------------------------------------
# phase 9: the pipeline executor and its flag kernels (TPU kernels B5-B8)
# ---------------------------------------------------------------------------

# the reference's four mesh configs and PipeDream-Flush, through the
# executor with kernel_backend="pallas": (label, dp, pp, schedule, epochs)
MESH_CONFIGS = (
    ("DP=4 naive", 4, 1, "naive", 1),
    ("PP=4 naive", 1, 4, "naive", 1),
    ("PP=4 GPipe", 1, 4, "gpipe", 1),
    ("DP=2xPP=4 GPipe", 2, 4, "gpipe", 2),
    ("PP=4 PipeDream", 1, 4, "pipedream", 1),
)
MAIN_MESH = dict(dp=2, pp=4, schedule="gpipe", kernel_backend="pallas")
FLAGSHIP_LINEARS = len(FLAGSHIP) - 1  # each runs once per microbatch per replica
SEQ_RTOL, SEQ_ATOL = 3e-4, 3e-6  # the executor's cross-layout class (tests/test_executor.py)


def executor_slots(model, pp, rows):
    """``(rows, K, N, flag, in_d, out_d)`` of every Linear the executor
    launches for ``model`` over ``pp`` stages with ``rows`` rows per
    replica's microbatch, in stage order: its slot's padded stacked dims,
    its relu flag, and its own widths inside them (the rest of the slot's
    input, W and b are zeros)."""
    from shallowspeed_tpu_torch.model import make_model_spec, resolve_model
    from shallowspeed_tpu_torch.parallel.executor import slot_shapes

    sizes, act = resolve_model(model)
    spec = make_model_spec(sizes, pp, 128, act=act)
    dims = slot_shapes(spec)
    return [
        (rows, dims[l][1], dims[l][0], int(st.relu_flags[l]), st.local_sizes[l], st.local_sizes[l + 1])
        for st in spec.stages
        for l in range(st.n_linears)
    ]


def flag_drives():
    """``(tag, executor_slots)`` of every drive of phases 9b and 9c: each
    config's training microbatch (B=128, M=4, rows B/M/dp per replica), the
    DP=2xPP=4 session's eval and predict slots (``slot_rows / dp`` rows per
    replica) and mlp-deep at PP=4."""
    from shallowspeed_tpu_torch.serving.slots import default_slot_rows

    B, M = 128, 4
    drives = [(label, executor_slots("mnist-mlp", pp, B // M // dp)) for label, dp, pp, *_ in MESH_CONFIGS]
    dp, pp = MAIN_MESH["dp"], MAIN_MESH["pp"]
    drives.append(("DP=2xPP=4 eval", executor_slots("mnist-mlp", pp, default_slot_rows(dp) // dp)))
    drives.append(("mlp-deep PP=4", executor_slots("mlp-deep", 4, B // M)))
    return drives


def _flag_operands(torch, gen, rows, k, n, in_d, out_d):
    """Seeded operands of one executor slot: the input, W and b are zero
    beyond the Linear's own ``in_d`` x ``out_d`` (the zero-padded stacked
    layout)."""
    x = torch.randn(rows, k, generator=gen)
    w = torch.randn(n, k, generator=gen) / math.sqrt(in_d)
    b = 0.1 * torch.randn(1, n, generator=gen)
    x[:, in_d:] = 0
    w[:, in_d:] = 0
    w[out_d:] = 0
    b[:, out_d:] = 0
    g = torch.randn(rows, n, generator=gen)
    return [t.cuda() for t in (x, w, b, g)]


def _check_flag_slot(torch, cuda_ops, gen, rows, k, n, flag, in_d, out_d, tag):
    """Both flag entries at one executor shape against their plain versions
    with phase 3's and 3b's checks; then their times. Returns (fwd, bwd)
    dicts of err, ms, plain_ms, library_ms, bound_ms, bound_by."""
    x, w, b, g = _flag_operands(torch, gen, rows, k, n, in_d, out_d)
    label = f"flag {rows}x{k}->{n} ({in_d}->{out_d}) flag={flag} {tag}"
    y, mask = cuda_ops.linear_flag_fwd(x, w, b, flag)
    y2, mask2 = cuda_ops.linear_flag_fwd(x, w, b, flag)
    torch.cuda.synchronize()
    y_ref, mask_ref = cuda_ops.linear_flag_fwd_reference(x, w, b, flag)
    z = torch.addmm(b, x, w.T)
    f_err = (y - y_ref).abs().max().item()
    if not torch.allclose(y, y_ref, rtol=1e-5, atol=1e-5 * math.ceil(k / 784)):
        fail(f"{label}: y max |err| {f_err} > tolerance")
    stable = z.abs() > 1e-5
    if not torch.equal(mask[stable], mask_ref[stable]):
        fail(f"{label}: mask differs where |z| > 1e-5")
    if not (torch.equal(y, y2) and torch.equal(mask, mask2)):
        fail(f"{label}: two forward launches differ")
    got = cuda_ops.linear_flag_bwd(g, mask_ref, x, w, flag)
    again = cuda_ops.linear_flag_bwd(g, mask_ref, x, w, flag)
    torch.cuda.synchronize()
    want = cuda_ops.linear_flag_bwd_reference(g, mask_ref, x, w, flag)
    b_err = _check_bwd(torch, got, want, rows, n, label)
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        fail(f"{label}: two backward launches differ")
    fwd = dict(max_abs_err=f_err)
    fwd["ms"] = device_ms(torch, lambda: cuda_ops.linear_flag_fwd(x, w, b, flag))
    fwd["plain_ms"] = device_ms(torch, lambda: cuda_ops.linear_flag_fwd_reference(x, w, b, flag))
    fwd["library_ms"] = device_ms(torch, lambda: torch.addmm(b, x, w.T))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(rows, k, n)
    ge = g * mask_ref.to(g.dtype) if flag else g
    bwd = dict(max_abs_err=b_err)
    bwd["ms"] = device_ms(torch, lambda: cuda_ops.linear_flag_bwd(g, mask_ref, x, w, flag))
    bwd["plain_ms"] = device_ms(
        torch, lambda: cuda_ops.linear_flag_bwd_reference(g, mask_ref, x, w, flag)
    )
    bwd["library_ms"] = device_ms(torch, lambda: (torch.mm(ge, w), torch.mm(ge.T, x), ge.sum(0)))
    bwd["bound_ms"], bwd["bound_by"] = bwd_bound_ms(rows, k, n, bool(flag))
    for name, r, plan in (
        ("fwd", fwd, cuda_ops.fwd_plan(rows, n, k)), ("bwd", bwd, cuda_ops.bwd_plan(rows, n, k))
    ):
        say(
            f"  {rows:4d} {k:5d} {n:5d} {flag:4d} {in_d:5d} {out_d:5d}  {tag:16s} {name}  "
            f"{r['max_abs_err']:11.3e} "
            f"{r['ms']:11.5f} {r['plain_ms']:11.5f} {r['library_ms']:11.5f} "
            f"{r['bound_ms']:11.5f}  {r['bound_by']:10s}  {plan_str(plan)}"
        )
    return fwd, bwd


def phase_flag_kernels(torch, cuda_ops):
    """9a: the flag entries against their plain versions at every slot of
    every drive of 9b and 9c (``flag_drives``), and a ragged shape with the
    flag off and on. Returns ({entry: one DP=2xPP=4 microbatch's 7-slot
    sums}, {entry: largest error}, the set of (rows, K, N, flag) checked)."""
    gen = torch.Generator().manual_seed(9)
    shapes = {}  # (rows, K, N, flag, in_d, out_d) -> the first drive that runs it
    for tag, slots in flag_drives():
        for slot in slots:
            shapes.setdefault(slot, tag)
    for flag in (0, 1):
        shapes[(37, 29, 23, flag, 29, 23)] = "ragged"
    say(
        "  rows     K     N flag  in_d out_d  tag              pass max_abs_err   kernel_ms    "
        "plain_ms  library_ms    bound_ms  bound_by    plan (tile chunks grid)"
    )
    results = {}
    errs = {"linear_flag_fwd": 0.0, "linear_flag_bwd": 0.0}
    for slot, tag in shapes.items():
        fwd, bwd = _check_flag_slot(torch, cuda_ops, gen, *slot, tag)
        results[slot] = (fwd, bwd)
        errs["linear_flag_fwd"] = max(errs["linear_flag_fwd"], fwd["max_abs_err"])
        errs["linear_flag_bwd"] = max(errs["linear_flag_bwd"], bwd["max_abs_err"])
    # one DP=2xPP=4 microbatch: stages 0-2 run slots 0 and 1 with the relu,
    # stage 3 its one Linear (slot 0) without
    main = executor_slots("mnist-mlp", MAIN_MESH["pp"], 128 // 4 // MAIN_MESH["dp"])
    sums = {}
    for i, entry in enumerate(("linear_flag_fwd", "linear_flag_bwd")):
        parts = [results[slot][i] for slot in main]
        s = {key: sum(p[key] for p in parts) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        s["bound_by"] = "bytes" if {p["bound_by"] for p in parts} == {"bytes"} else "operations"
        sums[entry] = s
    say(
        f"phase 9a flag kernels: ok: {len(shapes)} executor shapes x forward and "
        f"backward within phase 3/3b's tolerances, launches bitwise repeatable; max "
        f"|err| fwd {errs['linear_flag_fwd']:.3e}, bwd {errs['linear_flag_bwd']:.3e}; "
        f"one DP=2xPP=4 microbatch's {len(main)} slots: fwd "
        f"{sums['linear_flag_fwd']['ms']:.5f} ms (bound "
        f"{sums['linear_flag_fwd']['bound_ms']:.5f}), bwd {sums['linear_flag_bwd']['ms']:.5f} "
        f"ms (bound {sums['linear_flag_bwd']['bound_ms']:.5f})"
    )
    return sums, errs, {slot[:4] for slot in shapes}


@contextlib.contextmanager
def flag_shapes_seen(cuda_ops, seen):
    """Within the block, add the (rows, K, N, flag) of every flag-entry call
    on CUDA tensors to ``seen``: the shapes the drives really launched."""
    fwd, bwd = cuda_ops.linear_flag_fwd, cuda_ops.linear_flag_bwd

    def seen_fwd(x, w, b2, flag):
        if x.is_cuda:
            seen.add((x.shape[0], x.shape[1], w.shape[0], int(flag)))
        return fwd(x, w, b2, flag)

    def seen_bwd(g, mask, x, w, flag):
        if x.is_cuda:
            seen.add((x.shape[0], x.shape[1], w.shape[0], int(flag)))
        return bwd(g, mask, x, w, flag)

    cuda_ops.linear_flag_fwd, cuda_ops.linear_flag_bwd = seen_fwd, seen_bwd
    try:
        yield
    finally:
        cuda_ops.linear_flag_fwd, cuda_ops.linear_flag_bwd = fwd, bwd


def _eval_flag_launches(session, n_rows):
    """Forward flag launches of one ``predict``/``accuracy()`` over n_rows
    on a mesh session: per chunk of at most the top rung's slots, dp
    replicas x the rung's microbatches x the model's active slots."""
    from shallowspeed_tpu_torch.serving import slots as serving_slots

    active = len(session.spec.sizes) - 1  # one active slot per Linear
    cap = session.slot_ladder[-1] * session.slot_rows
    total = 0
    for i in range(0, n_rows, cap):
        m = serving_slots.slots_needed(min(cap, n_rows - i), session.slot_rows)
        total += session.dp * serving_slots.rung_for(m, session.slot_ladder) * active
    return total


def _params_close_to(a, b, rtol, atol, label):
    import numpy as np

    worst = 0.0
    for sa, sb in zip(a, b):
        for la, lb in zip(sa, sb):
            for key in ("W", "b"):
                worst = max(worst, float(np.abs(la[key] - lb[key]).max()))
                if not np.allclose(la[key], lb[key], rtol=rtol, atol=atol):
                    fail(f"{label}: {key} differs by up to {worst}")
    return worst


def _sequential_card_params(TrainingSession, data_dir, epochs):
    """The card's sequential session (phase 6's recipe), params after each
    epoch."""
    seq = TrainingSession(device="cuda", data_dir=data_dir)
    out = []
    for _ in range(max(epochs)):
        seq.train_epoch()
        out.append(seq.params())
    return {e: out[e - 1] for e in epochs}


def phase_pipeline_training(torch, cuda_ops, TrainingSession, data_dir):
    """9b: the five executor configs through the flag kernels on phase 6's
    split. Returns the flag entries' launches over the drive and samples/s
    per config."""
    B, M = 128, 4
    seq = _sequential_card_params(TrainingSession, data_dir, (1, 2))
    drive = {"linear_flag_fwd": 0, "linear_flag_bwd": 0}
    lines, rates = [], {}
    for label, dp, pp, schedule, epochs in MESH_CONFIGS:
        kw = dict(data_dir=data_dir, dp=dp, pp=pp, schedule=schedule, kernel_backend="pallas")
        with_eval = epochs == 2
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        if with_eval:
            card = _train_2_epochs(TrainingSession, "cuda", **kw)
        else:
            gpu = TrainingSession(device="cuda", **kw)
            init = gpu.params()
            t0 = time.perf_counter()
            loss = gpu.train_epoch()
            card = (gpu, init, [loss], [], [time.perf_counter() - t0])
        counts = dict(cuda_ops.LAUNCHES)
        gpu = card[0]
        steps = TRAIN_BATCHES * epochs
        want_bwd = dp * M * FLAGSHIP_LINEARS * steps
        want_fwd = want_bwd + (epochs * _eval_flag_launches(gpu, VAL_ROWS) if with_eval else 0)
        if counts["linear_flag_bwd"] != want_bwd or counts["linear_flag_fwd"] != want_fwd:
            fail(
                f"{label}: flag launches fwd {counts['linear_flag_fwd']} / bwd "
                f"{counts['linear_flag_bwd']}, want {want_fwd} / {want_bwd} "
                f"(dp {dp} x M {M} x {FLAGSHIP_LINEARS} Linears x {steps} steps"
                + (", plus eval's forwards)" if with_eval else ")")
            )
        others = {k: v for k, v in counts.items() if not k.startswith("linear_flag")}
        if any(others.values()):
            fail(f"{label}: the mesh path launched {others}")
        drive["linear_flag_fwd"] += counts["linear_flag_fwd"]
        drive["linear_flag_bwd"] += counts["linear_flag_bwd"]
        if with_eval:
            cpu = _train_2_epochs(TrainingSession, "cpu", **kw)
            again = _train_2_epochs(TrainingSession, "cuda", with_eval=False, **kw)
            worst, moved = _check_card_run(label, card, cpu, again)
            extra = (
                f", losses {card[2][0]:.7f} -> {card[2][1]:.7f}, accuracy {card[3]}, every "
                f"leaf moved >= {min(moved):.2f}, second card run bitwise"
            )
        else:
            cpu_s = TrainingSession(device="cpu", **kw)
            cpu_s.train_epoch()
            worst = _params_close(gpu, cpu_s, label)
            extra = f", loss {card[2][0]:.7f}"
        seq_diff = _params_close_to(gpu.params(), seq[epochs], SEQ_RTOL, SEQ_ATOL, f"{label} vs sequential")
        rates[label] = TRAIN_BATCHES * B / card[4][-1]
        lines.append(
            f"  {label}: {epochs} epoch(s), {counts['linear_flag_fwd']} fwd / "
            f"{counts['linear_flag_bwd']} bwd flag launches (= {dp} x {M} x "
            f"{FLAGSHIP_LINEARS} x {steps} steps{' + eval' if with_eval else ''}); card vs "
            f"CPU {worst:.3e}, vs the card's sequential run {seq_diff:.3e}{extra}; "
            f"{rates[label]:.1f} samples/s (epoch {card[4][-1] * 1e3:.2f} ms)"
        )

    # DP=2xPP=4 GPipe: train_steps in two chunks is one epoch, bitwise
    whole = TrainingSession(device="cuda", data_dir=data_dir, **MAIN_MESH)
    whole.train_epoch()
    chunked = TrainingSession(device="cuda", data_dir=data_dir, **MAIN_MESH)
    chunked.train_steps(5)
    steps, _ = chunked.train_steps(TRAIN_BATCHES)
    if steps != TRAIN_BATCHES - 5 or not _bitwise_equal(chunked, whole):
        fail("DP=2xPP=4: train_steps in two chunks is not bitwise one epoch")
    # Adam with a binding clip (the flagship's gradient norm is ~0.048). At
    # lr 2e-4 this recipe is ill-conditioned on this split: on the CPU alone,
    # inputs perturbed by 1e-7 relative move the params 3.7e-4 after 4 steps
    # (the clip lifts Adam's eps to ~5e-8 against gradients of which a third
    # are below 1e-7). At lr 5e-5 the same perturbation moves them < 1e-7
    # (tests/test_torch_pipeline_session.py::test_adam_with_binding_clip_conditioning).
    adam = _side_run(
        TrainingSession, "DP=2xPP=4 adam+clip", 4, optimizer="adam", lr=5e-5,
        clip_norm=0.01, data_dir=data_dir, **MAIN_MESH,
    )
    # mlp-deep at PP=4: the B6/B8 shapes (2048 x 2048 slots) at full width
    deep = dict(model="mlp-deep", dp=1, pp=4, schedule="gpipe", kernel_backend="pallas")
    gpu = TrainingSession(device="cuda", data_dir=data_dir, **deep)
    init = gpu.params()
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    gpu.train_steps(2)
    deep_wall = time.perf_counter() - t0
    n_lin = len(gpu.spec.sizes) - 1
    if not cuda_ops.LAUNCHES["linear_flag_fwd"] == cuda_ops.LAUNCHES["linear_flag_bwd"] == 4 * n_lin * 2:
        fail(f"mlp-deep PP=4: {cuda_ops.LAUNCHES} launches, want 4 x {n_lin} x 2 per entry")
    cpu = TrainingSession(device="cpu", data_dir=data_dir, **deep)
    cpu.train_steps(2)
    deep_diff = _params_close(gpu, cpu, "mlp-deep PP=4")
    most = max(_moved(init, gpu, cpu))
    if most < MIN_MOVE:
        fail(f"mlp-deep PP=4: moved at most {most:.2f} x its allowed difference")
    for line in lines:
        say(line)
    say(
        f"phase 9b pipeline training: ok: {len(MESH_CONFIGS)} configs through the flag "
        f"kernels, launches exact, card vs CPU within {TRAIN_RTOL}/{TRAIN_ATOL} and vs "
        f"the card's sequential run within {SEQ_RTOL}/{SEQ_ATOL}; DP=2xPP=4 chunked "
        f"train_steps bitwise one epoch; 4 steps {adam}; mlp-deep PP=4 2 steps "
        f"({4 * n_lin * 2} launches per entry) card vs CPU {deep_diff:.3e}, largest move "
        f"{most:.2f}, wall {deep_wall * 1e3:.1f} ms"
    )
    return drive, rates


def phase_pipeline_predict(torch, cuda_ops, TrainingSession):
    """9c: predict on a DP=2xPP=4 session (the inference program through the
    flag forward) against the card's sequential predict and the CPU mesh
    path, on the same (initial) weights."""
    import numpy as np

    mesh = TrainingSession(device="cuda", **MAIN_MESH)
    x = np.random.RandomState(5).rand(3 * mesh.slot_rows * 16 + 5, FLAGSHIP[0]).astype(np.float32)
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    got = mesh.predict(x)
    launches = cuda_ops.LAUNCHES["linear_flag_fwd"]
    want = _eval_flag_launches(mesh, x.shape[0])
    if launches != want or cuda_ops.LAUNCHES["linear_act_fwd"]:
        fail(f"predict: {dict(cuda_ops.LAUNCHES)} launches, want {want} linear_flag_fwd")
    seq = TrainingSession(device="cuda").predict(x)
    cpu = TrainingSession(device="cpu", **MAIN_MESH).predict(x)
    d_seq = float(np.abs(got - seq).max())
    d_cpu = float(np.abs(got - cpu).max())
    if not np.isfinite(got).all() or max(d_seq, d_cpu) > 1e-6:
        fail(f"predict: card mesh vs sequential {d_seq}, vs CPU mesh {d_cpu} (> 1e-6)")
    say(
        f"phase 9c pipeline predict: ok: {x.shape[0]} rows, {launches} flag forward "
        f"launches; card mesh vs card sequential {d_seq:.3e}, vs CPU mesh {d_cpu:.3e}"
    )


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from shallowspeed_tpu_torch import _build, cuda_ops, resolve_device
        from shallowspeed_tpu_torch.api import TrainingSession
        from shallowspeed_tpu_torch.serving import engine as engine_mod
        from shallowspeed_tpu_torch.serving import loadgen
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of a checkout")
    phase_device(torch, resolve_device)
    phase_build(_build)
    slot, fwd_err = phase_kernels(torch, cuda_ops)
    phase_row_independence(torch, cuda_ops)
    mub, bwd_err = phase_bwd_kernels(torch, cuda_ops)
    fwd_err = max(fwd_err, phase_train_fwd(torch, cuda_ops))
    serving = phase_serving(torch, cuda_ops, TrainingSession, engine_mod, loadgen)
    phase_wide(torch, cuda_ops, TrainingSession)
    with tempfile.TemporaryDirectory() as tmp:
        write_split(Path(tmp), TRAIN_BATCHES * 128, VAL_ROWS)
        training = phase_training(torch, cuda_ops, TrainingSession, tmp)
        phase_wide_training(torch, cuda_ops, TrainingSession, tmp)
        fused = phase_fused_kernels(torch, cuda_ops, tmp)
        fused_launches = phase_fused_training(torch, cuda_ops, TrainingSession, tmp)
        flag_sums, flag_errs, checked = phase_flag_kernels(torch, cuda_ops)
        seen = set()
        with flag_shapes_seen(cuda_ops, seen):
            flag_launches, _ = phase_pipeline_training(torch, cuda_ops, TrainingSession, tmp)
            phase_pipeline_predict(torch, cuda_ops, TrainingSession)
        if not seen or seen - checked:
            fail(f"phases 9b/9c launched flag entries at shapes 9a did not check: {sorted(seen - checked)}")
        say(f"phase 9 shapes: ok: every one of the {len(seen)} (rows, K, N, flag) 9b and 9c launched was checked in 9a")
    entries = [
        ("linear_act_fwd", "linear_act_fwd", serving["linear_act_fwd"], fwd_err, slot),
        ("linear_act_bwd", "linear_act_bwd", training["linear_act_bwd"], bwd_err, mub),
    ]
    for mode in FUSED_MODES:
        # no single PyTorch call computes a training step
        t = dict(fused[mode], library_ms=None)
        entries.append((f"fused_train:{mode}", "fused_train", fused_launches[mode], t["max_abs_err"], t))
    for entry in ("linear_flag_fwd", "linear_flag_bwd"):
        entries.append((entry, entry, flag_launches[entry], flag_errs[entry], flag_sums[entry]))
    kernels = []
    for name, source_name, launches, err, t in entries:
        kernels.append(
            dict(
                name=name,
                **KERNELS[source_name],
                launches=launches,
                max_abs_err=err,
                ms=t["ms"],
                plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"],
                bound_by=t["bound_by"],
                library_ms=t["library_ms"],
            )
        )
    say(json.dumps({"kernels": kernels}))
    say(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
