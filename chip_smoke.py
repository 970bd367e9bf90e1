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
   calls), and the bound max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s fp32);
3b. the backward kernel vs its plain version at the training path's
   shapes — every flagship relu layer and mlp-deep's layers at 32 rows (a
   microbatch) and 128 (fused microbatches), and a ragged shape with the
   activation off and on: dx, dW and db within ``rtol=1e-5,
   atol=1e-5*ceil(L/784)`` for a reduction of length L, a NaN or Inf in
   ``g`` at a masked position poisoning exactly what it poisons in the
   plain version, two launches bitwise equal; then the times as in phase 3
   (the yardstick: ``torch.mm(ge, W)`` + ``torch.mm(ge.T, x)`` +
   ``ge.sum(0)``) and the bound max(bytes / 3.35 TB/s, 4*M*N*K / 67
   TFLOP/s); then the forward kernel, with phase 3's checks and times, at
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
   CPU path, with the same least move.

Times come from CUDA events around a CUDA graph of repeated launches, so
they are device times without the host's launch overhead, with the
operands warm in L2 (a slot's weights are re-read by every request).

The last two lines are JSON: the kernels (for each: ``launches`` over its
path's drive — the serving drive of phase 4 for the forward, the training
drive of phase 6 for the backward; ``ms``/``plain_ms``/``library_ms``/
``bound_ms`` summed over one flagship slot's six relu layers at 8 rows for
the forward and one flagship microbatch's at 32 rows for the backward;
``max_abs_err`` over every shape of phase 3 or 3b), then ``{"ok": true,
"device": {...}}``. Any failure exits non-zero before either; so does a
machine without CUDA, or a directory without the package.
"""

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
}


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
    t0 = time.perf_counter()
    logs = build.build_all(list(KERNELS))
    secs = time.perf_counter() - t0
    regs = []
    for name in KERNELS:
        for line in (logs.get(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                regs.append(f"{name}: {line.strip()}")
    say(
        f"phase 2 build: ok: {len(KERNELS)} kernel(s) in {secs:.2f} s "
        f"({len(logs)} compiled, {len(KERNELS) - len(logs)} already built)"
    )
    for line in regs:
        say(f"  {line}")


FWD_HEADER = (
    "  rows     K     N relu  tag        max_abs_err   kernel_ms    "
    "plain_ms    addmm_ms    bound_ms  bound_by"
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
        f"{ms:11.5f} {plain:11.5f} {lib:11.5f} {bnd:11.5f}  {by}"
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
        "plain_ms  3-call_ms    bound_ms  bound_by"
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
            f"{ms:11.5f} {plain:11.5f} {lib:11.5f} {bnd:11.5f}  {by}"
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


def phase_training(torch, cuda_ops, TrainingSession, data_dir):
    """The training main path. Returns the launch counts of the drive alone."""
    B, M = 128, 4
    relu_layers = len(FLAGSHIP) - 2
    steps = 2 * TRAIN_BATCHES
    kw = dict(data_dir=data_dir)

    def drive(device, with_eval=True):
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

    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    gpu, init, losses, accs, walls = drive("cuda")
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
    cpu, _, closs, caccs, _ = drive("cpu")
    for e, (a, b) in enumerate(zip(losses, closs)):
        if not (math.isfinite(a) and abs(a - b) <= TRAIN_ATOL + TRAIN_RTOL * abs(b)):
            fail(f"training: epoch {e} loss {a} on the card, {b} on the CPU")
    # the whole run moves the loss by less than the tolerance above, so
    # the drop itself is held to the CPU's
    drop, cdrop = losses[0] - losses[1], closs[0] - closs[1]
    if not (cdrop > 0 and abs(drop - cdrop) <= LOSS_DROP_RTOL * cdrop):
        fail(f"training: the loss fell {drop} on the card, {cdrop} on the CPU")
    if any(abs(a - b) * n_val > 1.0 + 1e-9 for a, b in zip(accs, caccs)):
        fail(f"training: accuracies {accs} on the card, {caccs} on the CPU")
    worst = _params_close(gpu, cpu, "training")
    moved = _moved(init, gpu, cpu)
    if min(moved) < MIN_MOVE:
        fail(
            f"training: a leaf moved at most {min(moved):.2f} x its allowed "
            f"card-vs-CPU difference, want >= {MIN_MOVE}"
        )
    again, _, losses2, _, _ = drive("cuda", with_eval=False)
    if losses2 != losses or not _bitwise_equal(gpu, again):
        fail("training: a second card run is not bitwise equal to the first")
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

    def side_run(label, steps, **opts):
        """A card and a CPU session from init, ``steps`` steps each: params
        within tolerance, and the run moved some leaf >= MIN_MOVE units."""
        pair = [TrainingSession(device=d, **opts, **kw) for d in ("cuda", "cpu")]
        init = pair[0].params()
        for s in pair:
            s.train_steps(steps)
        diff = _params_close(*pair, label)
        most = max(_moved(init, *pair))
        if most < MIN_MOVE:
            fail(f"{label}: moved at most {most:.2f} x its allowed difference")
        return f"{label} {diff:.3e} (moved {most:.2f})"

    torch.cuda.synchronize()
    before = cuda_ops.LAUNCHES["linear_act_bwd"]
    fused = side_run("fused epoch", TRAIN_BATCHES, fuse_mubatches=True)
    n_fused = cuda_ops.LAUNCHES["linear_act_bwd"] - before
    if n_fused != relu_layers * TRAIN_BATCHES:
        fail(f"fused: {n_fused} backward launches, want {relu_layers} x {TRAIN_BATCHES}")
    stateful = [
        side_run(opt, 4, optimizer=opt, lr=lr)
        for opt, lr in (("momentum", 0.006), ("adam", 2e-4))
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
    mub, bwd_err = phase_bwd_kernels(torch, cuda_ops)
    fwd_err = max(fwd_err, phase_train_fwd(torch, cuda_ops))
    serving = phase_serving(torch, cuda_ops, TrainingSession, engine_mod, loadgen)
    phase_wide(torch, cuda_ops, TrainingSession)
    with tempfile.TemporaryDirectory() as tmp:
        write_split(Path(tmp), TRAIN_BATCHES * 128, VAL_ROWS)
        training = phase_training(torch, cuda_ops, TrainingSession, tmp)
        phase_wide_training(torch, cuda_ops, TrainingSession, tmp)
    per_kernel = {
        "linear_act_fwd": (serving["linear_act_fwd"], fwd_err, slot),
        "linear_act_bwd": (training["linear_act_bwd"], bwd_err, mub),
    }
    kernels = []
    for name, meta in KERNELS.items():
        launches, err, t = per_kernel[name]
        kernels.append(
            dict(
                name=name,
                **meta,
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
