#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It drives the port's main path — the
flagship MLP served through ``shallowspeed_tpu_torch`` — and holds every
CUDA kernel of that path against its plain PyTorch version, in phases:

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
4. serving (the main path): ``TrainingSession()`` -> ``ServingEngine`` ->
   ``run_open_loop`` over 200 seeded requests of 1-8 rows: 200/200 "ok",
   every response bitwise equal to a direct ``predict()``, the kernel's
   launch count over the drive alone equal to 6 x slots dispatched, and
   the first 64 responses within 1e-6 of the port's CPU plain path;
5. wide model: ``TrainingSession(model="mlp-deep")`` predicting 16 slots
   against the CPU plain path (1e-5), 22 launches per slot.

Times come from CUDA events around a CUDA graph of repeated launches, so
they are device times without the host's launch overhead, with the
operands warm in L2 (a slot's weights are re-read by every request).

The last two lines are JSON: the kernels (for each: ``launches`` over
phase 4; ``ms``/``plain_ms``/``library_ms``/``bound_ms`` summed over one
flagship slot's six relu layers at 8 rows; ``max_abs_err`` over every
shape of phase 3), then ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before either; so does a machine without CUDA, or a
directory without the package.
"""

import json
import math
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
MLP_DEEP_SHAPES = ((784, 2048), (2048, 2048))  # (K, N) of its relu layers
SLOT_ROWS = 8
WIDE_ROWS = 128

KERNELS = {
    "linear_act_fwd": dict(
        route="cuda",
        source="shallowspeed_tpu_torch/csrc/linear_act_fwd.cu",
        replaces="shallowspeed_tpu/pallas_ops.py:132",
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
    say(
        "  rows     K     N relu  tag        max_abs_err   kernel_ms    "
        "plain_ms    addmm_ms    bound_ms  bound_by"
    )
    for rows, k, n, relu, tag in shapes:
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
        max_err = max(max_err, err)
        if not torch.allclose(y, y_ref, rtol=1e-5, atol=atol):
            fail(f"y of {rows}x{k}->{n} relu={relu}: max |err| {err} > tolerance")
        stable = z.abs() > 1e-5
        if not torch.equal(mask[stable], mask_ref[stable]):
            fail(f"mask of {rows}x{k}->{n} relu={relu} differs where |z| > 1e-5")
        if not (torch.equal(y, y2) and torch.equal(mask, mask2)):
            fail(f"two launches of {rows}x{k}->{n} differ")
        ms = device_ms(torch, lambda: cuda_ops.linear_act_fwd(x, w, b, relu))
        plain = device_ms(
            torch, lambda: cuda_ops.linear_act_fwd_reference(x, w, b, relu)
        )
        lib = device_ms(torch, lambda: torch.addmm(b, x, w.T))
        bnd, by = bound_ms(rows, k, n)
        say(
            f"  {rows:4d} {k:5d} {n:5d} {relu:4d}  {tag:9s} {err:12.3e} "
            f"{ms:11.5f} {plain:11.5f} {lib:11.5f} {bnd:11.5f}  {by}"
        )
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
    slot, max_err = phase_kernels(torch, cuda_ops)
    launches = phase_serving(torch, cuda_ops, TrainingSession, engine_mod, loadgen)
    phase_wide(torch, cuda_ops, TrainingSession)
    kernels = [
        dict(
            name=name,
            **meta,
            launches=launches[name],
            max_abs_err=max_err,
            ms=slot["ms"],
            plain_ms=slot["plain_ms"],
            bound_ms=slot["bound_ms"],
            bound_by=slot["bound_by"],
            library_ms=slot["library_ms"],
        )
        for name, meta in KERNELS.items()
    ]
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
