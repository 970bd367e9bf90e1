#!/usr/bin/env python3
"""One cold or cache-warm start of the port on a GPU, in a process of its
own: the child that ``chip_smoke.py`` phase 20 (and
``scripts/torch_aot_phase.py``) runs from a fresh copy of the package.

    python3 <dir>/torch_aot_child.py breakdown --data-dir D --t0 T
    python3 <dir>/torch_aot_child.py start --data-dir D --cache C --t0 T

Copy this script beside a copy of ``shallowspeed_tpu_torch/`` in ``<dir>``
and run it from there: it imports that copy, whose ``build/`` (``<dir>/build``)
starts empty, so its kernels are built with ``nvcc`` or written from the AOT
cache, never taken from the checkout's build. ``T`` is the parent's
``time.perf_counter()`` just before it started this process (the clock is
the system's monotonic clock, shared by both). The last line of the
standard output is one JSON object.

``breakdown`` splits a cold start (phase 20a): ``import torch`` and the
package; the CUDA context (the first allocation and synchronisation); every
kernel's ``nvcc`` build, all at once (each one's wall and the whole), then
``_build.load`` of each with the library built (dlopen only); the lowering
and static analysis of the DP=2xPP=4 GPipe training program, of each rung
of the flagship ladder's inference programs and of the MPMD stage plan; the
warm-up (a sequential serving replica's 31-slot ladder, the first epoch of
a sequential and a DP=2xPP=4 trainer beside their second); and the audit
probe of an epoch program.

``start`` is a cache-configured start (phases 20b-20d): it serves the
flagship rung ladder and 64 seeded rows from the deterministic init, then
trains one sequential epoch and one DP=2xPP=4 GPipe epoch through the flag
kernels, every session with ``aot_cache_dir=C``. It reports its ``nvcc``
builds, the cache's counts, the hashes of its predictions and of both
trainers' params, its kernel launches, and the time from the parent's
start of the process to its first prediction.
"""

import time

T_MAIN = time.perf_counter()

import argparse  # noqa: E402 — the interpreter's start is stamped first
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

SOURCES = ("linear_act_fwd", "linear_act_bwd", "fused_train")
FLAG_KERNELS = dict(dp=2, pp=4, schedule="gpipe", kernel_backend="pallas")
SERVE_ROWS = 64
SEED = 0


def _imports(stamps):
    t = time.perf_counter()
    import torch

    stamps["import_torch_s"] = time.perf_counter() - t
    t = time.perf_counter()
    from shallowspeed_tpu_torch import api  # noqa: F401
    from shallowspeed_tpu_torch.serving import engine  # noqa: F401

    stamps["import_package_s"] = time.perf_counter() - t
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this child needs a GPU")
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    stamps["cuda_context_s"] = time.perf_counter() - t
    return torch


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def breakdown(args):
    stamps = {"spawn_to_main_s": T_MAIN - args.t0}
    torch = _imports(stamps)
    from shallowspeed_tpu_torch import _build, schedules as S
    from shallowspeed_tpu_torch.analysis import analyze_program
    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.model import make_model_spec
    from shallowspeed_tpu_torch.optimizer import make_optimizer
    from shallowspeed_tpu_torch.parallel import mpmd
    from shallowspeed_tpu_torch.parallel.lowering import lower_schedule
    from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh
    from shallowspeed_tpu_torch.serving.engine import ServingEngine
    from shallowspeed_tpu_torch.serving.slots import DEFAULT_SLOT_LADDER

    if any(_build.library_path(n).exists() for n in SOURCES):
        raise SystemExit(f"{_build.BUILD_DIR} is not empty: run from a fresh copy")
    _, stamps["build_all_wall_s"] = _timed(lambda: _build.build_all(SOURCES))
    stamps["build_s"] = dict(_build.BUILD_WALL_S)
    stamps["load_built_s"] = {}
    for name in SOURCES:
        _, stamps["load_built_s"][name] = _timed(lambda: _build.load(name))

    lowering = {}
    prog, lowering["train_dp2pp4_lower_s"] = _timed(
        lambda: lower_schedule(S.SCHEDULES["gpipe"], 4, 4))
    _, lowering["train_dp2pp4_analyze_s"] = _timed(
        lambda: analyze_program(prog, program="epoch_program"))
    for rung in DEFAULT_SLOT_LADDER:
        inf, lowering[f"inference_r{rung}_lower_s"] = _timed(
            lambda: lower_schedule(S.InferenceSchedule, rung, 4, training=False))
        _, lowering[f"inference_r{rung}_analyze_s"] = _timed(
            lambda: analyze_program(inf, program=f"inference_r{rung}"))
    spec = make_model_spec((784, 128, 127, 126, 125, 124, 123, 10), 4, 128)
    mesh = VirtualMesh(2, 4, torch.device("cuda"))
    _, lowering["mpmd_stage_plan_s"] = _timed(
        lambda: mpmd.MpmdTrainRunner(mesh, spec, prog, 16, make_optimizer("sgd", 0.006, 0.9, 0.0)))
    stamps["lowering"] = lowering

    warm = {}
    serve, warm["serve_session_s"] = _timed(lambda: TrainingSession(device="cuda"))
    engine = ServingEngine(serve)
    _, warm["serve_ladder_31_slots_s"] = _timed(engine.warm_ladder)
    warm["serve_ladder_slots"] = sum(DEFAULT_SLOT_LADDER)
    for label, kw in (("seq", {}), ("dp2pp4", FLAG_KERNELS)):
        s, warm[f"{label}_session_s"] = _timed(
            lambda: TrainingSession(device="cuda", data_dir=args.data_dir, **kw))
        _, warm[f"{label}_first_epoch_s"] = _timed(lambda: s.train_epoch())
        torch.cuda.synchronize()
        _, warm[f"{label}_second_epoch_s"] = _timed(lambda: s.train_epoch())
    stamps["warm_up"] = warm

    probe = {}
    for label, kw in (("seq", {}), ("dp2pp4", FLAG_KERNELS)):
        s = TrainingSession(device="cuda", data_dir=args.data_dir, audit=True, **kw)
        s.train_epoch()  # the library loads and first launches land here
        s._audit_done.clear()
        _, probe[f"{label}_audited_epoch_s"] = _timed(lambda: s.train_epoch())
        _, probe[f"{label}_plain_epoch_s"] = _timed(lambda: s.train_epoch())
    stamps["audit_probe"] = probe
    stamps["builds"] = dict(_build.BUILDS)
    return stamps


def _digest(a):
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def start(args):
    import numpy as np

    stamps = {"spawn_to_main_s": T_MAIN - args.t0}
    torch = _imports(stamps)
    from shallowspeed_tpu_torch import _build, cuda_ops
    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.serving.engine import ServingEngine

    cuda_ops.reset_launches()
    aot = {}

    def counts(s):
        for k, v in s._aot.counts.items():
            aot[k] = aot.get(k, 0) + v

    t = time.perf_counter()
    serve = TrainingSession(device="cuda", aot_cache_dir=args.cache)
    ServingEngine(serve).warm_ladder()
    x = np.random.RandomState(SEED).rand(SERVE_ROWS, 784).astype(np.float32)
    preds = serve.predict(x)
    t_first = time.perf_counter()
    stamps["serve_s"] = t_first - t
    stamps["start_to_first_result_s"] = t_first - args.t0
    counts(serve)
    hashes = {"predictions": _digest(preds)}
    for label, kw in (("seq", {}), ("dp2pp4", FLAG_KERNELS)):
        t = time.perf_counter()
        s = TrainingSession(device="cuda", data_dir=args.data_dir, aot_cache_dir=args.cache, **kw)
        s.train_epoch()
        torch.cuda.synchronize()
        stamps[f"{label}_epoch_s"] = time.perf_counter() - t
        hashes[label] = s.model_hash()
        counts(s)
    stamps["total_s"] = time.perf_counter() - args.t0
    return dict(
        stamps, hashes=hashes, aot=aot, builds=dict(_build.BUILDS),
        launches=dict(cuda_ops.LAUNCHES), device=torch.cuda.get_device_name(0),
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["breakdown", "start"])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--t0", type=float, required=True)
    args = ap.parse_args()
    if args.mode == "start" and args.cache is None:
        ap.error("start needs --cache")
    out = breakdown(args) if args.mode == "breakdown" else start(args)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
