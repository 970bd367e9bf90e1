"""One run of one cell: set-up, the measured window, the traced stretch and
the check.

``Bench`` reads ``BENCHMARK.json`` and finds each cell's files by name
(``configs/``, ``traffic/``, ``workloads/``), its configuration's model
family (``families/``) and each per-layer metric's file (``metrics/``) and
reader (``readers/``). Everything that depends on the model's structure
goes through the family. ``run`` drives the port:

1. Set-up: the weights and the split from the seed (``work/inputs.py``),
   the split written under ``$TMPDIR`` for the session's ``data_dir``, a
   ``shallowspeed_tpu_torch.TrainingSession`` on the device, the seed's
   weights swapped in with ``load_weights``; then the checked steps, three
   calls of ``train_steps(1)`` whose states the check reads, and, where a
   call of the window trains more than one step, the rest of the first
   epoch in the window's calls, whose mean loss the check reads; then one
   warm-up call of the
   window's chunk. ``setup_s`` runs from the process's start to the end of
   warm-up, less the time spent copying the checked states to the host.
2. The window: ``train_steps(chunk_steps)`` again and again until
   ``seconds`` have passed, whole calls only. ``train_steps`` returns after
   the loss reached the host, so each call's wall holds its device work.
3. With ``trace``: ``trace_chunks`` more calls under ``torch.profiler``
   tracing the device alone, which the per-layer readers read, and as many
   tracing the host too, which name the breakdown's idle gaps.
4. The port's session is freed, and the family's reference
   (``reference/``) trains the same steps from the seed's weights on the
   same split; the numbers of ``check.py`` against the cell's limits decide
   ``correct``.
"""

import functools
import gc
import importlib.util
import json
import os
import re
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

from portbench import check, families
from portbench.work import bounds, inputs, trace

ROOT = Path(__file__).resolve().parent.parent
STRETCH = "portbench.stretch"  # the record_function around the host-traced stretch
MARK = "spin_kernel"  # the kernel of torch.cuda._sleep, which marks the device-traced stretch
MARK_CYCLES = 1000
CHECK_STEPS = 3  # the steps the reference follows
FORBIDDEN = ("jax", "jaxlib", "flax", "shallowspeed_tpu")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def process_age_s():
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def _load(path):
    with open(path) as f:
        return json.load(f)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p95(values):
    """The 95th percentile, as ``statistics.quantiles(n=20)`` places it."""
    return statistics.quantiles(values, n=20)[-1] if len(values) > 1 else values[0]


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = _load(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.end_to_end = {m["name"]: m for m in self.spec["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.spec["per_layer"]}

    def path(self, *parts):
        return self.root / "portbench" / Path(*parts)

    def cell(self, name):
        """The cell ``name``: its entry with its config, traffic and cell
        files read, and its configuration's family module."""
        if name not in self.cells:
            raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(self.cells)}")
        entry = self.cells[name]
        config = self.config(entry["config"])
        return {
            "entry": entry,
            "config": config,
            "traffic": _load(self.path("traffic", f"{entry['traffic']}.json")),
            "cell": _load(self.path("workloads", f"{name}.json")),
            "family": self.family(family_of(config)),
        }

    def config(self, name):
        return _load(self.root / self.configs[name]["file"])

    def reports(self, metric, cell):
        """Whether ``cell`` reports the metric ``metric`` (a BENCHMARK.json
        entry)."""
        if "workloads" in metric:
            return cell in metric["workloads"]
        moves = metric.get("moves")
        return moves is None or self.reports(self.end_to_end[moves], cell)

    def end_to_end_of(self, cell):
        return [m for m in self.end_to_end.values() if self.reports(m, cell)]

    def per_layer_of(self, cell):
        return [m for m in self.per_layer.values() if self.reports(m, cell)]

    def metric_file(self, name):
        return _load(self.path("metrics", f"{name}.json"))

    def reader(self, name):
        """The module ``readers/<name>.py``."""
        return _module(f"portbench.readers.{name}", self.path("readers", f"{name}.py"))

    def family(self, name):
        """The module ``families/<name>.py``."""
        return _module(f"portbench.families.{name}", self.path("families", f"{name}.py"))

    def family_problems(self, config):
        """What is wrong with the family of the configuration ``config``
        (a name in ``BENCHMARK.json``), as strings (none: [])."""
        try:
            name = family_of(self.config(config))
        except (OSError, ValueError) as e:
            return [f"config {config}: {e!r}"]
        if not NAME.match(name):
            return [f"config {config}: bad family name {name!r}"]
        if not self.path("families", f"{name}.py").is_file():
            return [f"config {config}: no family file families/{name}.py"]
        try:
            mod = self.family(name)
        except Exception as e:  # noqa: BLE001 — named as a problem, whatever the file raises
            return [f"config {config}: family {name} does not load: {e!r}"]
        return [
            f"config {config}: family {name} lacks {f}()" for f in families.FUNCTIONS
            if not callable(getattr(mod, f, None))
        ]

    def validate(self):
        """Problems with the benchmark's files, as strings (none: [])."""
        bad = []
        named = (
            list(self.configs) + list(self.cells) + list(self.end_to_end) + list(self.per_layer)
        )
        for c in self.configs.values():
            named += c["reduced"]
        for w in self.cells.values():
            named += [w["config"], w["traffic"]]
        bad += [f"bad name {n!r}" for n in named if not NAME.match(n)]
        for m in list(self.end_to_end.values()) + list(self.per_layer.values()):
            if not UNIT.match(m["unit"]):
                bad.append(f"bad unit {m['unit']!r} of {m['name']}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"{m['name']}: better is {m['better']!r}")
            bad += [
                f"{m['name']} names unknown cell {w}" for w in m.get("workloads", ())
                if w not in self.cells
            ]
        broken = set()
        for name in self.configs:
            problems = self.family_problems(name)
            bad += problems
            if problems:
                broken.add(name)
        for name, w in self.cells.items():
            if w["config"] in broken:
                continue
            try:
                cell = self.cell(name)
                cell["family"].check_traffic(cell["config"], cell["traffic"])
            except (OSError, KeyError, ValueError) as e:
                bad.append(f"{name}: {e!r}")
                continue
            t = cell["traffic"]
            if t["global_batch_size"] % t["mubatches"]:
                bad.append(f"{name}: mubatches do not divide the batch")
            if t["train_rows"] // t["global_batch_size"] <= CHECK_STEPS:
                bad.append(f"{name}: an epoch must be longer than the checked steps")
            kinds = {m["name"] for m in self.end_to_end_of(name)}
            if "setup_s" not in kinds or len(kinds) < 2:
                bad.append(f"{name}: reports {sorted(kinds)}")
            if not self.per_layer_of(name):
                bad.append(f"{name}: reports no per-layer metric")
        for name, m in self.per_layer.items():
            if m["moves"] not in self.end_to_end:
                bad.append(f"{name} moves unknown {m['moves']!r}")
            try:
                spec = self.metric_file(name)
                self.reader(spec["reader"])
            except (OSError, KeyError, ValueError, ImportError) as e:
                bad.append(f"{name}: {e!r}")
        return bad


def family_of(config):
    """The name of the model family of a configuration file's contents."""
    return config.get("family", families.DEFAULT)


def plant(session, fault, cell):
    """Break the program under the session, for the check's own tests:
    ``"half_batch"`` copies each batch's first half over its second, so
    every step takes the mean over half its rows; ``"stale_state"`` puts
    back, after every call, the weights the call started from."""
    if fault == "half_batch":
        for t in (session._X, session._Y):
            flat = t.view(t.shape[0], -1, t.shape[-1])
            half = flat.shape[1] // 2
            flat[:, half:] = flat[:, :half]
    elif fault == "stale_state":
        dispatch, fam = session._dispatch, cell["family"]

        def stale(k0, k1):
            before = fam.state(session)
            out = dispatch(k0, k1)
            verified = fam.checkpoint(cell["config"], cell["traffic"], before)
            session.load_weights("stale-state.npz", verified=verified)
            return out

        session._dispatch = stale
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def first_steps(session, chunk_steps, state):
    """Train the checked steps and read them: ``({"p1", "p3",
    "epoch_loss"}, seconds spent copying states to the host)``. Each
    checked step is one ``train_steps(1)``, and the state after the first
    and after the last is read (``state(session)``, the family's). Where the
    window's call trains more than one step, the rest of the first epoch is
    trained in such calls, and the mean loss the epoch's last call returns
    is read."""
    copy_s, read = 0.0, {}
    for k in range(CHECK_STEPS):
        session.train_steps(1)
        if k in (0, CHECK_STEPS - 1):
            t0 = time.perf_counter()
            read[f"p{k + 1}"] = state(session)
            copy_s += time.perf_counter() - t0
    epoch_loss = None
    if chunk_steps > 1:
        while epoch_loss is None:
            _, epoch_loss = session.train_steps(chunk_steps)
    return dict(epoch_loss=epoch_loss, **read), copy_s


def reference_steps(fam, weights, split_dir, traffic, cfg, steps, device, tf32=False):
    """The reference's readings of the first ``steps`` steps (its state
    after the first and after the checked steps, and its mean loss over them
    when ``steps`` covers more than the checked steps), trained by the
    family ``fam``'s reference from ``weights`` on the split the session
    read."""
    import numpy as np
    import torch

    from portbench.reference import mlp

    B = traffic["global_batch_size"]
    x = np.load(split_dir / "x_train.npy", mmap_mode="r")
    y = np.load(split_dir / "y_train.npy", mmap_mode="r")
    ref = fam.reference(weights, cfg, traffic)
    losses, read = [], {}
    with mlp.matmul_precision(tf32):
        for k in range(steps):
            xb = torch.from_numpy(np.array(x[k * B : (k + 1) * B])).to(device)
            yb = torch.from_numpy(np.array(y[k * B : (k + 1) * B])).to(device)
            losses.append(ref.step(xb, yb))
            if k in (0, CHECK_STEPS - 1):
                read[f"p{k + 1}"] = [t.clone() for t in ref.leaves()]
    return dict(
        epoch_loss=sum(losses) / steps if steps > CHECK_STEPS else None,
        **read,
    )


def _profiled(session, chunk_steps, n_chunks, host):
    """The trace of ``n_chunks`` calls of the window's chunk under
    ``torch.profiler``, of the device alone or, with ``host``, of the host
    too, and each call's steps. One call first lets the profiler settle;
    then the calls run inside the host span ``STRETCH``, between two marker
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    steps = []
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        session.train_steps(chunk_steps)
        torch.cuda._sleep(MARK_CYCLES)
        with record_function(STRETCH):
            for _ in range(n_chunks):
                steps.append(session.train_steps(chunk_steps)[0])
        torch.cuda._sleep(MARK_CYCLES)
        if session.device.type == "cuda":
            # the second marker ends on the device before the profiler stops,
            # so that the trace always holds it
            torch.cuda.synchronize(session.device)
    return prof.events(), steps


def traced_stretch(session, chunk_steps, n_chunks):
    """Two traced stretches of ``n_chunks`` calls each. The metrics read the
    first, a trace of the device alone, so that tracing the host slows the
    calls less: it runs from the end of the first marker kernel to the start
    of the second and so holds each call whole, its host time included.
    The breakdown's idle gaps are named from the second, a trace of the host
    too, over the host span ``STRETCH``. Returns the first's steps, each
    call's steps, its length, its device operations and their busy time, and
    the second's idle gaps and idle share."""
    events, steps = _profiled(session, chunk_steps, n_chunks, host=False)
    s, e = trace.marked_window(events, MARK)
    gpu = trace.gpu_events(events, (s, e), labels=(STRETCH,))
    events, _ = _profiled(session, chunk_steps, n_chunks, host=True)
    hs, he, thread = trace.span_of(events, STRETCH)
    host_gpu = trace.gpu_events(events, (hs, he), labels=(STRETCH,))
    host = trace.host_events(events, (hs, he), thread)
    return {
        "steps": sum(steps),
        "chunk_steps": steps,
        "seconds": 1e-6 * (e - s),
        "gpu": gpu,
        "busy_s": 1e-6 * trace.union_us([(a, b) for _, a, b in gpu]),
        "idle_gaps": trace.idle_gaps(host_gpu, (hs, he), host, skip=(STRETCH,)),
        "host_traced_idle": 1.0 - trace.union_us([(a, b) for _, a, b in host_gpu]) / (he - hs),
    }


def _short(name, n=96):
    return name if len(name) <= n else name[: n - 3] + "..."


def prepare(bench, name, seed, device, tmp, fault=None):
    """Set-up up to the window's warm-up: the seed's inputs, the session
    with the seed's weights, the checked steps. Returns ``(cell, session,
    readings, copy_s, phases)``, ``phases`` the process's age in seconds at
    the end of each part of set-up."""
    import torch

    from shallowspeed_tpu_torch import TrainingSession

    phases = {"imports": process_age_s()}
    cell = bench.cell(name)
    cfg, traffic, fam = cell["config"], cell["traffic"], cell["family"]
    fam.check_traffic(cfg, traffic)
    draw = functools.partial(fam.draw_weights, cfg)
    weights, split = inputs.make_inputs(draw, traffic, seed, torch.device(device))
    inputs.write_split(tmp, split)
    del split
    verified = fam.checkpoint(cfg, traffic, [t.cpu().numpy() for t in fam.leaves(weights)])
    del weights
    phases["inputs"] = process_age_s()
    session = TrainingSession(
        data_dir=str(tmp), device=device, **fam.session_kwargs(cfg, traffic)
    )
    phases["session"] = process_age_s()
    session.load_weights(tmp / "seed-weights.npz", verified=verified)
    del verified
    phases["load_weights"] = process_age_s()
    plant(session, fault, cell)
    readings, copy_s = first_steps(session, traffic["chunk_steps"], fam.state)
    phases["checked_steps"] = process_age_s()
    return cell, session, readings, copy_s, phases


def free(device):
    """Let go of what a freed session held on ``device``."""
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(cell, seed, tmp, device, tf32=False):
    """``(p0, readings)``: the seed's weights drawn again and the
    reference's readings over the steps the check compares (the first
    epoch where a call of the window trains more than one step)."""
    import torch

    cfg, traffic, fam = cell["config"], cell["traffic"], cell["family"]
    dev = torch.device(device)
    p0 = inputs.weights_again(functools.partial(fam.draw_weights, cfg), seed, dev)
    steps = CHECK_STEPS
    if traffic["chunk_steps"] > 1:
        steps = traffic["train_rows"] // traffic["global_batch_size"]
    return p0, reference_steps(fam, p0, tmp, traffic, cfg, steps, dev, tf32=tf32)


def numbers_of(cell, p0, prog, ref, device):
    import torch

    z0 = cell["family"].leaves(p0)
    return check.compare(z0, prog, ref, cell["config"]["lr"], torch.device(device))


def run(bench, name, seed, seconds, trace_on, device="cuda", fault=None, log=sys.stderr):
    """One run of the cell ``name``; returns the result's object. ``fault``
    breaks the program (``plant``) for the check's own tests."""
    import torch

    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        cell, session, prog, copy_s, phases = prepare(bench, name, seed, device, tmp, fault)
        cfg, traffic, cfile = cell["config"], cell["traffic"], cell["cell"]
        chunk = traffic["chunk_steps"]
        session.train_steps(chunk)  # warm-up: the window's call
        if is_cuda:
            torch.cuda.synchronize(dev)
        phases["warm_up"] = process_age_s()
        setup_s = phases["warm_up"] - copy_s
        log.write(f"portbench: set-up phases (s of process age) {json.dumps(phases)}, "
                  f"state copies {copy_s!r} s\n")

        if is_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        walls, steps = [], 0
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            n, _ = session.train_steps(chunk)
            c1 = time.perf_counter()
            walls.append(c1 - c0)
            steps += n
            if c1 - t0 >= seconds:
                break
        window_s = c1 - t0
        peak = torch.cuda.max_memory_allocated(dev) if is_cuda else 0
        samples_per_s = steps * traffic["global_batch_size"] / window_s

        device_rec = {
            "platform": "gpu" if is_cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if is_cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        }
        metrics, breakdown = {}, None
        if trace_on:
            stretch = traced_stretch(session, chunk, cfile["trace_chunks"])
            ctx = {
                "config": cfg, "traffic": traffic, "cell": cfile,
                "family": cell["family"], "session": session,
                "peaks": bounds.peaks_of(device_rec["kind"]),
                "window": {"samples_per_s": samples_per_s, "seconds": window_s, "steps": steps},
                "stretch": stretch,
            }
            for m in bench.per_layer_of(name):
                spec = bench.metric_file(m["name"])
                value = bench.reader(spec["reader"]).read(ctx, spec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_rec["busy_s"] = stretch["busy_s"]
            device_rec["window_s"] = stretch["seconds"]
            breakdown = {
                "device_ops": [[_short(n), s] for n, s in trace.top_ops(stretch["gpu"])[:10]],
                "idle_gaps": [[_short(n), s] for n, s in stretch["idle_gaps"]],
            }
            # the traced stretches' own idle shares, beside device.idle_pct
            log.write(f"portbench: idle share of the stretch, device traced alone "
                      f"{1.0 - stretch['busy_s'] / stretch['seconds']!r}, host traced too "
                      f"{stretch['host_traced_idle']!r}\n")
            del stretch, ctx
        else:
            e2e = {
                "train_samples_per_s": (samples_per_s, "samples/s"),
                "chunk_ms_p95": (1e3 * p95(walls), "ms"),
                "setup_s": (setup_s, "s"),
            }
            for m in bench.end_to_end_of(name):
                value, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}

        del session
        free(dev)
        p0, ref = reference_readings(cell, seed, tmp, dev)
        numbers = numbers_of(cell, p0, prog, ref, dev)
        correct, checks = check.judge(numbers, cfile["limits"])
        log.write(f"portbench: {name} seed {seed}: numbers {json.dumps(numbers)}\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    result = {
        "correct": correct,
        "attempted": len(walls),
        "failed": 0,
        "metrics": metrics,
        "device": device_rec,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
