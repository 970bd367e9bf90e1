"""High-level API: a subset of ``shallowspeed_tpu.api.TrainingSession``.

    from shallowspeed_tpu_torch.api import TrainingSession

    run = TrainingSession(data_dir="data/mnist_784")   # flagship MLP on the GPU
    for _ in range(20):
        loss = run.train_epoch()
        print(run.epoch, loss, run.accuracy())
    probs = run.predict(x)                      # (n, 784) numpy -> (n, 10)

    mesh = TrainingSession(dp=2, pp=4, schedule="gpipe",
                           kernel_backend="pallas", data_dir=...)
    sharded = TrainingSession(dp=2, pp=4, zero=2, grad_bucket_bytes=65536,
                              kernel_backend="pallas", data_dir=...)
    chunks = TrainingSession(pp=2, schedule="interleaved", virtual_stages=2,
                             kernel_backend="pallas", data_dir=...)

Two layouts. The sequential one (dp = pp = virtual_stages = tp = 1) and a
``dp`` x ``pp`` [x ``tp``] mesh run by the lockstep pipeline executor
(``parallel/executor.py``): the schedule's lowered tick tables over a
virtual mesh whose ranks all live on the session's device, with
``kernel_backend="pallas"`` putting every slot of every tick through the
flag kernels (TPU kernels B5-B8; ``"xla"`` is plain torch). The mesh runs
the JAX session's schedule lattice: ``schedule="interleaved"`` with
``virtual_stages`` model stages per device (stacked in
``executor.interleave_order``), ``backward_split`` (2BP, bitwise the
unsplit run), ``recompute`` (bitwise the stashed run) and the gelu family
(``model="transformer"``); the last three on the ``"xla"`` backend, as in
the JAX package. ``tp > 1`` Megatron-shards every slot over the mesh's tp
axis (column-parallel even slots, row-parallel odd ones; the ``"xla"``
backend only, as in the JAX package), on every schedule, with the split
backward, recompute, ZeRO 0-3, buckets and the gelu family. ZeRO on the
dp axis, as the JAX session runs it:
``zero=1`` (``zero1=True``) shards the optimizer state and update over dp
(the flat layout), ``zero=2`` the gradients too (the block-cyclic layout;
a per-tick shard carry, or with ``grad_bucket_bytes`` the bucketed tail),
``zero=3`` the params at rest (``"xla"`` only; ``predict`` reads an eval
view rebuilt once per weight update); ``grad_bucket_bytes`` also buckets
the stage-0 sum. Checkpoints keep the JAX package's logical layout, so a
run saved at one stage or layout resumes at another. Training: the reference's
recipe (global batch 128 in 4 microbatches, SGD at lr 0.006) or momentum /
Adam, with decoupled weight decay, global-norm clipping and fused
microbatches, driven per step (``train_steps``), per epoch
(``train_epoch``) or per run (``train_run``), with the JAX session's
epoch/step cursor and loss definitions. With ``fuse_mubatches`` the fused
train kernel can carry the training (TPU kernels B9-B11):
``megakernel=True`` one launch per batch, ``epoch_kernel=True`` one per
epoch (``train_steps`` runs it over the batches of the chunk), and
``run_kernel=True`` one for a whole ``train_run(with_eval=False)`` (its
other calls take the epoch kernel). A session built without
``data_dir`` serves only: weights from the deterministic init or a
checkpoint (``resume=``, any layout's snapshot), and ``predict`` exactly as
the JAX session's branches — rows packed into fixed ``slot_rows``-row
slots, one slot-shaped forward per OCCUPIED slot on the sequential layout,
one inference program per ladder rung on the mesh (slots packed
with ``serving/slots.pack_slots``). A fixed slot shape is what makes a
request's rows give the same bits whatever rides beside them, which the
serving engine's "response == direct predict()" contract needs.

Fault tolerance, as the JAX session's: ``checkpoint_dir`` with
``save_step_checkpoint`` (sync, or through the async writer) writes
checksummed, rotating step snapshots in the JAX package's format;
``resume="auto"`` continues from the newest one that verifies; ``faults``
(or ``SHALLOWSPEED_FAULTS``) kills, poisons or corrupts the run at a pinned
step or save; ``model_hash`` is the reference's weight hash.

Telemetry, as the JAX session's (``observability/``, schema v13):
``metrics=JsonlMetrics(path)`` records the construction spans, the
``cost_model`` (model FLOPs against the card's fp32 peak), one ``epoch``
record per epoch with samples/s and ``mfu``, per-step ``step`` records from
the flight recorder, ``checkpoint``/``recovery`` records and live
``rollup``/``alert`` windows; ``health="record"|"warn"|"halt"`` checks
every step for non-finite values, loss divergence and gradient spikes
(``halt`` flushes a synchronous snapshot, then raises ``HealthError``);
``digests=True`` streams per-step per-layer checksums and norms
(``digest`` records) for ``observability.divergence``. The per-step aux
stays on the device and is read once per dispatch; with ``NullMetrics``,
no monitor and ``record_steps`` unset, every path issues exactly the GPU
work it issues uninstrumented. ``measure_dispatch_overhead`` splits an
epoch's host wall into device-busy and host time under ``torch.profiler``;
``inference_latency_bound`` is the slot's FLOPs over the card's peak.

Two runtimes on a mesh layout. ``runtime="lockstep"`` (the default) runs
the executor's tick loop on one stream. ``runtime="mpmd"`` runs the JAX
session's MPMD runtime in one process (``parallel/mpmd.py``): one CUDA
stream per pipeline stage, each stage's programs issued from the tick
tables, relays ordered by events, bitwise the lockstep weights; it has the
JAX session's feature envelope (no ZeRO, buckets, clip, pallas backend,
step records or digests; ``train_run`` refused), and ``predict``/
``predict_async`` stream request slots through the per-stage chain. The
multi-process runtime (``parallel/multihost.py``, ROADMAP.md §A item 7) is
not ported.

The program audit, as the JAX session's (``observability/program_audit.py``):
with a recorder, every distinct program the session dispatches (the
``epoch_program``, each shorter ``chunk_program``, each ``run_program``
variant, each mesh ``inference_program`` rung, under mpmd each
``mpmd_stage_program`` through the runners' ``warm``) writes one
``xla_audit`` record: the census of the data movers that ran, held to the
layout's comms contract (``expected_comms``), and the allocator's peak. The
census rides the program's first real dispatch. ``audit=True`` enforces
the contract: each program first runs once as a probe on clones of the
state it writes (and one batch), and a census that breaks the contract, or
a serving rung that writes its params, raises ``AuditMismatchError``
before the real dispatch, with the session's state as it was.

The AOT program cache, as the JAX session's (``aot_cache.py``):
``aot_cache_dir`` resolves every program before its first dispatch through
an on-disk store of its resolved form (the lowered tick tables, their
static-analysis verdict and, on the card, the kernel libraries it
launches): the epoch and chunk programs, each ``run_program``, each mesh
inference rung, the sequential slot program (``predict_seq``) and, under
mpmd, each stage program through the runners' ``warm``. A warm start
writes the stored libraries into ``build/`` (no ``nvcc``) and takes the
stored tables and verdict instead of the lowering's analysis. Every
program resolved through the cache, from a hit or a build, runs its audit
probe on clones before it first dispatches, so a warm start launches what
its cold twin launches; a hit whose census breaks the contract is lowered
again and rewritten. ``warm_run(epochs, with_eval)`` resolves the next
``train_run`` without executing it.
"""

import sys
import tempfile
import threading
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import _build, convert, resolve_device, trainer, utils
from shallowspeed_tpu_torch import aot_cache as AC
from shallowspeed_tpu_torch.analysis import ProgramAnalysisError, analyze_program
from shallowspeed_tpu_torch import faults as F
from shallowspeed_tpu_torch import model as Mo
from shallowspeed_tpu_torch import schedules as S
from shallowspeed_tpu_torch.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointError,
    assemble_checkpoint,
    build_snapshot,
    find_latest_good,
    load_checkpoint,
    run_save_stages,
    save_checkpoint,
    step_checkpoint_path,
)
from shallowspeed_tpu_torch.data import Dataset
from shallowspeed_tpu_torch.observability import NullMetrics, costmodel
from shallowspeed_tpu_torch.observability import program_audit as A
from shallowspeed_tpu_torch.observability.flight import FlightRecorder
from shallowspeed_tpu_torch.observability.health import HealthError, make_monitor
from shallowspeed_tpu_torch.observability.slo import LiveTelemetry, default_training_rules
from shallowspeed_tpu_torch.observability.spans import capture
from shallowspeed_tpu_torch.observability.tracing import Tracer
from shallowspeed_tpu_torch.optimizer import is_stateless, make_optimizer
from shallowspeed_tpu_torch.parallel import executor as E
from shallowspeed_tpu_torch.parallel import gradsync, mpmd
from shallowspeed_tpu_torch.parallel.lowering import (
    TickProgram,
    lower_schedule,
    program_flops,
    program_stats,
)
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh
from shallowspeed_tpu_torch.serving import slots as serving_slots

# The reference's canonical training configuration.
FLAGSHIP_SIZES = (784, 128, 127, 126, 125, 124, 123, 10)
FLAGSHIP_BATCH = 128
FLAGSHIP_MUBATCHES = 4
FLAGSHIP_LR = 0.006

PRECISION_DEFAULT_REFUSAL = (
    "precision='default' (the TPU's bf16-input MXU passes) has no "
    "counterpart in the port yet; it computes in IEEE fp32 "
    "(precision='highest') — see ROADMAP.md, Parity rules"
)


class TrainingSession:
    """A model's weights on one device: trained from a data split, served
    through slot-shaped forwards.

    ``sizes``/``model``: the layer sizes, or a ``MODEL_ZOO`` name that
    overrides them. ``global_batch_size``/``mubatches``: the batch and its
    microbatch count (the loss is scaled by the global batch).
    ``precision``: only ``"highest"`` (IEEE fp32) exists on this port.
    ``data_dir``: the split to train on (``x_train.npy``, ``y_train.npy``,
    ``x_val.npy``, ``y_val.npy``); without it the session serves only and
    the ``train_*``/``accuracy`` methods raise. ``lr``, ``optimizer``
    (sgd|momentum|adam), ``momentum``, ``weight_decay`` (decoupled),
    ``clip_norm`` (global norm, None = off), ``fuse_mubatches`` (one
    forward/backward per batch): the training recipe. ``megakernel``,
    ``epoch_kernel``, ``run_kernel`` (each needs ``fuse_mubatches``;
    ``run_kernel`` excludes the other two): the fused train kernel per
    batch, per epoch, or per whole eval-free run. ``resume``: a
    checkpoint path whose params, optimizer state and epoch/step cursor
    this session continues from, or ``"auto"``: the newest step snapshot
    in ``checkpoint_dir`` that verifies (an empty directory is a fresh
    start; snapshots of which none verifies raise ``CheckpointError``).
    ``checkpoint_dir``/``checkpoint_keep``: where ``save_step_checkpoint``
    writes ``step-<global_step>.npz`` and how many it keeps;
    ``async_checkpoint``/``checkpoint_queue``: the default save mode (the
    background writer) and its in-flight window. ``faults``: a fault
    plan, its spec string, or None to read ``SHALLOWSPEED_FAULTS``
    (``faults.py``). ``predict_slot_rows``/
    ``predict_slot_ladder``: the slot geometry (``serving/slots.py``).
    ``dp``/``pp``/``tp``/``schedule`` (naive|gpipe|pipedream|interleaved):
    the mesh layout, run by the lockstep pipeline executor over a virtual
    mesh on the session's device (``tp``: the Megatron model axis, on the
    ``"xla"`` backend); ``virtual_stages``: model stages per device
    (> 1 needs ``schedule="interleaved"``; the model is cut into ``pp *
    virtual_stages`` stages); ``backward_split``: the two-stage backward
    (B-input at the relay tick, B-weight deferred); ``recompute``: stash
    only each stage's input and re-run its forward before the backward;
    ``kernel_backend``: the executor's per-slot unit, ``"xla"`` (plain
    torch) or ``"pallas"`` (the flag kernels, B5-B8; mesh layouts of the
    relu family only, without split or recompute, as in the JAX package).
    ``metrics``: a recorder (``observability.JsonlMetrics``; None = the
    zero-cost ``NullMetrics``). ``health``: None, ``"record"``, ``"warn"``,
    ``"halt"`` or a ``HealthMonitor``. ``record_steps``: the per-step
    flight aux (None = on whenever a recorder or a monitor consumes it;
    refused on the kernel paths). ``digests``: per-step per-layer digest
    records (opt-in; refused on the kernel paths).
    ``zero`` (0-3; ``zero1=True`` is stage 1): the dp-axis ZeRO stage (mesh
    layouts; stage 3 on ``"xla"`` only). ``grad_bucket_bytes``: the
    bucketed gradient sync (mesh layouts, stages 0-2; 0 = the anchor sum).
    ``runtime``: ``"lockstep"`` (the executor's tick loop) or ``"mpmd"``
    (per-stage streams, ``parallel/mpmd.py``; mesh layouts, in the JAX
    session's feature envelope). ``audit``: enforce the layout's comms
    contract on every program before its first dispatch (a probe on clones;
    ``AuditMismatchError``). ``aot_cache_dir``: the AOT program cache's
    directory (``aot_cache.py``; None = no cache).
    ``device``: ``"cuda"`` (default) or ``"cpu"``; a missing GPU raises, it
    never falls back."""

    def __init__(
        self,
        sizes=FLAGSHIP_SIZES,
        model=None,
        global_batch_size=FLAGSHIP_BATCH,
        mubatches=FLAGSHIP_MUBATCHES,
        lr=FLAGSHIP_LR,
        precision="highest",
        data_dir=None,
        resume=None,
        fuse_mubatches=False,
        optimizer="sgd",
        momentum=0.9,
        weight_decay=0.0,
        clip_norm=None,
        megakernel=False,
        epoch_kernel=False,
        run_kernel=False,
        dp=1,
        pp=1,
        tp=1,
        schedule="gpipe",
        virtual_stages=1,
        zero1=False,
        zero=None,
        grad_bucket_bytes=0,
        backward_split=False,
        recompute=False,
        runtime="lockstep",
        kernel_backend="xla",
        metrics=None,
        health=None,
        record_steps=None,
        digests=False,
        audit=False,
        faults=None,
        checkpoint_dir=None,
        checkpoint_keep=3,
        async_checkpoint=False,
        checkpoint_queue=2,
        predict_slot_rows=None,
        predict_slot_ladder=None,
        aot_cache_dir=None,
        device=None,
    ):
        self.device = resolve_device(device)
        # telemetry: NullMetrics records nothing and costs nothing; the
        # live rollup windows and alert rules are fed only inside
        # metrics-enabled blocks
        self._metrics = metrics if metrics is not None else NullMetrics()
        self._telemetry = LiveTelemetry(
            "train", metrics=self._metrics, rules=default_training_rules()
        )
        self._health = make_monitor(health)
        # the program audit (observability/program_audit.py): with a
        # recorder every distinct program's census and memory peak is
        # recorded (``xla_audit``); ``audit=True`` also ENFORCES the
        # layout's comms contract before a program first dispatches
        self._audit_strict = bool(audit)
        self._audit_done = set()  # dedup keys of the programs audited
        # one census records at a time: a second thread's first dispatch of
        # a program waits for the first's audit
        self._audit_lock = threading.Lock()
        self._mpmd_warmed = False
        # the AOT program cache (aot_cache.py): each program resolves
        # through it before its first dispatch, and is audited on clones
        # before it dispatches, from a hit or a build
        self._aot = None
        if aot_cache_dir is not None:
            self._aot = AC.AotCache(aot_cache_dir, metrics=self._metrics, device=self.device)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if precision == "default":
            raise ValueError(PRECISION_DEFAULT_REFUSAL)
        if precision != "highest":
            raise ValueError(f"precision must be 'highest', got {precision!r}")
        if schedule not in S.SCHEDULES:
            raise ValueError(
                f"schedule must be one of {sorted(S.SCHEDULES)}, got {schedule!r}"
            )
        if runtime not in ("lockstep", "mpmd"):
            raise ValueError(f"runtime must be 'lockstep' or 'mpmd', got {runtime!r}")
        self.runtime = runtime
        self._mpmd = None  # the train runner, built with the tick program
        self._mpmd_infer = None  # the streaming inference runner (lazy)
        self._mpmd_infer_view_cache = None
        if checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if checkpoint_queue < 1:
            raise ValueError("checkpoint_queue must be >= 1")
        self._ckpt_dir = checkpoint_dir
        self._ckpt_keep = int(checkpoint_keep)
        self._async_ckpt_default = bool(async_checkpoint)
        self._ckpt_queue = int(checkpoint_queue)
        self._ckpt_writer = None
        # paths THIS session wrote finite: rotation trusts them without
        # re-reading (their checksums were computed in-process). The async
        # writer's completions add to it, so it is guarded by a lock.
        self._trusted_snapshots = set()
        self._trusted_lock = threading.Lock()
        # the @save=N fault anchor: every save this session attempts
        self._save_seq = 0
        self._faults = F.make_plan(faults)
        self.resumed_from = None  # path of the restored snapshot, if any
        self._recovery = None  # the recovery record's fields, if resume ran
        # per-epoch aggregation across train_steps() chunks
        self._epoch_wall = 0.0
        self._epoch_first_dispatch = False
        if model is not None:
            sizes, act = Mo.resolve_model(model)
        else:
            act = "relu"
        dp, pp, tp, V = int(dp), int(pp), int(tp), int(virtual_stages)
        if dp < 1 or pp < 1:
            raise ValueError(f"dp and pp must be >= 1, got dp={dp}, pp={pp}")
        if V < 1:
            raise ValueError("virtual_stages must be >= 1")
        if V > 1 and schedule != "interleaved":
            raise ValueError(
                "virtual_stages > 1 requires schedule='interleaved' (the flat "
                "schedules place exactly one stage per device)"
            )
        if global_batch_size % dp != 0:
            raise ValueError("global batch size must be divisible by dp")
        local_batch = global_batch_size // dp
        if mubatches < 1 or local_batch % mubatches != 0:
            raise ValueError("mubatches must divide the local batch")
        self.dp, self.pp, self.tp, self.V = dp, pp, tp, V
        self.schedule = schedule
        self._sequential = dp == 1 and pp == 1 and V == 1 and tp == 1
        if fuse_mubatches and not self._sequential:
            raise ValueError(
                "fuse_mubatches applies to the sequential path only; in the "
                "pipeline executor microbatches are semantic (they ARE the "
                "pipeline's unit of work)"
            )
        if megakernel and not fuse_mubatches:
            raise ValueError(
                "megakernel runs the whole fused batch as one CUDA kernel; "
                "it requires fuse_mubatches=True (sequential path)"
            )
        if epoch_kernel and not fuse_mubatches:
            raise ValueError(
                "epoch_kernel runs the whole epoch as one CUDA kernel; "
                "it requires fuse_mubatches=True (sequential path)"
            )
        if run_kernel and not fuse_mubatches:
            raise ValueError(
                "run_kernel runs the whole multi-epoch run as one CUDA "
                "kernel; it requires fuse_mubatches=True (sequential path)"
            )
        if run_kernel and (megakernel or epoch_kernel):
            raise ValueError(
                "run_kernel subsumes the mega/epoch kernels; pass only "
                "run_kernel=True"
            )
        self._run_kernel = bool(run_kernel)
        if kernel_backend not in E.KERNEL_BACKENDS:
            raise ValueError(
                f"kernel_backend must be 'xla' or 'pallas', got {kernel_backend!r}"
            )
        if kernel_backend == "pallas" and act != "relu":
            raise ValueError(
                "kernel_backend='pallas' hard-codes the relu/identity slot "
                "expressions; the gelu-family models (f32 grad-multiplier "
                "masks, residual adds) run the XLA backend only"
            )
        if kernel_backend == "pallas" and tp > 1:
            raise ValueError(
                "tensor parallelism (tp > 1) shards each slot's W across "
                "the tp axis; the fused pallas flag kernels compute whole "
                "slots — use kernel_backend='xla'"
            )
        if kernel_backend == "pallas" and self._sequential:
            raise ValueError(
                "kernel_backend='pallas' selects the pipeline executor's "
                "flag-operand kernels and needs a mesh layout (dp/pp > 1 or "
                "virtual_stages > 1); on the sequential path the CUDA kernels "
                "run already — use megakernel=True for the fused train kernel"
            )
        # the dp-axis ZeRO stage: ``zero`` supersedes the ``zero1`` alias;
        # the JAX session's refusals, in its words
        zero = self._zero = E._resolve_zero(zero, zero1)
        # the ZeRO-3 eval view: the stacked {W, b} rebuilt from the shards
        # at rest for the inference programs, once per weight update
        self._eval_stacked_cache = None
        if self._zero and self._sequential:
            if zero == 1:
                raise ValueError(
                    "zero1 shards the optimizer update over the dp mesh "
                    "axis; the sequential path has no mesh — use dp/pp > 1"
                )
            raise ValueError(
                f"zero={zero} shards the update over the dp mesh axis; "
                "the sequential path has no mesh — use dp/pp > 1"
            )
        if self._zero >= 2 and digests:
            raise ValueError(
                "digests read the zero1 flat-chunk segment map; the "
                "block-cyclic shard layout of zero>=2 has no flat chunk — "
                "use --zero 1 or below with --digests"
            )
        if self._zero == 3 and kernel_backend == "pallas":
            raise ValueError(
                "zero=3 all-gathers parameter segments inside every tick "
                "branch; the fused pallas flag kernels take whole resident "
                "slots — use kernel_backend='xla' with --zero 3"
            )
        if self._zero == 3 and grad_bucket_bytes:
            raise ValueError(
                "zero=3 syncs gradients per tick (one reduce-scatter per "
                "layer slot inside the scan); grad_bucket_bytes shapes the "
                "tail sync only and has nothing to bucket at stage 3"
            )
        if grad_bucket_bytes is None:
            grad_bucket_bytes = 0
        grad_bucket_bytes = int(grad_bucket_bytes)
        if grad_bucket_bytes < 0:
            raise ValueError("grad_bucket_bytes must be >= 0 (0 = anchor sync)")
        if grad_bucket_bytes and self._sequential:
            raise ValueError(
                "grad_bucket_bytes buckets the dp-axis gradient collectives; "
                "the sequential path has no gradient sync — use dp/pp > 1 "
                "(0 keeps the legacy anchor psum on mesh layouts)"
            )
        # the split backward and recompute: the JAX session's refusals, in
        # its words
        self._backward_split = bool(backward_split)
        if self._backward_split:
            if self._sequential:
                raise ValueError(
                    "backward_split is a pipeline-schedule property (B-input "
                    "at the relay tick, B-weight deferred into bubbles); the "
                    "sequential path has no schedule — use dp/pp > 1"
                )
            if V > 1:
                raise ValueError(
                    "backward_split is not supported with interleaved "
                    "virtual stages (the chunked steady state interleaves "
                    "its own bubbles; splitting its backward is future work)"
                )
            if kernel_backend == "pallas":
                raise ValueError(
                    "backward_split needs the XLA per-slot backward; the "
                    "fused pallas flag kernel has no split halves"
                )
        self._recompute = bool(recompute)
        if self._recompute:
            if self._sequential:
                raise ValueError(
                    "recompute drops pipeline activation stashes and "
                    "re-runs the stage forward at the backward tick; the "
                    "sequential path holds no cross-tick stash — use "
                    "dp/pp > 1"
                )
            if V > 1:
                raise ValueError(
                    "recompute is not supported with interleaved virtual "
                    "stages (the chunked stash rotation is its own "
                    "lifetime discipline; recomputing it is future work)"
                )
            if kernel_backend == "pallas":
                raise ValueError(
                    "recompute re-runs the XLA per-slot forward inside "
                    "the backward tick; the fused pallas flag kernel has "
                    "no recompute branch"
                )
        if runtime == "mpmd":
            # the JAX session's feature envelope, in its words: the knobs
            # whose lockstep implementations span every stage stay
            # lockstep-only
            if self._sequential:
                raise ValueError(
                    "runtime='mpmd' dispatches one program per pipeline "
                    "stage; the sequential path has no stages — use a mesh "
                    "layout (dp/pp/tp > 1)"
                )
            if self._zero:
                raise ValueError(
                    f"runtime='mpmd' does not support zero (stage "
                    f"{self._zero}) yet: the ZeRO reduce-scatter/all-gather "
                    "update spans the whole sharded param layout, not one "
                    "stage — use runtime='lockstep'"
                )
            if grad_bucket_bytes:
                raise ValueError(
                    "runtime='mpmd' does not support grad_bucket_bytes: "
                    "bucketed sync overlaps collectives inside the lockstep "
                    "program's tail; the MPMD per-stage update is one psum "
                    "per stage already — use runtime='lockstep'"
                )
            if clip_norm is not None:
                raise ValueError(
                    "runtime='mpmd' does not support clip_norm yet: the "
                    "global norm spans every stage's gradient, which the "
                    "per-stage update programs cannot see — use "
                    "runtime='lockstep'"
                )
            if kernel_backend != "xla":
                raise ValueError(
                    "runtime='mpmd' uses the XLA per-slot stage functions; "
                    "kernel_backend='pallas' is lockstep-only"
                )
            if record_steps:
                raise ValueError(
                    "runtime='mpmd' does not thread the per-step flight aux "
                    "(loss/grad-norm/param-norm vectors ride the lockstep "
                    "epoch scan); pass record_steps=False or use "
                    "runtime='lockstep'"
                )
            record_steps = False
            if digests:
                raise ValueError(
                    "runtime='mpmd' does not thread the per-step digest aux "
                    "(the per-layer checksum grids ride the lockstep epoch "
                    "scan); pass digests=False or use runtime='lockstep'"
                )
        self._kernel_backend = kernel_backend
        self.B, self.M = int(global_batch_size), int(mubatches)
        if clip_norm is not None and clip_norm <= 0:
            raise ValueError("clip_norm must be positive (or None to disable)")
        n_model_stages = pp * V
        self.spec = Mo.make_model_spec(sizes, n_model_stages, self.B, act=act)
        # device-major stage placement for virtual chunks (identity otherwise)
        self._order = E.interleave_order(n_model_stages, pp) if V > 1 else None
        self._opt = make_optimizer(optimizer, lr, momentum, weight_decay)
        self._opt_config = {
            "name": optimizer,
            "lr": lr,
            "momentum": momentum,
            "weight_decay": weight_decay,
        }
        self._data_dir = data_dir
        self.epoch = 0
        # step cursor within the current epoch: 0 except after a mid-epoch
        # resume or between train_steps() chunks
        self.step_in_epoch = 0
        self._epoch_loss_sum = 0.0
        self._epoch_steps_counted = 0
        self.batches_per_epoch = 0
        # on the device: (nb, M, mubatch, dim) sequential, (nb, B, dim) mesh
        self._X = self._Y = None
        self._vx = self._vy = None  # the validation split, loaded lazily
        if data_dir is not None:
            self._load_train(data_dir)

        host_opt_state = None
        verified = None  # (meta, arrays) of the snapshot discovery verified
        if resume == "auto":
            resume, verified, skipped = self._discover_resume()
            self._recovery = {
                "verdict": "fresh_start" if resume is None else "resumed",
                "resumed_from": None if resume is None else str(resume),
                "skipped": [{"path": str(p), "cause": c} for p, c in skipped],
            }
        if resume is not None:
            if verified is not None:
                # assemble from the arrays discovery read and checksummed:
                # one read, and nothing can rot or rotate away in between
                host_params, loaded_spec, meta, host_opt_state = assemble_checkpoint(
                    resume, *verified, n_model_stages, self.B, with_opt_state=True
                )
            else:
                host_params, loaded_spec, meta, host_opt_state = load_checkpoint(
                    resume, n_model_stages, self.B, with_opt_state=True
                )
            self.resumed_from = str(resume)
            self._check_compatible(loaded_spec, "the requested model")
            self.spec = loaded_spec
            if data_dir is not None:
                self._restore_cursor(meta)
        else:
            host_params = Mo.init_model(self.spec)
        stateful = host_opt_state is not None and not is_stateless(self._opt)
        self._run_fns = {}  # whole-run functions, keyed by with_eval
        # telemetry aux (the JAX session's rules and words): the pre-clip
        # grad norm when recording with a clip; the per-step flight aux
        # when a recorder or a monitor consumes it (record_steps=None) or
        # when forced; the digests when asked. The kernel paths keep the
        # gradient inside the fused train kernel, so they have none of it
        kernel_path = self._kernel_path = bool(megakernel or epoch_kernel or run_kernel)
        self._gnorm_aux = self._metrics.enabled and clip_norm is not None and not kernel_path
        if record_steps is None:
            record_steps = self._metrics.enabled or self._health is not None
        elif record_steps and kernel_path:
            raise ValueError(
                "record_steps is unavailable on the kernel paths: the "
                "gradient never leaves the Pallas kernel's VMEM"
            )
        if digests and kernel_path:
            raise ValueError(
                "digests is unavailable on the kernel paths: params/grads "
                "never leave the Pallas kernel's VMEM, so the per-layer "
                "digest aux cannot be threaded out"
            )
        self._digests = bool(digests)
        if self._digests and self._metrics.enabled:
            # replay provenance for the bisect CLI (observability/
            # divergence.py --bisect): the JAX record's fields, with its
            # scan unroll factors at their neutral 1
            self._metrics.event(
                "digest_config",
                sizes=list(self.spec.sizes), model=model, dp=dp, pp=pp, tp=tp,
                schedule=schedule, global_batch_size=self.B,
                mubatches=self.M, lr=lr, precision=precision,
                optimizer=optimizer, momentum=momentum,
                virtual_stages=V, zero1=bool(zero1), zero=self._zero,
                grad_bucket_bytes=grad_bucket_bytes,
                backward_split=self._backward_split, recompute=self._recompute,
                scan_unroll=1, tick_unroll=1, weight_decay=weight_decay,
                clip_norm=clip_norm, fuse_mubatches=fuse_mubatches,
                data_dir=None if data_dir is None else str(data_dir),
                faults=",".join(repr(f) for f in self._faults.faults),
            )
        self._step_aux = bool(record_steps) and not kernel_path
        self._act, self._precision_name = act, precision
        self.flight = FlightRecorder() if self._step_aux else None
        if self.flight is not None:
            # resumed step records continue the global numbering
            self.flight.total_steps = self.global_step
        self._epoch_dispatched = False  # the first dispatch includes the build
        aux = dict(
            with_grad_norm=self._gnorm_aux, with_step_stats=self._step_aux,
            with_digests=self._digests,
        )
        if self._sequential:
            with self._metrics.span("device_put"):
                self._params = convert.params_from_numpy(host_params, self.device)
            if stateful:
                self._opt_state = convert.opt_state_from_numpy(
                    self._opt, host_opt_state, self.device
                )
            else:
                self._opt_state = self._opt.init(Mo.param_tree(self._params))
            kernels = dict(megakernel=megakernel, epoch_kernel=epoch_kernel or run_kernel)
            self._epoch_fn = trainer.make_train_epoch(
                self.spec, self._opt, fuse_mubatches=fuse_mubatches,
                clip_norm=clip_norm, **kernels, **aux,
            )
            self._run_kwargs = dict(
                fuse_mubatches=fuse_mubatches, clip_norm=clip_norm, **kernels
            )
            self._predict = trainer.make_predict(self.spec)
        else:
            # the stacked layout; the flags stay host numpy (the executor
            # decides each tick's work on the host)
            self.mesh = VirtualMesh(dp, pp, self.device, tp=tp)
            if self._metrics.enabled:
                # placement provenance: every virtual rank on one device
                self._metrics.event(
                    "mesh_layout", dp=dp, pp=pp, tp=tp, layout="virtual", n_devices=1,
                )
            with self._metrics.span("schedule_lower"):
                self._prog = lower_schedule(
                    S.SCHEDULES[schedule], self.M, pp, virtual=V,
                    backward_split=self._backward_split, recompute=self._recompute,
                )
            self._mubatch_local = local_batch // self.M
            if self._metrics.enabled:
                # the lowered program's static passes (send/recv match,
                # deadlock freedom, stash lifetimes), as the JAX session
                # records them; a violated contract raises here (with an
                # AOT cache they run, or load, as the program resolves)
                if self._aot is None:
                    self._analyze(self._prog, "epoch_program")
                # the lowered program's static tick stats, recorded once
                stats = program_stats(
                    self._prog, spec=self.spec, mubatch_size=self._mubatch_local, tp=tp
                )
                if self._recompute:
                    # the stashed twin's footprint beside it, as the JAX
                    # session records it
                    twin = program_stats(
                        lower_schedule(
                            S.SCHEDULES[schedule], self.M, pp, virtual=V,
                            backward_split=self._backward_split, recompute=False,
                        ),
                        spec=self.spec, mubatch_size=self._mubatch_local, tp=tp,
                    )
                    stats["stash_bytes_peak_stashed_twin"] = twin["stash_bytes_peak"]
                    stats["stash_slots_stashed_twin"] = twin["stash_slots"]
                self._metrics.event(
                    "pipeline_program", schedule=schedule, dp=dp, pp=pp, tp=tp,
                    virtual=V, model=model, **stats,
                )
                self._metrics.gauge("pipeline.bubble_fraction", stats["bubble_fraction"])
            with self._metrics.span("device_put"):
                if self._zero == 3:
                    # params at rest: one (pp*tp, dp*csz3) block-cyclic tensor,
                    # every rank's shard; the stacked {W, b} never lands
                    self._stacked, self._flags = convert.zero_params_from_numpy(
                        host_params, self.spec, self.mesh, order=self._order
                    )
                else:
                    self._stacked, self._flags = convert.stacked_from_numpy(
                        host_params, self.spec, self.device, order=self._order, tp=tp
                    )
            if self._zero:
                self._opt_state = convert.zero_opt_state_from_numpy(
                    self._opt, host_opt_state if stateful else None, self.spec,
                    self.mesh, self._zero, order=self._order,
                )
            elif stateful:
                self._opt_state = convert.stacked_opt_state_from_numpy(
                    self._opt, host_opt_state, self.spec, self.device,
                    order=self._order, tp=tp,
                )
            else:
                self._opt_state = self._opt.init(self._stacked)
            self._run_kwargs = dict(
                clip_norm=clip_norm, kernel_backend=kernel_backend, zero=self._zero,
                grad_bucket_bytes=grad_bucket_bytes,
            )
            if runtime == "mpmd":
                # the runner's constructor is the admission gate: the tick
                # tables are proven before any stage program exists
                self._mpmd = mpmd.MpmdTrainRunner(
                    self.mesh, self.spec, self._prog, self._mubatch_local, self._opt,
                    tracer=Tracer(self._metrics, process="m"),
                )

                def _mpmd_epoch(stacked, flags, opt_state, X, Y):
                    return self._mpmd.run(
                        stacked, flags, opt_state, X, Y,
                        trace_id=f"mpmd-{self.global_step}",
                    )

                self._epoch_fn = _mpmd_epoch
            else:
                self._epoch_aux = aux
                self._epoch_fn = self._build_epoch_fn(self._prog)
            self._predict_cache = {}  # inference programs, keyed by ladder rung

        if predict_slot_rows is None:
            self._slot_rows = serving_slots.default_slot_rows(dp)
        else:
            self._slot_rows = int(predict_slot_rows)
            if self._slot_rows < 1 or self._slot_rows % dp:
                raise ValueError(
                    f"predict_slot_rows must be a positive multiple of dp="
                    f"{dp}, got {predict_slot_rows}"
                )
        self._slot_ladder = serving_slots.validate_ladder(
            predict_slot_ladder
            if predict_slot_ladder is not None
            else serving_slots.DEFAULT_SLOT_LADDER
        )
        # the FLOP ledger and the card's peak (observability/costmodel):
        # padded hardware FLOPs from the lowered tick tables on the mesh.
        # Every rank of the port's mesh runs on the session's one device
        self._device_name = (
            torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else None
        )
        self._cost_model = costmodel.CostModel(
            sizes=self.spec.sizes,
            global_batch=self.B,
            batches_per_epoch=self.batches_per_epoch,
            n_devices=1,
            platform=self.device.type,
            precision=precision,
            padded_flops_per_batch=None if self._sequential else (
                program_flops(self._prog, self.spec, self._mubatch_local, tp=tp) * dp
            ),
            device_name=self._device_name,
        )
        self._sync_plan = None
        if grad_bucket_bytes and not self._sequential:
            # the executor's plan, rebuilt through the same planner
            self._sync_plan = gradsync.plan_buckets(
                self.spec, dp, pp, grad_bucket_bytes, zero=self._zero, tp=tp
            )
            if self._metrics.enabled:
                # static telemetry, recorded once: bucket count and sizes
                self._metrics.event(
                    "grad_sync_plan", dp=dp, pp=pp, tp=tp, zero=self._zero,
                    **self._sync_plan.describe(),
                )
        # the layout's analytical comms contract (the JAX session's), which
        # every program's census is held to; only params-mirroring
        # optimizer parts occupy per-layer bytes in the ZeRO forecast
        self._audit_platform = "gpu" if self.device.type == "cuda" else "cpu"
        self._expected_comms = A.expected_comms(
            self.spec, dp, pp,
            prog=None if self._sequential else self._prog,
            zero=self._zero,
            mubatch_size=None if self._sequential else self._mubatch_local,
            platform=self._audit_platform,
            precision=precision,
            grad_bucket_plan=self._sync_plan,
            tp=tp,
            opt_state_parts=sum(1 for v in self._opt.state_layout().values() if v == "params"),
            device_name=self._device_name,
        )
        if self._recovery is not None and self._metrics.enabled:
            # one recovery record per resume decision
            self._metrics.recovery(
                self._recovery["verdict"],
                resumed_from=self._recovery["resumed_from"],
                epoch=self.epoch,
                step_in_epoch=self.step_in_epoch,
                global_step=self.global_step,
                skipped=self._recovery["skipped"],
            )
        if self._metrics.enabled:
            self._metrics.event("cost_model", **self._cost_model.as_record())
            self._metrics.gauge("model_flops", self._cost_model.flops_per_epoch)

    def _discover_resume(self):
        """``resume="auto"``: the newest step snapshot in the checkpoint
        directory that verifies (checksum, finiteness), as ``(path, (meta,
        arrays), skipped)``, or ``(None, None, skipped)`` for an empty or
        missing directory (a fresh start); ``skipped`` lists ``(path,
        cause)`` of each corrupt, torn or non-finite snapshot passed over.
        When snapshots exist and none verifies, ``CheckpointError`` names
        each one's cause."""
        if self._ckpt_dir is None:
            raise ValueError(
                "resume='auto' discovers snapshots in the step-checkpoint "
                "directory — pass checkpoint_dir"
            )
        path, meta, arrays, skipped = find_latest_good(self._ckpt_dir, with_arrays=True)
        if path is None and skipped:
            raise CheckpointError(
                self._ckpt_dir,
                "no snapshot verifies: "
                + "; ".join(f"{p.name}: {c}" for p, c in skipped)
                + " (non-finite snapshots are skipped by design — delete the "
                "directory to start fresh)",
            )
        if path is None:
            return None, None, skipped
        return path, (meta, arrays), skipped

    def _load_train(self, data_dir):
        ds = Dataset(data_dir, self.B, mubatch_size=self.B // self.M)
        ds.load(0, 1)
        nb = ds.get_num_batches()
        if nb == 0:
            raise ValueError(
                f"training split has {ds.raw_len} samples — fewer than one "
                f"global batch of {self.B}"
            )
        Xb, Yb = ds.epoch_arrays()
        if not self._sequential:
            # the executor splits each (B, dim) batch over dp itself
            Xb = Xb.reshape(nb, self.B, -1)
            Yb = Yb.reshape(nb, self.B, -1)
        if self.runtime == "mpmd":
            # the MPMD runner copies each batch onto the streams of the
            # stages that read it; the epoch arrays stay on the host
            self._X, self._Y = Xb, Yb
            self.batches_per_epoch = nb
            return
        with self._metrics.span("device_put"):
            self._X = torch.from_numpy(Xb).to(self.device)
            self._Y = torch.from_numpy(Yb).to(self.device)
        self.batches_per_epoch = nb

    def _restore_cursor(self, meta):
        """The JAX session's resume rules: the saved optimizer's name and
        state-shaping coefficients must match, and the epoch/step cursor
        continues where the snapshot stopped."""
        saved_opt = meta.get("extra", {}).get("optimizer")
        opt = self._opt_config
        if saved_opt is not None:
            if saved_opt["name"] != opt["name"]:
                raise ValueError(
                    f"checkpoint was trained with optimizer "
                    f"{saved_opt['name']!r}; resuming with {opt['name']!r} would "
                    f"silently change the trajectory — pass "
                    f"optimizer={saved_opt['name']!r} to continue it"
                )
            if opt["name"] == "momentum" and saved_opt.get("momentum") != opt["momentum"]:
                raise ValueError(
                    f"checkpoint velocity was accumulated with momentum="
                    f"{saved_opt.get('momentum')}; resuming with momentum="
                    f"{opt['momentum']} would reinterpret it"
                )
            if saved_opt.get("weight_decay", 0.0) != opt["weight_decay"]:
                raise ValueError(
                    f"checkpoint was trained with weight_decay="
                    f"{saved_opt.get('weight_decay', 0.0)}; resuming with "
                    f"weight_decay={opt['weight_decay']} would silently change "
                    f"the trajectory"
                )
        if meta.get("step_in_epoch") is not None:
            # a step snapshot: ``epoch`` is the epoch IN PROGRESS, and the
            # identical data order needs the saved global batch size
            if meta["global_batch_size"] != self.B:
                raise ValueError(
                    f"mid-epoch resume needs the saved data order: checkpoint "
                    f"was taken at global_batch_size={meta['global_batch_size']}, "
                    f"this run uses {self.B}"
                )
            if not 0 <= meta["step_in_epoch"] < self.batches_per_epoch:
                raise ValueError(
                    f"checkpoint step_in_epoch {meta['step_in_epoch']} out of "
                    f"range for {self.batches_per_epoch} batches/epoch — "
                    f"different dataset?"
                )
            self.epoch = int(meta["epoch"])
            self.step_in_epoch = int(meta["step_in_epoch"])
        else:
            # an epoch-boundary snapshot: ``epoch`` is the last COMPLETED one
            self.epoch = int(meta["epoch"]) + 1

    def _check_compatible(self, loaded_spec, what):
        if tuple(loaded_spec.sizes) != tuple(self.spec.sizes):
            raise ValueError(
                f"checkpoint sizes {loaded_spec.sizes} do not match {what}'s "
                f"sizes {self.spec.sizes}"
            )
        if loaded_spec.act != self.spec.act:
            raise ValueError(
                f"checkpoint activation family {loaded_spec.act!r} does not "
                f"match {what}'s {self.spec.act!r}"
            )

    def _require_data(self, what):
        if self._X is None:
            raise RuntimeError(
                f"{what}: this session was built without data_dir and serves "
                "only; pass data_dir= to train or evaluate"
            )

    # -- training -----------------------------------------------------------

    @property
    def global_step(self):
        """Run-lifetime optimizer-step count."""
        return self.epoch * self.batches_per_epoch + self.step_in_epoch

    def train_steps(self, n):
        """Train up to ``n`` optimizer steps of the CURRENT epoch (clipped at
        the epoch boundary): the epoch function over a slice of the batch
        axis, so chunked training applies the same per-batch updates in the
        same order as one whole epoch (bitwise-identical weights), while the
        host regains control between chunks to write step checkpoints.

        Fault injection: every un-fired fault at this chunk's first step
        fires before the dispatch, in spec order (``die`` raises or
        SIGKILLs before the step trains, ``nan``/``flip`` poison the
        weights it reads); a later fault inside the chunk cuts the chunk at
        its step, so it fires at the start of the next call.

        Telemetry, per chunk as ``train_epoch`` per epoch: the chunk's
        digest and step records and health checks, and the ``epoch`` record
        on the call that completes the epoch (``chunked``; after a
        mid-epoch resume with ``steps_counted``). Under health policy
        ``halt`` a finding flushes a snapshot (with a checkpoint directory),
        then raises ``HealthError``.

        Returns ``(steps_trained, epoch_mean_loss_or_None)``: the mean loss
        is reported on the call that completes the epoch, the chunks' means
        recombined sample-weighted (over the steps this session trained)."""
        self._require_data("train_steps")
        if n < 1:
            raise ValueError("n must be >= 1")
        nb = self.batches_per_epoch
        k0 = self.step_in_epoch
        k1 = min(k0 + n, nb)
        g0 = self.epoch * nb + k0
        if self._faults:
            fault = self._faults.first_in(g0, g0 + (k1 - k0))
            while fault is not None and fault.step == g0:
                if fault.kind == "die":
                    self._faults.fire_die(fault)  # SIGKILL never returns
                elif fault.kind == "nan":
                    fault.fired = True
                    self.poison_weights()
                elif fault.kind == "flip":
                    fault.fired = True
                    self.flip_weights()
                fault = self._faults.first_in(g0, g0 + (k1 - k0))
            if fault is not None:
                k1 = k0 + (fault.step - g0)  # the fault lands on a boundary
        epoch_index = self.epoch
        first_dispatch = self._metrics.enabled and not self._epoch_dispatched
        t0 = time.perf_counter()
        with self._metrics.span("train_steps"):
            loss_t, aux = self._dispatch(k0, k1)
            loss = float(loss_t)  # waits for the device
        wall = time.perf_counter() - t0
        if self._digests and self._metrics.enabled:
            self._record_digests(epoch_index, g0, aux["digests"])
        self._epoch_dispatched = True
        steps = k1 - k0
        self.step_in_epoch = k1
        self._epoch_loss_sum += loss * steps
        self._epoch_wall += wall
        self._epoch_steps_counted += steps
        self._epoch_first_dispatch = self._epoch_first_dispatch or first_dispatch
        if self._metrics.enabled:
            self._metrics.counter("samples_trained", steps * self.B)
        epoch_loss = None
        if k1 == nb:
            # loss and samples/s over the steps THIS session trained: after a
            # mid-epoch resume that is the epoch's tail, and the record says so
            counted = self._epoch_steps_counted
            epoch_loss = self._epoch_loss_sum / counted
            if self._metrics.enabled:
                ew = self._epoch_wall
                sps = counted * self.B / ew if ew > 0 else 0.0
                record = dict(
                    epoch=epoch_index, loss=epoch_loss, samples_per_sec=sps,
                    wall_s=ew, chunked=True,
                )
                if counted < nb:
                    record["steps_counted"] = counted
                if self._epoch_first_dispatch:
                    record["includes_compile"] = True
                mfu = self._record_utilization(sps)
                if mfu is not None:
                    record["mfu"] = mfu
                self._metrics.event("epoch", **record)
                self._metrics.counter("epochs_trained")
                self._telemetry.note_step(
                    time.perf_counter(), loss=epoch_loss, step_s=ew,
                    throughput=sps, mfu=mfu,
                )
            self.epoch += 1
            self.step_in_epoch = 0
            self._epoch_loss_sum = 0.0
            self._epoch_wall = 0.0
            self._epoch_steps_counted = 0
            self._epoch_first_dispatch = False
        # flight + health LAST: session state is consistent if 'halt' raises
        self._check_health(epoch_index, loss, aux)
        return steps, epoch_loss

    def train_epoch(self) -> float:
        """One epoch over the training split; returns the mean batch
        training loss (the global-batch-scaled MSE of each batch under its
        pre-update params, averaged over the epoch).

        With a recorder: a ``train_epoch`` span and one ``epoch`` record
        (loss, samples/s, wall, ``mfu``; the grad norm when clipping). The
        first dispatch's record carries ``includes_compile``: its wall holds
        the lazy kernel build and the CUDA context's start."""
        self._require_data("train_epoch")
        self._refuse_pending_faults("train_epoch")
        if self.step_in_epoch != 0:
            raise ValueError(
                f"epoch {self.epoch} is mid-flight at step {self.step_in_epoch} "
                "(resumed or chunked) — use train_steps() to finish it"
            )
        first_dispatch = self._metrics.enabled and not self._epoch_dispatched
        epoch_index = self.epoch
        nb = self.batches_per_epoch
        t0 = time.perf_counter()
        with self._metrics.span("train_epoch"):
            loss_t, aux = self._dispatch(0, nb)
            loss = float(loss_t)  # waits for the device
        if self._digests and self._metrics.enabled:
            self._record_digests(epoch_index, epoch_index * nb, aux["digests"])
        if self._metrics.enabled:
            wall = time.perf_counter() - t0
            samples = nb * self.B
            sps = samples / wall if wall > 0 else 0.0
            record = dict(epoch=epoch_index, loss=loss, samples_per_sec=sps, wall_s=wall)
            if self._gnorm_aux:
                record["grad_norm"] = float(aux["grad_norm"])
            if first_dispatch:
                record["includes_compile"] = True
            mfu = self._record_utilization(sps)
            if mfu is not None:
                record["mfu"] = mfu
            self._metrics.event("epoch", **record)
            if not first_dispatch:  # steady state only
                self._metrics.observe("epoch.seconds", wall)
            self._metrics.counter("epochs_trained")
            self._metrics.counter("samples_trained", samples)
            self._telemetry.note_step(
                time.perf_counter(), loss=loss, step_s=wall, throughput=sps, mfu=mfu,
            )
        self._epoch_dispatched = True
        self.epoch += 1
        self._check_health(epoch_index, loss, aux)
        return loss

    def _check_health(self, epoch_index, loss, aux):
        """The flight recorder and the health checks of one dispatch: per
        step from the flight aux, else (kernel paths, or record_steps=False)
        on the dispatch's mean loss. A ``halt`` finding flushes the halt
        snapshot before the ``HealthError`` propagates."""
        try:
            if self._step_aux:
                self._record_flight(epoch_index, aux)
            elif self._health is not None:
                findings = self._health.check_epoch(epoch_index, [loss])
                self._note_health_findings(findings)
                self._health.dispatch(findings, self._metrics)
        except HealthError:
            self._flush_halt_checkpoint()
            raise

    @property
    def faults_active(self):
        """True when a fault-injection plan is loaded (argument or
        environment): the caller must then use ``train_steps`` so the
        injections land on their steps."""
        return bool(self._faults)

    def _refuse_pending_faults(self, entry):
        """Injections fire at step boundaries, which only ``train_steps``
        has: a whole-epoch or whole-run dispatch would sail past them, and
        a recovery harness expecting the kill would take the uninjected run
        for a survived crash. Refuse instead."""
        if self._faults and self._faults.pending:
            raise ValueError(
                f"{entry}() cannot honor the pending fault injection(s) "
                f"{self._faults.pending!r}: injections land on step "
                "boundaries — drive this run with train_steps()"
            )

    def _state_args(self):
        """The layout's leading state arguments of its epoch/run functions."""
        if self._sequential:
            return (self._params, self._opt_state)
        return (self._stacked, self._flags, self._opt_state)

    def _set_state(self, params, opt_state):
        if self._sequential:
            self._params = params
        else:
            self._stacked = params
            self._eval_stacked_cache = None
        self._opt_state = opt_state

    def _dispatch(self, k0, k1):
        """The epoch function over batches ``[k0, k1)``; returns the mean
        loss (a 0-d tensor) and the telemetry aux dict (None when the
        function was built without one). Audited as the ``epoch_program``,
        or per distinct shorter length as a ``chunk_program`` (under mpmd
        the same stage programs run any length: ``epoch_program``, after
        the runner's ``warm`` audits each stage program). With an AOT
        cache the lockstep and sequential programs resolve through it
        (``epoch_program``, ``chunk_program_<n>``)."""
        full = self._mpmd is not None or k1 - k0 == self.batches_per_epoch
        if self._mpmd is not None and not self._mpmd_warmed and self._audit_on():
            self._mpmd.warm(self._stacked, self._flags, self._opt_state, self._mpmd_resolve)
            self._mpmd_warmed = True
        resolve = None
        if self._mpmd is None:
            label = "epoch_program" if full else f"chunk_program_{k1 - k0}"
            resolve = lambda: self._aot_lookup(  # noqa: E731
                label, None if self._sequential else self._prog, self._train_kernels(),
                self._build_epoch_fn, None if self._sequential else self._lower_train_prog,
            )
        out = self._audited(
            "epoch_program" if full else "chunk_program",
            "epoch_program" if full else ("chunk", k1 - k0),
            self._epoch_fn,
            self._state_args() + (self._X[k0:k1], self._Y[k0:k1]),
            lambda: A.clone_tree(self._state_args()) + (self._X[k0 : k0 + 1], self._Y[k0 : k0 + 1]),
            resolve=resolve,
        )
        self._set_state(out[0], out[1])
        return out[2], (out[3] if len(out) > 3 else None)

    def _build_epoch_fn(self, tables):
        """The lockstep epoch function over ``tables`` (the session's
        lowering, or an AOT cache entry's), made the session's; the
        sequential and MPMD layouts keep theirs."""
        if self._sequential or self._mpmd is not None:
            return self._epoch_fn
        self._prog = tables
        self._epoch_fn = E.make_pipeline_epoch(
            self.mesh, self.spec, tables, self._mubatch_local, self._opt,
            **self._run_kwargs, **self._epoch_aux,
        )
        return self._epoch_fn

    def _lower_train_prog(self):
        """The layout's training program, lowered afresh."""
        return lower_schedule(
            S.SCHEDULES[self.schedule], self.M, self.pp, virtual=self.V,
            backward_split=self._backward_split, recompute=self._recompute,
        )

    # -- the program audit ----------------------------------------------------

    def _audit_on(self):
        return self._metrics.enabled or self._audit_strict or self._aot is not None

    def _audited(self, program, dedup, fn, args, probe_args, contract=None, safety=False,
                 resolve=None):
        """``fn(*args)``, a real dispatch of ``program``, with its audit
        once per ``dedup`` variant when a recorder, ``audit=True`` or an AOT
        cache asks for it (``_audit_before``). With a recorder alone the
        census rides the first real dispatch and adds no launch.
        ``contract``: a callable giving the program's contract (default
        the session's training one); ``safety``: a serving program, whose
        first argument (its params) must come back unwritten; ``resolve``:
        the program's AOT cache lookup (``_aot_lookup``), which gives the
        program to dispatch."""
        if dedup in self._audit_done or not self._audit_on():
            return fn(*args)
        with self._audit_lock:
            if dedup in self._audit_done:
                return fn(*args)
            fn, ride = self._audit_before(program, dedup, fn, probe_args, contract, safety, resolve)
            if not ride:
                return fn(*args)
            out = self._record_audit(
                program, fn, args, contract() if contract is not None else None, safety,
            )
            self._audit_done.add(dedup)
            return out

    def _audit_before(self, program, dedup, fn, probe_args, contract, safety, resolve):
        """What a program's audit does before its first real dispatch (the
        caller holds the audit lock). With an AOT cache and a ``resolve``:
        the program resolves through the cache and is probed on clones
        (``_aot_audit``); under ``audit=True``: the probe on
        ``probe_args()`` (clones of the state it writes and one batch),
        recorded, and a census that breaks the contract raises before the
        real dispatch, so the session's state stays as it was (a failure is
        never latched: a retry probes again). Returns ``(fn, ride)``:
        the program to dispatch, and True when its census is still owed and
        rides the first real dispatch (a recorder alone)."""
        if self._aot is not None and resolve is not None:
            fn = self._aot_audit(program, resolve(), probe_args, contract, safety)
        elif self._audit_strict:
            self._record_audit(
                program, fn, probe_args(), contract() if contract is not None else None, safety,
            )
        else:
            return fn, True
        self._audit_done.add(dedup)
        return fn, False

    def _probe(self, program, fn, args, expected=None, safety=False):
        """Run ``fn(*args)`` under a census and the allocator's peak
        (``program_audit.recording``); -> ``(outputs, the xla_audit
        record's fields, the dispatch-safety mismatches)``."""
        before = A.tensor_versions(args[0]) if safety else None
        with A.recording(self.device, A.tree_nbytes(args)) as (census, memory):
            out = fn(*args)
        rec = A.audit_program(
            census, memory,
            expected=self._expected_comms if expected is None else expected,
            platform=self._audit_platform,
            n_devices=self._cost_model.n_devices,
            device=self.device,
        )
        unsafe = []
        if safety:
            unsafe = A.check_dispatch_safety(before, A.tensor_versions(args[0]), context=program)
            rec["dispatch_safety"] = {"params_checked": len(before), "mismatches": unsafe}
        return out, rec, unsafe

    def _emit_audit(self, program, rec, **fields):
        if self._metrics.enabled:
            self._metrics.audit(program, **fields, **rec)
            self._metrics.flush()  # the mismatch evidence hits the disk first

    def _record_audit(self, program, fn, args, expected=None, safety=False, **fields):
        """Run ``fn(*args)`` under a census (``_probe``), emit the
        ``xla_audit`` record (with ``fields``), and raise
        ``AuditMismatchError``, after the record is flushed: under
        ``audit=True`` on a census that breaks the contract (``expected``,
        default the session's), always on a serving program that wrote its
        params. Returns ``fn``'s outputs."""
        out, rec, unsafe = self._probe(program, fn, args, expected, safety)
        self._emit_audit(program, rec, **fields)
        if self._audit_strict and not rec["census_ok"]:
            raise A.AuditMismatchError(
                f"{program}: compiled collective census disagrees with the "
                f"layout contract (dp={self.dp}, pp={self.pp}, "
                f"zero={self._zero}): " + "; ".join(rec["mismatches"])
            )
        if unsafe:
            raise A.AuditMismatchError("; ".join(unsafe))
        return out

    def _mpmd_resolve(self, label, role, fn, args, expected, safety=False):
        """The MPMD runners' ``warm`` hook: one stage program, run once on
        its example args, recorded as an ``mpmd_stage_program`` (with its
        ``program_label``) against its per-stage contract; an inference
        program must also leave its params unwritten. With an AOT cache the
        stage program resolves through it first (its entry's tables: the
        tick tables the runner plans it from)."""
        dedup = ("mpmd", label)
        if dedup in self._audit_done:
            return
        fields = dict(program_label=label, role=role)
        if self._aot is not None:
            tables = self._lower_inference_prog(1) if role == "infer_fwd" else self._prog
            entry = self._aot_lookup(label, tables, (), lambda _tables: fn)
            self._aot_audit("mpmd_stage_program", entry, lambda: args, lambda: expected, safety, fields)
        else:
            self._record_audit("mpmd_stage_program", fn, args, expected, safety, **fields)
        self._audit_done.add(dedup)

    # -- the AOT program cache ------------------------------------------------

    def _aot_layout(self):
        """The layout half of the AOT cache key (JAX ``_aot_layout``; the
        program's content hash does the invalidation, this keeps distinct
        configurations from sharing a filename)."""
        return (
            tuple(self.spec.sizes), self._act, self.dp, self.pp, self.tp,
            self.V, self.schedule, self.B, self.M, self._precision_name,
            self._kernel_backend, self._slot_rows, self._recompute,
        )

    def _train_kernels(self, with_eval=False):
        """The sources of the kernels a training program launches (none
        off the card, none on the plain mesh backend)."""
        if self.device.type != "cuda":
            return ()
        if self._sequential:
            if self._kernel_path:
                return ("fused_train", "linear_act_fwd") if with_eval else ("fused_train",)
            return ("linear_act_fwd", "linear_act_bwd")
        return ("linear_act_fwd", "linear_act_bwd") if self._kernel_backend == "pallas" else ()

    def _infer_kernels(self):
        """The sources of the kernels an inference program launches."""
        if self.device.type == "cuda" and (self._sequential or self._kernel_backend == "pallas"):
            return ("linear_act_fwd",)
        return ()

    def _analyze(self, tables, program):
        """The static passes over lowered tables (send/recv match, deadlock
        freedom, stash lifetimes; ``analysis.analyze_program``), recorded as
        a ``static_analysis`` record; a violated contract records the
        finding, then raises ``ProgramAnalysisError``. Returns the verdict,
        or None for a program without tables."""
        if not isinstance(tables, TickProgram):
            return None
        try:
            verdict = analyze_program(tables, program=program)
        except ProgramAnalysisError as e:
            if self._metrics.enabled:
                self._metrics.static_analysis(
                    program, passes=["send_recv", "deadlock", "stash"], findings=1, finding=str(e),
                )
                self._metrics.flush()
            raise
        self._record_verdict(program, verdict)
        return verdict

    def _record_verdict(self, program, verdict):
        if verdict is not None and self._metrics.enabled:
            self._metrics.static_analysis(
                program, **{k: v for k, v in verdict.items() if k != "program"}
            )

    def _aot_lookup(self, label, tables, kernels, build, relower=None):
        """Resolve one program through the AOT cache: key it on its label,
        the layout, the fingerprint and its content (``program_text``:
        ``tables``, the session's fresh lowering, and the stems of the
        ``kernels`` libraries), then load its entry. A hit writes the
        entry's libraries into ``build/`` where they are missing and takes
        its tables and verdict instead of the lowering and the analysis; a
        miss (or a corrupt or stale entry) analyses ``tables`` and builds
        the libraries from source. ``build(tables)`` makes the dispatchable
        program; ``relower()`` lowers afresh after an audit mismatch.
        Returns the entry ``_aot_audit`` audits and stores."""
        aot = self._aot
        stems = {_build.library_path(n).stem: n for n in kernels}
        key = aot.key_for(
            label, self._aot_layout(),
            AC.program_text(label, self._kernel_backend, tables, stems),
        )
        entry = dict(
            label=label, key=key, hit=False, tables=tables, verdict=None, libraries={},
            build=build, relower=relower,
        )
        payload = aot.load(key, program=label)
        if payload is not None:
            try:
                got = dict(
                    tables=payload["tables"], verdict=payload["verdict"],
                    libraries=dict(payload["libraries"]),
                )
            except (TypeError, KeyError, ValueError) as e:
                aot.record("fallback", program=label, key=key, reason=f"malformed payload: {e}"[:200])
            else:
                entry.update(got, hit=True)
        if entry["hit"]:
            try:
                for stem, data in entry["libraries"].items():
                    _build.install_library(stem, data)
            except OSError as e:  # the build from source stands in
                aot.record(
                    "fallback", program=label, key=key, reason=f"library install failed: {e}"[:200],
                )
            self._record_verdict(label, entry["verdict"])
        else:
            entry["verdict"] = self._analyze(tables, label)
            if kernels:
                _build.build_all(kernels)
                entry["libraries"] = {
                    stem: _build.library_path(n).read_bytes() for stem, n in stems.items()
                }
        entry["fn"] = build(entry["tables"])
        return entry

    def _aot_audit(self, program, entry, probe_args, contract, safety, fields=None):
        """The audit every program resolved through the AOT cache gets
        before its first dispatch: the probe on ``probe_args()`` against its
        contract. A hit whose census breaks it (or a serving program that
        writes its params) is recorded ``audit_mismatch`` and ``fallback``,
        its tables are dropped and the program is lowered again; a built
        program is probed under the session's rules (``audit=True`` raises)
        and its entry written. Returns the program to dispatch."""
        fields = fields or {}
        expected = contract() if contract is not None else None
        aot, fn = self._aot, entry["fn"]
        if entry["hit"]:
            _, rec, unsafe = self._probe(program, fn, probe_args(), expected, safety)
            if rec.get("census_ok") is not False and not unsafe:
                self._emit_audit(program, rec, **fields)
                return fn
            reason = (
                "; ".join(rec.get("mismatches", ())) if rec.get("census_ok") is False
                else "dispatch-safety: " + "; ".join(unsafe)
            )
            aot.record("audit_mismatch", program=entry["label"], key=entry["key"], reason=reason[:200])
            aot.record("fallback", program=entry["label"], key=entry["key"], reason="audit_mismatch")
            if entry["relower"] is not None:
                entry["tables"] = entry["relower"]()
                entry["verdict"] = self._analyze(entry["tables"], entry["label"])
            fn = entry["build"](entry["tables"])
        self._record_audit(program, fn, probe_args(), expected, safety, **fields)
        aot.store(
            entry["key"],
            {k: entry[k] for k in ("tables", "verdict", "libraries")},
            program=entry["label"],
        )
        return fn

    def _rung_contract(self, n_slots):
        """The forward-only contract of the mesh's inference rung of
        ``n_slots`` slots."""
        return A.expected_comms(
            self.spec, self.dp, self.pp,
            prog=self._lower_inference_prog(n_slots),
            mubatch_size=self._slot_rows // self.dp,
            platform=self._audit_platform,
            precision=self._cost_model.precision,
            tp=self.tp,
            device_name=self._device_name,
        )

    # -- telemetry ----------------------------------------------------------

    def _record_utilization(self, samples_per_sec):
        """The achieved model-FLOP/s and MFU gauges of one dispatch; returns
        the MFU (None when no peak is known for this device)."""
        self._metrics.gauge(
            "achieved_flops_per_sec",
            self._cost_model.achieved_flops_per_sec(samples_per_sec),
        )
        mfu = self._cost_model.mfu(samples_per_sec)
        if mfu is not None:
            self._metrics.gauge("mfu", mfu)
        return mfu

    def _record_flight(self, epoch_index, aux):
        """The host side of the flight recorder: ONE readback of the
        dispatch's per-step aux, the ring, the ``step`` records and the
        per-step health checks (which may raise ``HealthError``)."""
        losses = aux["step_loss"].double().cpu().numpy()
        gns = aux["step_grad_norm"].double().cpu().numpy()
        pns = aux["step_param_norm"].double().cpu().numpy()
        first = self.flight.total_steps  # the ring owns the global numbering
        samples = self.flight.record_epoch(epoch_index, losses, gns, pns, first_step=first)
        if self._metrics.enabled:
            for rec in samples:
                self._metrics.step("train", **rec)
        if self._health is not None:
            findings = self._health.check_epoch(
                epoch_index, losses, gns, pns, first_step=first
            )
            self._note_health_findings(findings)
            self._health.dispatch(findings, self._metrics)

    def _record_digests(self, epoch_index, first_step, dig):
        """One ``digest`` record per step of the dispatch, from ONE readback
        of its digest aux, with the per-global-layer lists in logical layer
        order on every layout (the mesh's ``(S, L)`` grids are indexed
        through the stacked-row order)."""
        host = {k: v.cpu().numpy() for k, v in dig.items()}
        rows = self._digest_layer_index()
        mesh = host["crc_w"].ndim == 3  # (nb, S, L) vs sequential (nb, L)
        for i in range(host["crc_w"].shape[0]):
            fields = {}
            for k, a in host.items():
                col = a[i]
                vals = [col[r, l] for r, l in rows] if mesh else list(col)
                cast = int if k.startswith("crc") else float
                fields[k] = [cast(v) for v in vals]
            self._metrics.digest(
                "train", step=first_step + i, epoch=epoch_index, layers=len(rows),
                **fields,
            )

    def _digest_layer_index(self):
        """Per-global-layer ``(row, slot)`` addresses into the mesh's digest
        grids, in logical layer order: stage ``s``'s layer ``l`` lives at
        the stacked row holding ``s`` (``interleave_order`` when virtual
        stages interleave) and slot ``l``."""
        idx = getattr(self, "_digest_rows", None)
        if idx is None:
            order = self._order or range(self.spec.n_stages)
            row_of = {s: r for r, s in enumerate(order)}
            idx = self._digest_rows = [
                (row_of[s], l)
                for s in range(self.spec.n_stages)
                for l in range(self.spec.stages[s].n_linears)
            ]
        return idx

    def _note_health_findings(self, findings):
        """Feed health findings to the alert rules BEFORE the policy
        dispatch, so the ``training_health`` alert is in the stream when a
        ``halt`` raises."""
        if not findings:
            return
        t = time.perf_counter()
        for f in findings:
            self._telemetry.note_health(t, f["check"])

    def _flush_halt_checkpoint(self):
        """The halt policy's snapshot, before the ``HealthError`` propagates
        (with a checkpoint directory): synchronous whatever the session's
        async setting, after draining the async saves in flight, and not
        rotated. A non-finite finding writes an ``all_finite: false``
        snapshot, which ``resume="auto"`` skips, landing on the last healthy
        step. Best-effort: a failing flush never masks the halt."""
        if self._ckpt_dir is None:
            return
        try:
            self.drain_checkpoints()
        except Exception as e:  # noqa: BLE001 — never mask the HealthError
            print(f"halt checkpoint drain failed: {e}", file=sys.stderr)
        try:
            self.save_step_checkpoint(reason="halt", rotate=False, async_=False)
            self._metrics.flush()
        except Exception as e:  # noqa: BLE001 — never mask the HealthError
            print(f"halt checkpoint flush failed: {e}", file=sys.stderr)

    def train_run(self, epochs: int, with_eval: bool = True):
        """Train ``epochs`` epochs; returns ``(losses, accuracies)`` as lists
        of floats (``accuracies`` None when ``with_eval=False``). The loss
        and accuracy stay on the device until the run ends; each epoch's
        accuracy is one forward over the whole validation split. Under
        ``run_kernel`` the eval-free run is one kernel launch."""
        self._require_data("train_run")
        self._refuse_pending_faults("train_run")
        if epochs <= 0:
            raise ValueError("epochs must be positive")
        if self.runtime == "mpmd":
            raise ValueError(
                "train_run() is the fused ONE-on-device-program contract, "
                "which the MPMD runtime (host-scheduled per-stage programs) "
                "deliberately does not have — drive MPMD sessions with "
                "train_epoch()/train_steps()"
            )
        if self.step_in_epoch != 0:
            raise ValueError(
                f"epoch {self.epoch} is mid-flight at step {self.step_in_epoch} "
                "(resumed or chunked) — finish it with train_steps() before "
                "train_run()"
            )
        if self._digests:
            raise ValueError(
                "digests ride the epoch/step scan aux, which the fused "
                "multi-epoch run program does not thread — drive digest "
                "sessions with train_epoch()/train_steps()"
            )
        fn, evals, probe_args, resolve = self._run_program(with_eval)
        start = self.epoch
        first_dispatch = self._metrics.enabled and not self._epoch_dispatched
        t0 = time.perf_counter()
        with self._metrics.span("train_run"):
            out = self._audited(
                "run_program", ("run", (with_eval, epochs)), fn,
                self._state_args() + (self._X, self._Y) + evals + (epochs,),
                probe_args, resolve=resolve,
            )
            self._set_state(out[0], out[1])
            losses = [float(v) for v in out[2].cpu()]  # waits for the device
            accs = [float(v) for v in out[3].cpu()] if with_eval else None
        wall = time.perf_counter() - t0
        gns = out[-1]["grad_norm"].double().cpu().numpy() if self._gnorm_aux else None
        self._epoch_dispatched = True
        self.epoch += epochs
        if self._metrics.enabled:
            samples = self.batches_per_epoch * self.B
            # one dispatch: the run-mean samples/s is every epoch's
            sps = epochs * samples / wall if wall > 0 else 0.0
            mfu = self._record_utilization(sps)
            for e, loss in enumerate(losses):
                record = dict(
                    epoch=start + e, loss=loss, samples_per_sec=sps,
                    wall_s=wall / epochs, fused_run=True,
                )
                if accs is not None:
                    record["accuracy"] = accs[e]
                if gns is not None:
                    record["grad_norm"] = float(gns[e])
                if first_dispatch and e == 0:
                    record["includes_compile"] = True
                if mfu is not None:
                    record["mfu"] = mfu
                self._metrics.event("epoch", **record)
                self._telemetry.note_step(
                    time.perf_counter(), loss=loss, step_s=wall / epochs,
                    throughput=sps, mfu=mfu,
                )
            self._metrics.observe("run.seconds", wall)
            self._metrics.counter("epochs_trained", epochs)
            self._metrics.counter("samples_trained", epochs * samples)
        if self._health is not None:
            # one dispatch: epoch-granular checks (per-epoch mean loss and,
            # when threaded, mean grad norm)
            findings = self._health.check_run(
                start, losses, None if gns is None else [float(v) for v in gns]
            )
            self._note_health_findings(findings)
            self._health.dispatch(findings, self._metrics)
        return losses, accs

    def warm_run(self, epochs: int, with_eval: bool = True):
        """Resolve everything the next ``train_run(epochs, with_eval)``
        needs without executing it: the kernel libraries it launches
        (built or loaded, or written from the AOT cache), its lowered
        programs and, where its audit runs before the dispatch (an AOT
        cache, ``audit=True``), the probe on clones. The session's params,
        optimizer state and cursor stay bitwise as they were, so e.g. a
        profiler trace around that ``train_run`` captures steady-state
        execution, not the build."""
        if epochs <= 0:
            raise ValueError("epochs must be positive")
        if self.runtime == "mpmd":
            raise ValueError(
                "warm_run() AOT-compiles the fused run program, which the "
                "MPMD runtime does not dispatch — the per-stage programs "
                "warm through the audit/AOT pass on the first epoch"
            )
        self._require_data("warm_run")
        fn, _, probe_args, resolve = self._run_program(with_eval)
        for name in self._train_kernels(with_eval):
            _build.load(name)
        dedup = ("run", (with_eval, epochs))
        if dedup in self._audit_done:
            return
        with self._audit_lock:
            if dedup not in self._audit_done and (self._aot is not None or self._audit_strict):
                self._audit_before("run_program", dedup, fn, probe_args, None, False, resolve)

    def _run_program(self, with_eval):
        """The whole-run program of ``train_run(.., with_eval)``: ``(fn,
        the eval arguments, the probe's arguments, its AOT cache
        lookup)``."""
        if with_eval:
            self._load_val()
        if with_eval not in self._run_fns:
            self._build_run_fn(with_eval, self._run_tables(with_eval))
        evals = ()
        if with_eval:
            evals = (
                (self._vx, self._vy) if self._sequential
                else (self._vx_padded, self._vy_labels)
            )

        def probe_args():
            return A.clone_tree(self._state_args()) + (self._X[:1], self._Y[:1]) + evals + (1,)

        def resolve():
            return self._aot_lookup(
                "run_program_eval" if with_eval else "run_program",
                self._run_tables(with_eval), self._train_kernels(with_eval),
                lambda tables: self._build_run_fn(with_eval, tables),
                lambda: self._run_tables(with_eval, fresh=True),
            )

        return self._run_fns[with_eval], evals, probe_args, resolve

    def _run_tables(self, with_eval, fresh=False):
        """The run program's lowered tables on the mesh (the training
        program, and the eval's one-microbatch inference program), None on
        the sequential layout."""
        if self._sequential:
            return None
        train = self._lower_train_prog() if fresh else self._prog
        return (train, self._lower_inference_prog() if with_eval else None)

    def _build_run_fn(self, with_eval, tables):
        """Build the layout's whole-run function (over ``tables`` on the
        mesh) as the session's for ``with_eval``; returns it."""
        kwargs = dict(self._run_kwargs, with_grad_norm=self._gnorm_aux)
        if self._sequential:
            if with_eval in self._run_fns:
                return self._run_fns[with_eval]
            if not with_eval and self._run_kernel:
                # the eval-free run is one launch of the whole-run kernel;
                # per-epoch eval needs per-epoch params, so the evaluated
                # run loops the epoch kernel
                kwargs.update(epoch_kernel=False, run_kernel=True)
            fn = trainer.make_train_run(self.spec, self._opt, with_eval=with_eval, **kwargs)
        else:
            train, ev = tables
            if with_eval:
                # the whole padded split as one microbatch, one row
                # block per dp replica (the JAX session's fused-run eval)
                kwargs.update(
                    eval_prog=ev, eval_mubatch_size=self._vx_padded.shape[0] // self.dp,
                )
            fn = E.make_pipeline_run(
                self.mesh, self.spec, train, self._mubatch_local, self._opt, **kwargs,
            )
        self._run_fns[with_eval] = fn
        return fn

    # -- evaluation ---------------------------------------------------------

    def _load_val(self):
        if self._vx is None:
            # global_batch_size=1 keeps EVERY validation sample
            val = Dataset(self._data_dir, 1, mubatch_size=1, validation=True)
            val.load(0, 1)
            self._vx = torch.from_numpy(val.input_X).to(self.device)
            self._vy = torch.from_numpy(val.target_y).to(self.device)
            if not self._sequential:
                # the fused run's eval: the split padded to a dp multiple
                n_val = self._vx.shape[0]
                rows = -(-n_val // self.dp) * self.dp
                self._vx_padded = torch.nn.functional.pad(self._vx, (0, 0, 0, rows - n_val))
                self._vy_labels = torch.argmax(self._vy, dim=1)

    def accuracy(self) -> float:
        """Argmax accuracy over the full validation split. On the mesh the
        split flows through the same ladder-capped slot programs
        ``predict()`` dispatches, as in the JAX session."""
        self._require_data("accuracy")
        self._load_val()
        with self._metrics.span("eval"):
            if self._sequential:
                acc = trainer.accuracy(self._predict, self._params, self._vx, self._vy)
            else:
                n_val = self._vx.shape[0]
                preds = self.predict(self._vx.cpu().numpy())
                correct = int((np.argmax(preds, 1) == self._vy_labels.cpu().numpy()).sum())
                acc = correct / max(n_val, 1)
        if self._metrics.enabled:
            self._metrics.gauge("val_accuracy", acc)
        return acc

    # -- serving ------------------------------------------------------------

    @property
    def slot_rows(self):
        """Rows per inference slot."""
        return self._slot_rows

    @property
    def slot_ladder(self):
        """Allowed slot counts per dispatch; the top rung caps a chunk."""
        return self._slot_ladder

    @property
    def sequential(self):
        """True on the single-device reference layout (dp = pp =
        virtual_stages = tp = 1)."""
        return self._sequential

    def predict(self, x):
        """Softmax class probabilities for an ``(n, in_dim)`` batch (host
        numpy in, host numpy out). Rows are padded to whole ``slot_rows``
        slots in chunks of at most the top rung's slots. On the sequential
        layout each occupied slot runs one forward of the fixed slot shape;
        on the mesh the chunk's slots round up the ladder and run as one
        inference program of that rung (``_lower_inference_prog``;
        ``pack_slots`` gives each dp replica its rows of every slot); under
        ``runtime="mpmd"`` every occupied slot is submitted through the
        per-stage chain, then all are resolved (no rung round-up)."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.spec.in_dim:
            raise ValueError(
                f"predict takes (n, {self.spec.in_dim}) rows, got {x.shape}"
            )
        n = x.shape[0]
        out_dim = self.spec.out_dim
        if n == 0:
            return np.zeros((0, out_dim), np.float32)
        S_rows = self._slot_rows
        cap = self._slot_ladder[-1] * S_rows  # rows per ladder-capped chunk
        outs = []
        for i in range(0, n, cap):
            chunk = x[i : i + cap]
            m = serving_slots.slots_needed(chunk.shape[0], S_rows)
            if self._sequential:
                xb = np.pad(chunk, ((0, m * S_rows - chunk.shape[0]), (0, 0)))
                xd = torch.from_numpy(xb).to(self.device)
                preds = torch.cat(
                    [self._predict_slot(xd[k * S_rows : (k + 1) * S_rows]) for k in range(m)],
                    dim=0,
                ).cpu().numpy()
            elif self.runtime == "mpmd":
                # each occupied slot is its own per-stage chain: submit them
                # all before resolving any, so the chains pipeline
                runner = self._mpmd_infer_runner()
                params, fls = self._mpmd_infer_views()
                runner.enter()
                xb = np.pad(chunk, ((0, m * S_rows - chunk.shape[0]), (0, 0)))
                handles = [
                    runner.submit(params, fls, xb[k * S_rows : (k + 1) * S_rows])
                    for k in range(m)
                ]
                preds = np.concatenate([h.result() for h in handles], axis=0)
            else:
                rung = serving_slots.rung_for(m, self._slot_ladder)
                xb = np.pad(chunk, ((0, rung * S_rows - chunk.shape[0]), (0, 0)))
                packed = serving_slots.pack_slots(xb.reshape(rung, S_rows, -1), self.dp)
                xd = torch.from_numpy(packed).to(self.device)
                out = self._audited(
                    "inference_program", ("inference", rung), self._inference_step(rung),
                    (self._eval_stacked(), self._flags, xd),
                    lambda: (A.clone_tree(self._eval_stacked()), self._flags, torch.zeros_like(xd)),
                    contract=lambda: self._rung_contract(rung),
                    safety=True,
                    resolve=lambda: self._aot_lookup(
                        f"inference_r{rung}", self._lower_inference_prog(rung),
                        self._infer_kernels(), lambda tables: self._inference_step(rung, tables),
                        lambda: self._lower_inference_prog(rung),
                    ),
                )
                preds = serving_slots.unpack_slots(out.cpu().numpy(), rung, self.dp)
            outs.append(preds[: chunk.shape[0], :out_dim])
        return np.concatenate(outs, axis=0)

    def _mpmd_infer_runner(self):
        """The streaming MPMD inference runner (mesh mpmd sessions): one
        slot-shaped per-stage forward chain, admission-gated at build, on
        the training runner's stage streams (a stage's reads and updates of
        its rows stay in one stream's order)."""
        if self._mpmd_infer is None:
            runner = mpmd.MpmdInferenceRunner(
                self.mesh, self.spec, self._lower_inference_prog(1),
                self._slot_rows // self.dp, streams=self._mpmd.streams,
            )
            if self._audit_on():
                # each stage program of the chain audited before it serves
                self._join_stages()
                runner.warm(self._stacked, self._flags, self._mpmd_resolve)
            self._mpmd_infer = runner
        return self._mpmd_infer

    def _mpmd_infer_views(self):
        """The inference runner's per-stage views, cached per live stacked
        tensors: a hot reload or a resume replaces ``self._stacked``, which
        invalidates the cache by identity."""
        cached = self._mpmd_infer_view_cache
        if cached is not None and cached[0] is self._stacked and cached[1] is self._flags:
            return cached[2], cached[3]
        params, fls = self._mpmd_infer_runner().views(self._stacked, self._flags)
        self._mpmd_infer_view_cache = (self._stacked, self._flags, params, fls)
        return params, fls

    def predict_async(self, x):
        """MPMD streaming submit (mesh mpmd sessions): issue ONE request of
        up to ``slot_rows`` rows through the per-stage chain and return a
        zero-argument resolver that gives its probabilities (host numpy).
        Nothing blocks at submit, so consecutive requests pipeline across
        the stage streams; each response is bitwise ``predict()``'s."""
        if self._sequential or self.runtime != "mpmd":
            raise ValueError(
                "predict_async streams through the MPMD per-stage chain — "
                "construct the session with runtime='mpmd' (mesh layout)"
            )
        x = np.asarray(x, np.float32)
        n, out_dim = x.shape[0], self.spec.out_dim
        if n < 1 or n > self._slot_rows:
            raise ValueError(
                f"predict_async takes one slot (1..{self._slot_rows} rows); "
                f"got {n} — larger requests go through predict()"
            )
        runner = self._mpmd_infer_runner()
        params, fls = self._mpmd_infer_views()
        runner.enter()
        xb = np.pad(x, ((0, self._slot_rows - n), (0, 0)))
        handle = runner.submit(params, fls, xb)

        def resolve():
            return handle.result()[:n, :out_dim]

        return resolve

    def _join_stages(self):
        """Before a read of the stacked tensors or the optimizer state (or
        before they are replaced): the current stream waits on the MPMD
        stage streams, so it sees every issued update and no stage still
        reads a tensor the session drops. A no-op under lockstep."""
        if self._mpmd is not None:
            self._mpmd.join()

    def _eval_stacked(self):
        """The stacked ``{W, b}`` the inference programs read: the session's
        own on every layout but ZeRO-3, whose params at rest are the
        block-cyclic shards; there the view is rebuilt on the device (one
        gather of every rank's shard) and reused until the shards change.
        Every write to them goes through a method that drops the view:
        ``_set_state`` (a weight update), ``load_weights``,
        ``poison_weights`` and ``flip_weights``."""
        self._join_stages()
        if self._zero != 3:
            return self._stacked
        if self._eval_stacked_cache is None:
            slots, _ = E.zero_block_slots(self.spec, self.pp, self.dp, self.tp)
            self._eval_stacked_cache = E._undeal(
                self._stacked["P"], slots, self.pp, self.dp, self.tp
            )
        return self._eval_stacked_cache

    def _predict_slot(self, xs):
        """The sequential layout's slot-shaped forward of one slot. With an
        AOT cache the slot program resolves through it (``predict_seq``)
        and is audited before its first dispatch, as in the JAX session;
        without one it is not audited."""
        if self._aot is None:
            return self._predict(self._params, xs)
        return self._audited(
            "inference_program", ("inference", "seq"), self._predict, (self._params, xs),
            lambda: (A.clone_tree(self._params), torch.zeros_like(xs)),
            safety=True,
            resolve=lambda: self._aot_lookup(
                "predict_seq", None, self._infer_kernels(), lambda _tables: self._predict,
            ),
        )

    def _inference_step(self, n_slots, tables=None):
        """The mesh's inference program for a ladder rung of ``n_slots``
        slots, built once per rung, or anew over ``tables`` (an AOT cache
        entry's, or a fresh lowering after an audit mismatch)."""
        step = self._predict_cache.get(n_slots)
        if step is None or tables is not None:
            prog = self._lower_inference_prog(n_slots) if tables is None else tables
            step = E.make_pipeline_step(
                self.mesh, self.spec, prog, self._slot_rows // self.dp,
                kernel_backend=self._kernel_backend,
            )
            self._predict_cache[n_slots] = step
        return step

    def _lower_inference_prog(self, mubatches=1):
        """The layout's inference program (interleaved-aware): a ladder
        rung's ``mubatches`` slots for predict, one whole-split microbatch
        for the run's eval."""
        if self.V > 1:
            return lower_schedule(
                S.InterleavedInferenceSchedule, mubatches, self.pp,
                training=False, virtual=self.V,
            )
        return lower_schedule(S.InferenceSchedule, mubatches, self.pp, training=False)

    def inference_latency_bound(self):
        """The analytical latency floor of one request slot through this
        layout's inference program (``costmodel.serving_latency_bound``):
        the slot's FLOPs — on the mesh, the lockstep tick model's weighted
        makespan over the padded slot stack — over the peak of the card
        the session runs on. ``seconds`` is None where no peak is known."""
        return costmodel.serving_latency_bound(
            prog=None if self._sequential else self._lower_inference_prog(1),
            spec=self.spec,
            slot_rows=self._slot_rows,
            dp=self.dp,
            tp=self.tp,
            platform=self._cost_model.platform,
            precision=self._cost_model.precision,
            device_name=self._device_name,
        )

    def measure_dispatch_overhead(self, repeats=2, program="epoch", profile_dir=None):
        """The measured op-issue share (the JAX session's probe): dispatch
        ``repeats`` times uninstrumented (the honest wall), then again
        under ``torch.profiler`` (``spans.capture``; the CUDA activity on a
        CUDA session, which fails loudly when it records no device event),
        and split the uninstrumented wall into op execution and the rest:

            dispatch_overhead = 1 - op_busy_union / host_wall

        ``op_busy_union`` is ``trace_stats.dispatch_busy``'s interval union
        of the device events (kernels, copies, fills), or on the CPU of the
        ``cpu_op`` events. Instrumented ops only run longer, so the share
        is a lower bound; the in-window share rides beside it, with
        ``profiler_inflation``. ``program="epoch"`` dispatches real training
        epochs (the weights advance by up to one warm-up + ``2 x repeats``
        epochs); ``"rung"`` predicts the top ladder rung on zeros (weights
        untouched). ``window_valid`` is False, with its reason, when the
        trace attributes no op or the instrumented window exceeds the
        profiler's 5 s budget; ``events_per_batch`` is the op events per
        dispatched batch. Returns (and records as a ``dispatch_overhead``
        event) the record."""
        from shallowspeed_tpu_torch.observability import trace_stats

        if repeats < 1:
            raise ValueError("repeats must be >= 1")
        if program not in ("epoch", "rung"):
            raise ValueError(f"program must be 'epoch' or 'rung', got {program!r}")
        cuda = self.device.type == "cuda"
        probe_x = np.zeros((self.slot_ladder[-1] * self._slot_rows, self.spec.in_dim), np.float32)
        if program == "epoch":
            dispatch, label = self.train_epoch, "epoch_program"
            warm = not self._epoch_dispatched
        else:
            dispatch, label, warm = (lambda: self.predict(probe_x)), "inference_rung", True
        if warm:
            dispatch()  # the kernel build and first launches outside the windows
        t0 = time.perf_counter()
        for _ in range(repeats):
            dispatch()
        if cuda:
            torch.cuda.synchronize(self.device)
        host_wall_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory(prefix="dispatch_probe_") as tmp:
            cap = capture(profile_dir or tmp, cuda=cuda)
            with cap:
                t1 = time.perf_counter()
                for _ in range(repeats):
                    dispatch()
                if cuda:
                    torch.cuda.synchronize(self.device)
                wall_instrumented_s = time.perf_counter() - t1
            busy = trace_stats.dispatch_busy(cap.path)
        share = trace_stats.dispatch_overhead_share(busy["busy_union_s"], host_wall_s)
        window_budget_s = 5.0  # past this the trace buffer may saturate
        batches = repeats * (self.batches_per_epoch if program == "epoch" else 1)
        window_valid, reason = True, None
        if not busy["op_events"]:
            window_valid, reason = False, "trace holds no attributable op events"
        elif wall_instrumented_s > window_budget_s:
            window_valid = False
            reason = (
                f"instrumented window {wall_instrumented_s:.2f}s exceeds the "
                f"{window_budget_s:g}s profiler budget — the trace buffer may "
                f"have saturated (undercounted ops inflate the overhead share)"
            )
        record = {
            "program": label,
            "runtime": self.runtime,
            "repeats": int(repeats),
            "host_wall_s": host_wall_s,
            "host_wall_instrumented_s": wall_instrumented_s,
            "profiler_inflation": wall_instrumented_s / host_wall_s if host_wall_s else None,
            "device_busy_s": busy["busy_union_s"],
            "device_comm_s": busy["comm_union_s"],
            "device_compute_s": busy["compute_union_s"],
            "op_events": busy["op_events"],
            "op_source": busy["source"],
            "events_per_batch": busy["op_events"] / batches if batches else None,
            "window_valid": window_valid,
            "window_invalid_reason": reason,
            "dispatch_overhead": share,
            "dispatch_overhead_instrumented": trace_stats.dispatch_overhead_share(
                busy["busy_union_s"], wall_instrumented_s
            ),
            "platform": self._cost_model.platform,
            "device_name": self._device_name,
            "provenance": (
                "torch.profiler (Kineto) trace; op-interval union via "
                "trace_stats.dispatch_busy over an uninstrumented wall "
                "(lower bound — instrumented ops only run longer)"
            ),
        }
        if share is None:
            record["reason"] = "trace holds no attributable op events"
        if self._metrics.enabled:
            self._metrics.event("dispatch_overhead", **record)
        return record

    # -- state --------------------------------------------------------------

    def params(self):
        """Logical per-stage params (host numpy copies, which later steps
        never touch), the JAX pytree layout."""
        self._join_stages()
        if self._sequential:
            return convert.params_to_numpy(self._params)
        if self._zero == 3:
            return convert.zero_params_to_numpy(
                self._stacked, self.spec, self.mesh, order=self._order
            )
        return convert.stacked_to_numpy(self._stacked, self.spec, order=self._order)

    def opt_state_logical(self):
        """Stateful-optimizer state in the JAX package's logical form:
        ``{"parts": {key: per-stage list mirroring params()}, "scalars":
        {key: float}}``; None for a stateless optimizer."""
        self._join_stages()
        if self._sequential:
            return convert.opt_state_to_numpy(self._opt, self._opt_state)
        if self._zero:
            return convert.zero_opt_state_to_numpy(
                self._opt, self._opt_state, self.spec, self.mesh, self._zero,
                order=self._order,
            )
        return convert.stacked_opt_state_to_numpy(
            self._opt, self._opt_state, self.spec, order=self._order
        )

    def load_weights(self, path, verified=None):
        """Hot-swap this session's weights from a checkpoint between
        dispatches. The checkpoint must have this session's sizes and
        activation family (refused in the JAX session's words), so every
        cached inference program keeps its shapes: the mesh's rung programs
        take the params at call time and survive the swap. Weights only:
        the optimizer state and the cursor are untouched. Returns the
        metadata; unreadable or corrupt files raise ``CheckpointError``
        before any state changes.

        ``verified=(meta, arrays)``: the pair a ``with_arrays=True``
        discovery (``find_latest_good`` / ``find_newer_good``) already read
        and checksummed; the swap assembles those arrays instead of reading
        the file again, so a reload is ONE verified read."""
        if verified is not None:
            host_params, loaded_spec, meta = assemble_checkpoint(
                path, verified[0], verified[1], self.spec.n_stages, self.B
            )
        else:
            host_params, loaded_spec, meta = load_checkpoint(
                path, self.spec.n_stages, self.B
            )
        if tuple(loaded_spec.sizes) != tuple(self.spec.sizes):
            raise ValueError(
                f"checkpoint sizes {loaded_spec.sizes} do not match this "
                f"session's model sizes {self.spec.sizes} — a hot reload "
                "must preserve every compiled program's shapes"
            )
        if loaded_spec.act != self.spec.act:
            raise ValueError(
                f"checkpoint activation family {loaded_spec.act!r} does not "
                f"match this session's {self.spec.act!r} — a hot reload must "
                "preserve every compiled program's structure"
            )
        self._join_stages()  # no stage still reads the tensors dropped here
        if self._sequential:
            self._params = convert.params_from_numpy(host_params, self.device)
        elif self._zero == 3:
            # re-shard into the session's at-rest block-cyclic layout
            self._stacked = convert.zero_params_from_numpy(
                host_params, self.spec, self.mesh, order=self._order
            )[0]
            self._eval_stacked_cache = None
        else:
            # the session's flags stay: only the weight planes swap
            self._stacked = convert.stacked_from_numpy(
                host_params, self.spec, self.device, order=self._order, tp=self.tp
            )[0]
        return meta

    def model_hash(self) -> str:
        """The reference's weight hash of ``params()`` (``utils.model_hash``):
        the same on every layout, and the JAX package's for the same bytes."""
        return utils.model_hash(self.params())

    def assert_replicas_in_sync(self):
        """The dp replica-sync check. The lockstep executor keeps one
        stacked copy for every dp replica, so it holds by construction;
        ``utils.assert_dp_replicas_in_sync`` checks that layout. ZeRO-3
        keeps no replicated params to check (each rank owns a disjoint
        shard at rest), so it skips, as in the JAX session."""
        if not self._sequential and self._zero != 3:
            self._join_stages()
            utils.assert_dp_replicas_in_sync(self._stacked, self.spec)

    def poison_weights(self):
        """Fault-injection hook (``nan@step=N``): NaN into flat element 0 of
        global layer 0's W, in the live tensor the next step reads."""
        F.poison_nan(self._live_params())
        self._eval_stacked_cache = None

    def flip_weights(self):
        """Fault-injection hook (``flip@step=N``): XOR the lowest mantissa
        bit of the element ``poison_weights`` poisons, in place."""
        F.poison_bitflip(self._live_params())
        self._eval_stacked_cache = None

    def _live_params(self):
        """The params tree the next step reads (the tensors themselves)."""
        self._join_stages()  # a write lands after every issued read
        return Mo.param_tree(self._params) if self._sequential else self._stacked

    # -- checkpoints --------------------------------------------------------

    def save(self, path):
        """Write params, optimizer state and the epoch to ``path`` (the
        JAX session's epoch-boundary snapshot: a resume continues at the
        next epoch). Mid-epoch state needs ``save_step_checkpoint``, whose
        snapshot keeps the step cursor."""
        if self.step_in_epoch != 0:
            raise ValueError(
                f"save() writes an epoch-boundary snapshot, but epoch "
                f"{self.epoch} is at step {self.step_in_epoch}; use "
                "save_step_checkpoint() to keep the step cursor"
            )
        return save_checkpoint(
            path,
            self.params(),
            self.spec,
            self.epoch - 1,
            extra={"optimizer": self._opt_config},
            opt_state=self.opt_state_logical(),
        )

    def save_step_checkpoint(self, reason="step", rotate=True, async_=None):
        """Write the resumable snapshot at the current ``global_step`` into
        the checkpoint directory (``step-<global_step>.npz``: params,
        optimizer state, step cursor, content checksum) and rotate down to
        ``checkpoint_keep``. Returns the path.

        ``async_`` (default: the session's ``async_checkpoint``): keep only
        a host copy of the live state on the step path and hand the
        snapshot build, verification, the write-fsync-rename sequence and
        rotation to the background writer, behind a ``checkpoint_queue``
        deep window whose ``submit`` blocks when full. The stages and their
        crash windows are the synchronous path's (``run_save_stages``); a
        writer-side failure re-raises here at the next save, or at
        ``drain_checkpoints()``/``close()``.

        Rotation is skipped whenever the snapshot just written is
        non-finite or corrupted: a blown-up run's saves must never rotate
        the last healthy snapshot away (``resume="auto"`` skips non-finite
        ones). The snapshot just written counts as trusted. ``rotate=False``
        (the halt flush) skips rotation.

        With a recorder each save emits a ``checkpoint`` record named
        ``reason``: bytes, the verify and write seconds and ``wall_s``, the
        step path's cost (async: the host copy and the enqueue, with the
        queue depth at the enqueue)."""
        if self._ckpt_dir is None:
            raise ValueError("no checkpoint_dir configured on this session")
        if async_ is None:
            async_ = self._async_ckpt_default
        gs, epoch, sie = self.global_step, self.epoch, self.step_in_epoch
        path = step_checkpoint_path(self._ckpt_dir, gs)
        save_seq = self._save_seq
        self._save_seq += 1
        rotate_dir = self._ckpt_dir if rotate else None
        t0 = time.perf_counter()
        # the host copy of the live state: the training steps that follow
        # update the device tensors (in place), never these arrays
        params, opt_state = self.params(), self.opt_state_logical()
        spec, opt_cfg = self.spec, dict(self._opt_config)

        def build():
            return build_snapshot(
                params, spec, epoch, extra={"optimizer": opt_cfg},
                opt_state=opt_state, step_in_epoch=sie, global_step=gs,
            )

        def completion(result, on_path_wall, queue_depth=None):
            # inline (sync) or on the writer thread (async). "trusted", not
            # "all_finite": a corrupt-injected snapshot never verifies
            if result["trusted"]:
                with self._trusted_lock:
                    self._trusted_snapshots.add(str(path))
            if self._metrics.enabled:
                fields = dict(
                    path=str(path), epoch=epoch, step_in_epoch=sie, global_step=gs,
                    bytes=result["bytes"], wall_s=on_path_wall,
                    verify_s=result["verify_s"], write_s=result["write_s"],
                )
                if queue_depth is not None:
                    fields.update(
                        queue_depth=queue_depth, queued_s=result["queued_s"],
                        unstack_s=result.get("unstack_s", 0.0),
                    )
                fields["async"] = queue_depth is not None
                self._metrics.checkpoint(reason, **fields)

        with self._trusted_lock:
            trusted_now = tuple(self._trusted_snapshots)
        if not async_:
            arrays, meta = build()
            result = run_save_stages(
                path, arrays, meta, faults=self._faults, save_seq=save_seq,
                rotate_dir=rotate_dir, rotate_keep=self._ckpt_keep,
                trusted=trusted_now,
            )
            wall = time.perf_counter() - t0
            completion(result, wall)
            if self._metrics.enabled:
                self._telemetry.note_checkpoint(time.perf_counter(), wall)
            return path
        if self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter(
                max_in_flight=self._ckpt_queue, faults=self._faults
            )
        depth = self._ckpt_writer.queue_depth
        # the record carries the wall measured here, on the step path; the
        # handshake lets the writer thread's completion wait for it
        wall_box, measured = {}, threading.Event()

        def job_complete(result):
            measured.wait(timeout=60)
            completion(result, wall_box.get("wall", 0.0), queue_depth=depth)

        self._ckpt_writer.submit(
            path, None, None, save_seq,
            rotate_dir=rotate_dir, rotate_keep=self._ckpt_keep,
            trusted=trusted_now, on_complete=job_complete, build=build,
        )
        wall_box["wall"] = time.perf_counter() - t0
        measured.set()
        if self._metrics.enabled:
            self._telemetry.note_checkpoint(time.perf_counter(), wall_box["wall"])
        return path

    def drain_checkpoints(self):
        """Block until every async snapshot in flight is durable; writer
        failures re-raise here. A no-op when nothing was saved async."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()

    def close(self):
        """Drain and stop the async checkpoint writer, re-raising any writer
        failure, then close the trailing rollup window and flush the
        metrics sink. Idempotent; the session stays usable (a later async
        save starts a new writer)."""
        if self._ckpt_writer is not None:
            writer, self._ckpt_writer = self._ckpt_writer, None
            writer.close()
        self._telemetry.flush()
        self._metrics.flush()
