"""High-level API: a subset of ``shallowspeed_tpu.api.TrainingSession``.

    from shallowspeed_tpu_torch.api import TrainingSession

    run = TrainingSession(data_dir="data/mnist_784")   # flagship MLP on the GPU
    for _ in range(20):
        loss = run.train_epoch()
        print(run.epoch, loss, run.accuracy())
    probs = run.predict(x)                      # (n, 784) numpy -> (n, 10)

    mesh = TrainingSession(dp=2, pp=4, schedule="gpipe",
                           kernel_backend="pallas", data_dir=...)
    chunks = TrainingSession(pp=2, schedule="interleaved", virtual_stages=2,
                             kernel_backend="pallas", data_dir=...)

Two layouts. The sequential one (dp = pp = virtual_stages = 1) and a ``dp``
x ``pp`` mesh run by the lockstep pipeline executor
(``parallel/executor.py``): the schedule's lowered tick tables over a
virtual mesh whose ranks all live on the session's device, with
``kernel_backend="pallas"`` putting every slot of every tick through the
flag kernels (TPU kernels B5-B8; ``"xla"`` is plain torch). The mesh runs
the JAX session's schedule lattice: ``schedule="interleaved"`` with
``virtual_stages`` model stages per device (stacked in
``executor.interleave_order``), ``backward_split`` (2BP, bitwise the
unsplit run), ``recompute`` (bitwise the stashed run) and the gelu family
(``model="transformer"``); the last three on the ``"xla"`` backend, as in
the JAX package. Training: the reference's
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

Not in this slice, and refused with a pointer to their ROADMAP.md item:
ZeRO, gradient buckets and tp (§A item 3), the multi-card runtime
(``runtime="mpmd"``, item 7), and metrics/health/digests (item 4).
"""

import threading

import numpy as np
import torch

from shallowspeed_tpu_torch import convert, resolve_device, trainer, utils
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
from shallowspeed_tpu_torch.optimizer import is_stateless, make_optimizer
from shallowspeed_tpu_torch.parallel import executor as E
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh
from shallowspeed_tpu_torch.serving import slots as serving_slots

# The reference's canonical training configuration.
FLAGSHIP_SIZES = (784, 128, 127, 126, 125, 124, 123, 10)
FLAGSHIP_BATCH = 128
FLAGSHIP_MUBATCHES = 4
FLAGSHIP_LR = 0.006


def _refuse_unported(tp, zero1, zero, grad_bucket_bytes, runtime, metrics, health,
                     digests):
    lattice = [
        (bool(zero1) or bool(zero),
         f"zero={zero if zero is not None else int(bool(zero1))}: ZeRO (next: "
         "stages 1-2 with the gradient buckets, then stage 3)"),
        (bool(grad_bucket_bytes),
         "grad_bucket_bytes: the bucketed gradient sync (it comes with ZeRO "
         "stages 1-2)"),
        (tp != 1, f"tp={tp}: tensor parallelism (after ZeRO)"),
    ]
    for on, what in lattice:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet; the port's executor runs dp x pp "
                "with the naive, gpipe, pipedream and interleaved schedules, "
                "the split backward and recompute (ROADMAP.md §A item 3)"
            )
    if runtime != "lockstep":
        raise NotImplementedError(
            f"runtime={runtime!r}: the multi-card runtime (one process per rank "
            "over torch.distributed) is not ported yet; the port runs the "
            "lockstep executor over a virtual mesh on one device (ROADMAP.md "
            "§A item 7)"
        )
    if metrics is not None or health is not None or digests:
        raise NotImplementedError(
            "metrics, health and digests come with the port's observability "
            "(ROADMAP.md §A item 4)"
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
    ``dp``/``pp``/``schedule`` (naive|gpipe|pipedream|interleaved): the
    mesh layout, run by the lockstep pipeline executor over a virtual mesh
    on the session's device; ``virtual_stages``: model stages per device
    (> 1 needs ``schedule="interleaved"``; the model is cut into ``pp *
    virtual_stages`` stages); ``backward_split``: the two-stage backward
    (B-input at the relay tick, B-weight deferred); ``recompute``: stash
    only each stage's input and re-run its forward before the backward;
    ``kernel_backend``: the executor's per-slot unit, ``"xla"`` (plain
    torch) or ``"pallas"`` (the flag kernels, B5-B8; mesh layouts of the
    relu family only, without split or recompute, as in the JAX package).
    ``tp``, ``zero``/``zero1``, ``grad_bucket_bytes`` and ``runtime`` are
    the JAX session's names for layouts the port does not run yet, and
    ``metrics``, ``health`` and ``digests`` its observability; anything but
    their defaults raises.
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
        digests=False,
        faults=None,
        checkpoint_dir=None,
        checkpoint_keep=3,
        async_checkpoint=False,
        checkpoint_queue=2,
        predict_slot_rows=None,
        predict_slot_ladder=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if precision == "default":
            raise ValueError(
                "precision='default' (the TPU's bf16-input MXU passes) has no "
                "counterpart in the port yet; it computes in IEEE fp32 "
                "(precision='highest') — see ROADMAP.md, Parity rules"
            )
        if precision != "highest":
            raise ValueError(f"precision must be 'highest', got {precision!r}")
        if schedule not in S.SCHEDULES:
            raise ValueError(
                f"schedule must be one of {sorted(S.SCHEDULES)}, got {schedule!r}"
            )
        _refuse_unported(
            tp, zero1, zero, grad_bucket_bytes, runtime, metrics, health, digests
        )
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
        if model is not None:
            sizes, act = Mo.resolve_model(model)
        else:
            act = "relu"
        dp, pp, V = int(dp), int(pp), int(virtual_stages)
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
        self.dp, self.pp, self.tp, self.V = dp, pp, 1, V
        self.schedule = schedule
        self._sequential = dp == 1 and pp == 1 and V == 1
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
        if kernel_backend == "pallas" and self._sequential:
            raise ValueError(
                "kernel_backend='pallas' selects the pipeline executor's "
                "flag-operand kernels and needs a mesh layout (dp/pp > 1 or "
                "virtual_stages > 1); on the sequential path the CUDA kernels "
                "run already — use megakernel=True for the fused train kernel"
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
            resume, verified = self._discover_resume()
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
        if self._sequential:
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
                clip_norm=clip_norm, **kernels,
            )
            self._run_kwargs = dict(
                fuse_mubatches=fuse_mubatches, clip_norm=clip_norm, **kernels
            )
            self._predict = trainer.make_predict(self.spec)
        else:
            # the stacked layout; the flags stay host numpy (the executor
            # decides each tick's work on the host)
            self.mesh = VirtualMesh(dp, pp, self.device)
            self._stacked, self._flags = convert.stacked_from_numpy(
                host_params, self.spec, self.device, order=self._order
            )
            if stateful:
                self._opt_state = convert.stacked_opt_state_from_numpy(
                    self._opt, host_opt_state, self.spec, self.device,
                    order=self._order,
                )
            else:
                self._opt_state = self._opt.init(self._stacked)
            self._prog = lower_schedule(
                S.SCHEDULES[schedule], self.M, pp, virtual=V,
                backward_split=self._backward_split, recompute=self._recompute,
            )
            self._mubatch_local = local_batch // self.M
            self._run_kwargs = dict(clip_norm=clip_norm, kernel_backend=kernel_backend)
            self._epoch_fn = E.make_pipeline_epoch(
                self.mesh, self.spec, self._prog, self._mubatch_local, self._opt,
                **self._run_kwargs,
            )
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

    def _discover_resume(self):
        """``resume="auto"``: the newest step snapshot in the checkpoint
        directory that verifies (checksum, finiteness), as ``(path, (meta,
        arrays))``, or ``(None, None)`` for an empty or missing directory
        (a fresh start). Corrupt, torn and non-finite snapshots are skipped;
        when snapshots exist and none verifies, ``CheckpointError`` names
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
            return None, None
        return path, (meta, arrays)

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

        Returns ``(steps_trained, epoch_mean_loss_or_None)``: the mean loss
        is reported on the call that completes the epoch, the chunks' means
        recombined sample-weighted (over the steps this session trained)."""
        self._require_data("train_steps")
        if n < 1:
            raise ValueError("n must be >= 1")
        nb = self.batches_per_epoch
        k0 = self.step_in_epoch
        k1 = min(k0 + n, nb)
        if self._faults:
            g0 = self.epoch * nb + k0
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
        loss = float(self._run_epoch_fn(k0, k1))  # waits for the device
        steps = k1 - k0
        self.step_in_epoch = k1
        self._epoch_loss_sum += loss * steps
        self._epoch_steps_counted += steps
        epoch_loss = None
        if k1 == nb:
            epoch_loss = self._epoch_loss_sum / self._epoch_steps_counted
            self.epoch += 1
            self.step_in_epoch = 0
            self._epoch_loss_sum = 0.0
            self._epoch_steps_counted = 0
        return steps, epoch_loss

    def train_epoch(self) -> float:
        """One epoch over the training split; returns the mean batch
        training loss (the global-batch-scaled MSE of each batch under its
        pre-update params, averaged over the epoch)."""
        self._require_data("train_epoch")
        self._refuse_pending_faults("train_epoch")
        if self.step_in_epoch != 0:
            raise ValueError(
                f"epoch {self.epoch} is mid-flight at step {self.step_in_epoch} "
                "(resumed or chunked) — use train_steps() to finish it"
            )
        loss = float(self._run_epoch_fn(0, self.batches_per_epoch))  # waits for the device
        self.epoch += 1
        return loss

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
        self._opt_state = opt_state

    def _run_epoch_fn(self, k0, k1):
        """The epoch function over batches ``[k0, k1)``; returns the mean
        loss (a 0-d tensor)."""
        out = self._epoch_fn(*self._state_args(), self._X[k0:k1], self._Y[k0:k1])
        self._set_state(out[0], out[1])
        return out[2]

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
        if self.step_in_epoch != 0:
            raise ValueError(
                f"epoch {self.epoch} is mid-flight at step {self.step_in_epoch} "
                "(resumed or chunked) — finish it with train_steps() before "
                "train_run()"
            )
        if with_eval:
            self._load_val()
        if with_eval not in self._run_fns:
            kwargs = dict(self._run_kwargs)
            if self._sequential:
                if not with_eval and self._run_kernel:
                    # the eval-free run is one launch of the whole-run kernel;
                    # per-epoch eval needs per-epoch params, so the evaluated
                    # run loops the epoch kernel
                    kwargs.update(epoch_kernel=False, run_kernel=True)
                self._run_fns[with_eval] = trainer.make_train_run(
                    self.spec, self._opt, with_eval=with_eval, **kwargs
                )
            else:
                if with_eval:
                    # the whole padded split as one microbatch, one row
                    # block per dp replica (the JAX session's fused-run eval)
                    kwargs.update(
                        eval_prog=self._lower_inference_prog(),
                        eval_mubatch_size=self._vx_padded.shape[0] // self.dp,
                    )
                self._run_fns[with_eval] = E.make_pipeline_run(
                    self.mesh, self.spec, self._prog, self._mubatch_local,
                    self._opt, **kwargs,
                )
        args = self._state_args() + (self._X, self._Y)
        if with_eval:
            args += (
                (self._vx, self._vy) if self._sequential
                else (self._vx_padded, self._vy_labels)
            )
        out = self._run_fns[with_eval](*args, epochs)
        self._set_state(out[0], out[1])
        losses = [float(v) for v in out[2].cpu()]
        accs = [float(v) for v in out[3].cpu()] if with_eval else None
        self.epoch += epochs
        return losses, accs

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
        if self._sequential:
            return trainer.accuracy(self._predict, self._params, self._vx, self._vy)
        n_val = self._vx.shape[0]
        preds = self.predict(self._vx.cpu().numpy())
        correct = int((np.argmax(preds, 1) == self._vy_labels.cpu().numpy()).sum())
        return correct / max(n_val, 1)

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
        virtual_stages = 1)."""
        return self._sequential

    def predict(self, x):
        """Softmax class probabilities for an ``(n, in_dim)`` batch (host
        numpy in, host numpy out). Rows are padded to whole ``slot_rows``
        slots in chunks of at most the top rung's slots. On the sequential
        layout each occupied slot runs one forward of the fixed slot shape;
        on the mesh the chunk's slots round up the ladder and run as one
        inference program of that rung (``_lower_inference_prog``;
        ``pack_slots`` gives each dp replica its rows of every slot)."""
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
                    [
                        self._predict(self._params, xd[k * S_rows : (k + 1) * S_rows])
                        for k in range(m)
                    ],
                    dim=0,
                ).cpu().numpy()
            else:
                rung = serving_slots.rung_for(m, self._slot_ladder)
                xb = np.pad(chunk, ((0, rung * S_rows - chunk.shape[0]), (0, 0)))
                packed = serving_slots.pack_slots(xb.reshape(rung, S_rows, -1), self.dp)
                out = self._inference_step(rung)(
                    self._stacked, self._flags, torch.from_numpy(packed).to(self.device)
                )
                preds = serving_slots.unpack_slots(out.cpu().numpy(), rung, self.dp)
            outs.append(preds[: chunk.shape[0], :out_dim])
        return np.concatenate(outs, axis=0)

    def _inference_step(self, n_slots):
        """The mesh's inference program for a ladder rung of ``n_slots``
        slots, built once per rung."""
        step = self._predict_cache.get(n_slots)
        if step is None:
            prog = self._lower_inference_prog(n_slots)
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
        """The analytical latency floor of one slot. Not known on this card
        yet: the JAX cost model's peaks are TPU numbers and are not carried
        over, so ``seconds`` is None with source ``"unmeasured"``."""
        return {"seconds": None, "ticks": None, "peak_source": "unmeasured"}

    # -- state --------------------------------------------------------------

    def params(self):
        """Logical per-stage params (host numpy copies, which later steps
        never touch), the JAX pytree layout."""
        if self._sequential:
            return convert.params_to_numpy(self._params)
        return convert.stacked_to_numpy(self._stacked, self.spec, order=self._order)

    def opt_state_logical(self):
        """Stateful-optimizer state in the JAX package's logical form:
        ``{"parts": {key: per-stage list mirroring params()}, "scalars":
        {key: float}}``; None for a stateless optimizer."""
        if self._sequential:
            return convert.opt_state_to_numpy(self._opt, self._opt_state)
        return convert.stacked_opt_state_to_numpy(
            self._opt, self._opt_state, self.spec, order=self._order
        )

    def load_weights(self, path):
        """Swap this session's weights from a checkpoint between dispatches.
        The checkpoint must have this session's sizes and activation family.
        Weights only: the optimizer state and the cursor are untouched.
        Returns the metadata; unreadable or corrupt files raise
        ``CheckpointError`` before any state changes."""
        host_params, loaded_spec, meta = load_checkpoint(path, self.spec.n_stages, self.B)
        self._check_compatible(loaded_spec, "this session")
        if self._sequential:
            self._params = convert.params_from_numpy(host_params, self.device)
        else:
            # the session's flags stay: only the weight planes swap
            self._stacked = convert.stacked_from_numpy(
                host_params, self.spec, self.device, order=self._order
            )[0]
        return meta

    def model_hash(self) -> str:
        """The reference's weight hash of ``params()`` (``utils.model_hash``):
        the same on every layout, and the JAX package's for the same bytes."""
        return utils.model_hash(self.params())

    def assert_replicas_in_sync(self):
        """The dp replica-sync check. The lockstep executor keeps one
        stacked copy for every dp replica, so it holds by construction;
        ``utils.assert_dp_replicas_in_sync`` checks that layout."""
        if not self._sequential:
            utils.assert_dp_replicas_in_sync(self._stacked, self.spec)

    def poison_weights(self):
        """Fault-injection hook (``nan@step=N``): NaN into flat element 0 of
        global layer 0's W, in the live tensor the next step reads."""
        F.poison_nan(self._live_params())

    def flip_weights(self):
        """Fault-injection hook (``flip@step=N``): XOR the lowest mantissa
        bit of the element ``poison_weights`` poisons, in place."""
        F.poison_bitflip(self._live_params())

    def _live_params(self):
        """The params tree the next step reads (the tensors themselves)."""
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

    def save_step_checkpoint(self, async_=None):
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
        ones). The snapshot just written counts as trusted."""
        if self._ckpt_dir is None:
            raise ValueError("no checkpoint_dir configured on this session")
        if async_ is None:
            async_ = self._async_ckpt_default
        gs, epoch, sie = self.global_step, self.epoch, self.step_in_epoch
        path = step_checkpoint_path(self._ckpt_dir, gs)
        save_seq = self._save_seq
        self._save_seq += 1
        # the host copy of the live state: the training steps that follow
        # update the device tensors (in place), never these arrays
        params, opt_state = self.params(), self.opt_state_logical()
        spec, opt_cfg = self.spec, dict(self._opt_config)

        def build():
            return build_snapshot(
                params, spec, epoch, extra={"optimizer": opt_cfg},
                opt_state=opt_state, step_in_epoch=sie, global_step=gs,
            )

        def completion(result):
            # inline (sync) or on the writer thread (async). "trusted", not
            # "all_finite": a corrupt-injected snapshot never verifies
            if result["trusted"]:
                with self._trusted_lock:
                    self._trusted_snapshots.add(str(path))

        with self._trusted_lock:
            trusted_now = tuple(self._trusted_snapshots)
        if not async_:
            arrays, meta = build()
            completion(
                run_save_stages(
                    path, arrays, meta, faults=self._faults, save_seq=save_seq,
                    rotate_dir=self._ckpt_dir, rotate_keep=self._ckpt_keep,
                    trusted=trusted_now,
                )
            )
            return path
        if self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter(
                max_in_flight=self._ckpt_queue, faults=self._faults
            )
        self._ckpt_writer.submit(
            path, None, None, save_seq,
            rotate_dir=self._ckpt_dir, rotate_keep=self._ckpt_keep,
            trusted=trusted_now, on_complete=completion, build=build,
        )
        return path

    def drain_checkpoints(self):
        """Block until every async snapshot in flight is durable; writer
        failures re-raise here. A no-op when nothing was saved async."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()

    def close(self):
        """Drain and stop the async checkpoint writer, re-raising any writer
        failure. Idempotent; the session stays usable (a later async save
        starts a new writer)."""
        if self._ckpt_writer is not None:
            writer, self._ckpt_writer = self._ckpt_writer, None
            writer.close()
