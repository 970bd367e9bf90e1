"""Training CLI of the port: a subset of the root ``train.py``.

    python -m shallowspeed_tpu_torch.train [--epochs 20] [--data-dir DIR]
    python -m shallowspeed_tpu_torch.train --device cpu --data-dir DIR
    python -m shallowspeed_tpu_torch.train --fuse-mubatches --epoch-kernel
    python -m shallowspeed_tpu_torch.train --dp 2 --pp 4 --schedule gpipe \
        --kernel-backend pallas
    python -m shallowspeed_tpu_torch.train --pp 2 --schedule interleaved \
        --virtual-stages 2 --kernel-backend pallas
    python -m shallowspeed_tpu_torch.train --pp 4 --schedule gpipe \
        --backward-split --recompute --model transformer
    python -m shallowspeed_tpu_torch.train --dp 2 --pp 4 --zero 2 \
        --grad-bucket-bytes 65536 --kernel-backend pallas
    python -m shallowspeed_tpu_torch.train --dp 2 --pp 2 --tp 2 --zero 2

The reference's recipe by default: the flagship MLP, 20 epochs, global
batch 128 in 4 microbatches, SGD at lr 0.006, with the validation accuracy
before each epoch and at the end, printed as the root ``train.py`` prints
it (``Epoch: N, Time Spent: T s, Accuracy: X%``). Runs on the GPU unless
``--device cpu`` is given; without a GPU it raises. ``--megakernel``,
``--epoch-kernel`` and ``--run-kernel`` (with ``--fuse-mubatches``) train
through the fused train kernel: one launch per batch, per epoch, or per
``--fused-run --no-eval`` run. ``--dp``/``--pp``/``--schedule`` train a
mesh layout through the lockstep pipeline executor (every rank on the one
device), and ``--kernel-backend pallas`` puts its slots through the flag
kernels; ``--schedule interleaved --virtual-stages V``, ``--backward-split``
and ``--recompute`` are the root CLI's schedule lattice, and ``--model
transformer`` takes a mesh layout too (the last three on ``--kernel-backend
xla``, as in the root CLI). ``--zero N`` (``--zero1`` = ``--zero 1``) shards
the optimizer state (1), the gradients (2) and the params at rest (3, on
``--kernel-backend xla``) over dp, and ``--grad-bucket-bytes B`` buckets
the gradient sync (stages 0-2), with the root CLI's refusals. ``--tp N``
Megatron-shards every Linear over N tensor-parallel ranks of the virtual
mesh and composes with all of the above on ``--kernel-backend xla``.
``--runtime mpmd`` trains a mesh layout through the MPMD runtime (one CUDA
stream per pipeline stage, bitwise the lockstep weights, so the hash lines
compare), with the root CLI's refusals. ``--precision highest``,
``--scan-unroll 1`` and ``--tick-unroll 1`` are accepted so that a root CLI
command line runs as it is; other values are refused.

Preemption-safe runs, as the root ``train.py``'s::

    SHALLOWSPEED_FAULTS=die@step=11:mode=sigkill python -m \
        shallowspeed_tpu_torch.train --checkpoint-dir CK \
        --checkpoint-every-steps 4 --epochs 2      # killed at step 11
    python -m shallowspeed_tpu_torch.train --checkpoint-dir CK \
        --checkpoint-every-steps 4 --epochs 2 --resume auto

``--checkpoint-every-steps`` dispatches each epoch in chunks cut at the
step grid (the same weights as whole epochs) and writes a step checkpoint
at each grid step; ``--resume auto`` continues from the newest one that
verifies, with ``--epochs`` as the run's TOTAL target. The run ends, as the
root CLI's, with the accuracy line, ``DP replicas in sync ✓`` at dp > 1,
and ``final model hash: <sha1>``, so the two runs' hash lines compare.
Exit code 4 (``CHECKPOINT UNRECOVERABLE:``) when the checkpoint to resume
from, or every snapshot in the directory, fails verification.

Telemetry, as the root CLI's::

    python -m shallowspeed_tpu_torch.train --device cpu --data-dir D \
        --epochs 1 --metrics-out m.jsonl --health warn --digests
    python -m shallowspeed_tpu_torch.observability.report m.jsonl

``--metrics-out`` writes the schema-v13 JSONL (``telemetry written:``
ends the run), ``--health record|warn|halt`` checks every step (``halt``
exits 3 with ``HEALTH HALT:``), ``--digests`` streams per-layer digests,
``--profile-dir`` writes a ``torch.profiler`` trace of one epoch, and
``--dispatch-probe`` measures the share of an epoch's wall the device is
idle after the hash line (``--dispatch-probe-out`` also writes it as a
bench record). ``--audit`` holds every program the run dispatches to the
layout's comms contract before its first dispatch (the census of the
executor's data movers, ``observability/program_audit.py``): a mismatch
prints ``AUDIT MISMATCH:`` and exits 1; with ``--metrics-out`` every
program's ``xla_audit`` record (census, allocator peak, the contract) lands
in the stream, as it does for any recorded run.
"""

import argparse
import contextlib
import json
import os
import sys
import time


def build_parser():
    """The CLI's argument parser (the root ``train.py``'s flags that the port
    runs, with its help texts)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=1, help="data-parallel replicas")
    ap.add_argument("--pp", type=int, default=1, help="pipeline stages")
    ap.add_argument(
        "--tp", type=int, default=1,
        help="tensor (model-axis) parallelism: shard every Linear "
        "Megatron-style across tp ranks — even layers column-parallel "
        "(W split on the output dim, no forward collective), odd layers "
        "row-parallel (W split on the input dim, one all-reduce over tp) — "
        "so each fwd+bwd pass costs 2 all-reduces per layer pair and "
        "per-rank weight memory/matmul FLOPs drop by tp. Composes with "
        "--dp/--pp/--zero/--grad-bucket-bytes/--backward-split into a "
        "dp x pp x tp lattice (every rank on the one device; "
        "--kernel-backend xla)",
    )
    ap.add_argument(
        "--schedule", choices=["naive", "gpipe", "pipedream", "interleaved"],
        default="naive",
        help="pipeline schedule (ignored unless --pp > 1); 'interleaved' is "
        "Megatron-style virtual-stage 1F1B (use with --virtual-stages)",
    )
    ap.add_argument(
        "--virtual-stages", type=int, default=1,
        help="virtual stages per device for --schedule interleaved: the model "
        "is cut into pp x V stages, stage s on device s %% pp — the "
        "pipeline-fill bubble shrinks ~V-fold (beyond the reference)",
    )
    ap.add_argument(
        "--backward-split", action="store_true",
        help="pipeline schedules (gpipe/pipedream/naive): two-stage backward "
        "— each microbatch's backward is split into the relay-critical "
        "B-input (d(loss)/d(input), at exactly the tick the combined "
        "backward would run, so upstream stages never wait longer) and a "
        "deferred B-weight (dW/db from the stashed activation + output-"
        "grad) packed into otherwise-idle bubble ticks (2BP, arXiv "
        "2405.18047). Bitwise-identical weights (the weight-grad "
        "accumulation order is preserved)",
    )
    ap.add_argument(
        "--recompute", action="store_true",
        help="pipeline schedules: activation recompute — forwards stash "
        "only the stage INPUT, and the stage forward re-runs inside the "
        "backward tick (OP_RECOMPUTE), shrinking the activation-stash "
        "lifetime from fwd->bwd to recompute->bwd. Bitwise-identical "
        "weights vs stashed training; mesh layouts only, not interleaved",
    )
    ap.add_argument(
        "--runtime", choices=["lockstep", "mpmd"], default="lockstep",
        help="pipeline runtime (mesh layouts): 'lockstep' runs the whole "
        "lattice as one tick loop (every rank's cell of a tick, then the "
        "relays — the correctness oracle); 'mpmd' issues one program per "
        "stage role from the host, each stage on its own CUDA stream, with "
        "event-ordered relays between the stages (arXiv 2412.14374) — "
        "bitwise-identical weights, no noop-tick dispatches. mpmd drives "
        "the epoch loop (no --fused-run) and excludes --zero1/--zero/"
        "--grad-bucket-bytes/--clip-norm/--kernel-backend pallas for now",
    )
    ap.add_argument(
        "--kernel-backend", choices=["xla", "pallas"], default="xla",
        help="mesh layouts (--dp/--pp > 1): per-slot compute unit inside "
        "every pipeline tick — 'pallas' runs each slot through the "
        "hand-written flag kernels (the same math), 'xla' through plain "
        "torch ops. Sequential path: use --megakernel",
    )
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--global-batch-size", type=int, default=128)
    ap.add_argument("--mubatches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.006)
    ap.add_argument("--optimizer", choices=["sgd", "momentum", "adam"], default="sgd")
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument(
        "--zero1",
        action="store_true",
        help="ZeRO-1: shard the optimizer state + update over the dp axis "
        "(reduce_scatter grads, per-replica chunk update, all_gather params; "
        "mesh layouts only — beyond the reference). Alias for --zero 1",
    )
    ap.add_argument(
        "--zero",
        type=int,
        choices=[0, 1, 2, 3],
        default=None,
        help="ZeRO stage on the dp axis (mesh layouts; supersedes --zero1): "
        "0 = replicate everything (the anchor all-reduce sync); 1 = shard "
        "the optimizer state + update; 2 = gradients also live as "
        "persistent reduce-scattered per-rank shards (composes with "
        "--grad-bucket-bytes; bitwise-equal weights to --zero 1 at the "
        "same layout); 3 = parameters sharded at rest too, all-gathered "
        "just-in-time per layer inside the tick loop (per-tick gradient "
        "reduce-scatter; bitwise the anchor --zero 2 run)",
    )
    ap.add_argument(
        "--grad-bucket-bytes",
        type=int,
        default=0,
        help="mesh layouts: bucket the DP gradient sync — the backward-"
        "ordered gradient tree is greedily packed into buckets of at most "
        "this many bytes and each bucket is synced by its OWN sum "
        "(all-reduce; reduce-scatter slice under --zero1/--zero 2), the "
        "JAX package's overlap unit. 0 (default) keeps the single "
        "whole-tree anchor sum. Bitwise-identical numerics either way",
    )
    ap.add_argument(
        "--weight-decay", type=float, default=0.0,
        help="decoupled weight decay, uniform over every param element "
        "(0 = reference parity)",
    )
    ap.add_argument(
        "--clip-norm", type=float, default=None,
        help="global-norm gradient clipping over all params; off by default",
    )
    ap.add_argument(
        "--precision", choices=["highest", "default"], default="highest",
        help="matmul precision: 'highest' = IEEE fp32 (the only one the port "
        "computes); 'default' (the TPU's bf16-input passes) is refused",
    )
    ap.add_argument(
        "--scan-unroll", type=int, default=1,
        help="the root CLI's lax.scan unroll factor of the epoch loop (an XLA "
        "compile knob); the port's loop is eager, so only 1 is accepted",
    )
    ap.add_argument(
        "--tick-unroll", type=int, default=1,
        help="the root CLI's lax.scan unroll factor of the pipeline tick loop "
        "(an XLA compile knob); the port's loop is eager, so only 1 is accepted",
    )
    ap.add_argument(
        "--fuse-mubatches", action="store_true",
        help="one full-batch forward/backward per step instead of the "
        "microbatch loop (the same training)",
    )
    ap.add_argument(
        "--megakernel", action="store_true",
        help="with --fuse-mubatches (SGD, momentum or adam): run each training "
        "batch as ONE CUDA kernel — forward, head, backward and update in a "
        "single launch (the same training)",
    )
    ap.add_argument(
        "--epoch-kernel", action="store_true",
        help="with --fuse-mubatches (SGD, momentum or adam): run each ENTIRE "
        "epoch as one CUDA kernel — params and optimizer state stay on the "
        "card across the epoch's batches (one launch per epoch instead of "
        "one per batch)",
    )
    ap.add_argument(
        "--run-kernel", action="store_true",
        help="with --fuse-mubatches (SGD, momentum or adam): run the whole "
        "multi-epoch training run as ONE CUDA kernel when dispatched via "
        "--fused-run --no-eval. Per-epoch runs and the evaluated fused run "
        "ride the epoch kernel",
    )
    ap.add_argument(
        "--model", choices=["mnist-mlp", "mlp-wide", "mlp-deep", "transformer"],
        default=None, help="model-zoo configuration (default: the flagship sizes)",
    )
    ap.add_argument(
        "--data-dir", default=None,
        help="the split to train on (default $SHALLOWSPEED_DATA_DIR or "
        "data/mnist_784; make one with prepare_data.py)",
    )
    ap.add_argument("--no-eval", action="store_true", help="skip per-epoch accuracy")
    ap.add_argument(
        "--fused-run", action="store_true",
        help="run all epochs through one train_run() call (the accuracies "
        "and losses come back together at the end)",
    )
    ap.add_argument(
        "--checkpoint", default=None,
        help="path to save a checkpoint after each epoch (with --fused-run: "
        "once, after the run)",
    )
    ap.add_argument(
        "--checkpoint-dir", default=None,
        help="directory for preemption-safe STEP checkpoints "
        "(step-<global_step>.npz, atomic and checksummed) — needed by "
        "--checkpoint-every-steps and --resume auto",
    )
    ap.add_argument(
        "--checkpoint-every-steps", type=int, default=0, metavar="N",
        help="write a step checkpoint into --checkpoint-dir every N optimizer "
        "steps (0 = off); the epoch is dispatched in N-step chunks, the same "
        "weights as whole epochs",
    )
    ap.add_argument(
        "--keep", type=int, default=3, metavar="K",
        help="step-checkpoint retention: keep the newest K snapshots",
    )
    ap.add_argument(
        "--async-checkpoint", action="store_true",
        help="write step checkpoints through the background writer: the step "
        "path pays only a host copy of the state and an enqueue; the run "
        "drains the writer before it exits",
    )
    ap.add_argument(
        "--resume", default=None,
        help="checkpoint to continue from (params, optimizer state, cursor; "
        "--epochs more epochs are trained), or 'auto': the newest VERIFYING "
        "step checkpoint in --checkpoint-dir (a fresh start when there is "
        "none), with --epochs as the run's TOTAL epoch target"
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)",
    )
    ap.add_argument(
        "--metrics-out", default=None,
        help="record structured training telemetry (per-epoch loss, "
        "samples/s, MFU, per-step flight records, spans, pipeline program "
        "stats) to this JSONL file; render it with `python -m "
        "shallowspeed_tpu_torch.observability.report FILE`",
    )
    ap.add_argument(
        "--health", choices=["record", "warn", "halt"], default=None,
        help="numerics health monitor over the per-step flight aux "
        "(NaN/Inf, rolling-window loss divergence, grad-norm spikes): "
        "'record' emits health records into --metrics-out, 'warn' also "
        "prints them, 'halt' additionally aborts the run (exit 3) at the "
        "first finding, naming the blown-up step",
    )
    ap.add_argument(
        "--digests", action="store_true",
        help="numerics provenance: per-step per-LAYER digests (checksums of "
        "every post-update (W, b) block + param/grad block norms) streamed "
        "as digest records to --metrics-out; compare two runs with `python "
        "-m shallowspeed_tpu_torch.observability.divergence A.jsonl B.jsonl`",
    )
    ap.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of one training epoch to this directory",
    )
    ap.add_argument(
        "--dispatch-probe", action="store_true",
        help="after training, dispatch extra training epochs under the "
        "profiler and report the share of host wall NOT covered by op "
        "execution; it runs after the final model hash is printed (the "
        "probe TRAINS the epochs it times)",
    )
    ap.add_argument(
        "--dispatch-probe-out", default=None, metavar="JSON",
        help="also write the probe's measurement as a versioned bench record "
        "(bench: dispatch_overhead) to this file; implies --dispatch-probe",
    )
    ap.add_argument(
        "--audit",
        action="store_true",
        help="program audit: census the data movers of every program (relays, "
        "dp/tp all-reduces, ZeRO reduce-scatters and all-gathers) and verify "
        "them against the layout's analytical comms contract — a mismatch "
        "aborts BEFORE the program's first dispatch. With --metrics-out the "
        "full audit (census, allocator memory peak, bytes/step comms model) "
        "lands as a schema-v3 xla_audit record; the report CLI renders its "
        "memory and comms sections",
    )
    return ap


def parse_args(argv=None, ap=None):
    """``argv`` parsed and checked before any device or data is touched:
    an incoherent command line exits 2 with the root CLI's words. ``zero``
    comes back resolved (``--zero1`` is stage 1)."""
    ap = ap or build_parser()
    args = ap.parse_args(argv)
    # incoherent fault-tolerance flags fail at parse time, before any device
    # or data is touched (the root train.py's checks and words)
    if args.checkpoint_every_steps < 0:
        ap.error("--checkpoint-every-steps must be >= 0")
    if args.checkpoint_every_steps and args.checkpoint_dir is None:
        ap.error("--checkpoint-every-steps needs --checkpoint-dir")
    if args.checkpoint_every_steps and args.fused_run:
        ap.error(
            "--checkpoint-every-steps is incompatible with --fused-run: the "
            "fused run is ONE dispatch, so there is no step boundary for the "
            "host to checkpoint at — drop --fused-run for preemption-safe runs "
            "(--checkpoint still saves once after the fused dispatch)"
        )
    if args.resume == "auto" and args.checkpoint_dir is None:
        ap.error("--resume auto discovers snapshots in --checkpoint-dir")
    if args.async_checkpoint and args.checkpoint_dir is None:
        ap.error("--async-checkpoint needs --checkpoint-dir")
    if args.resume == "auto" and args.fused_run:
        ap.error(
            "--resume auto may land mid-epoch, and the fused run has no "
            "mid-epoch entry point — drop --fused-run to recover"
        )
    if args.keep < 1:
        ap.error("--keep must be >= 1")
    if args.runtime == "mpmd" and args.fused_run:
        ap.error(
            "--runtime mpmd schedules per-stage programs from the host; "
            "the fused ONE-dispatch run is a lockstep contract — drop "
            "--fused-run (the epoch loop dispatches MPMD)"
        )
    if args.runtime == "mpmd" and (args.dp, args.pp, args.tp) == (1, 1, 1):
        ap.error(
            "--runtime mpmd needs a mesh layout (dp/pp/tp > 1): the "
            "sequential path has no pipeline stages to decompose"
        )
    if args.precision == "default":
        from shallowspeed_tpu_torch.api import PRECISION_DEFAULT_REFUSAL

        ap.error(PRECISION_DEFAULT_REFUSAL)
    for flag, v, loop in (
        ("--scan-unroll", args.scan_unroll, "the per-batch epoch loop"),
        ("--tick-unroll", args.tick_unroll, "the pipeline tick loop"),
    ):
        if v != 1:
            ap.error(
                f"{flag} {v}: the root CLI's flag sets the lax.scan unroll "
                f"factor of {loop}, a knob of XLA's compiled program with "
                "bit-identical numerics; the port runs that loop eagerly in "
                f"Python and has nothing to unroll — pass {flag} 1 or drop it"
            )
    if args.recompute and (args.dp, args.pp, args.tp) == (1, 1, 1):
        ap.error(
            "--recompute drops pipeline activation stashes; the "
            "sequential path holds no cross-tick stash — use a mesh "
            "layout (dp/pp/tp > 1)"
        )
    if args.recompute and args.virtual_stages > 1:
        ap.error(
            "--recompute is not supported with interleaved virtual "
            "stages (the chunked stash rotation is its own lifetime "
            "discipline)"
        )
    if args.zero1 and args.zero is not None and args.zero != 1:
        ap.error(
            f"conflicting dp-stage selectors: --zero1 and --zero {args.zero} "
            "— pass only --zero"
        )
    zero_stage = args.zero if args.zero is not None else (1 if args.zero1 else 0)
    if zero_stage == 3 and args.fused_run:
        ap.error(
            "--zero 3 is incompatible with --fused-run: the fused "
            "multi-epoch run's eval step consumes the full stacked layout "
            "every epoch, but stage 3 keeps parameters sharded at rest — "
            "drop --fused-run (the per-epoch loop dispatches ZeRO-3)"
        )
    if zero_stage == 3 and args.kernel_backend == "pallas":
        ap.error(
            "--zero 3 is incompatible with --kernel-backend pallas: the "
            "fused slot kernels consume resident {W, b} operands, but "
            "stage 3 materializes parameters per tick via all-gather — "
            "drop one of the two flags"
        )
    if zero_stage == 3 and args.grad_bucket_bytes:
        ap.error(
            "--zero 3 syncs gradients per tick (reduce-scatter into the "
            "persistent shard carry) — there is no tail collective for "
            "--grad-bucket-bytes to bucket; drop one of the two flags"
        )
    if zero_stage and args.runtime == "mpmd":
        ap.error(
            f"--runtime mpmd does not support --zero {zero_stage} yet: the "
            "ZeRO reduce-scatter/all-gather tail assumes the lockstep SPMD "
            "program's dp axis — drop one of the two flags"
        )
    if zero_stage >= 2 and args.digests:
        ap.error(
            f"--digests is incompatible with --zero {zero_stage}: the "
            "digest taps read the zero1 flat-chunk segment map, which "
            "stages 2-3 replace with the block-cyclic shard layout — drop "
            "one of the two flags"
        )
    if args.digests and args.fused_run:
        ap.error(
            "--digests rides the epoch/step scan aux, which the fused "
            "multi-epoch run program does not thread — drop --fused-run "
            "(the epoch/step loops stream digest records)"
        )
    faults_env = os.environ.get("SHALLOWSPEED_FAULTS", "")
    if args.fused_run and any(p.strip() for p in faults_env.split(",")):
        ap.error(
            f"SHALLOWSPEED_FAULTS={faults_env!r} is set but --fused-run "
            "dispatches the whole run at once — step-granular injections can "
            "never fire, and a recovery harness would mistake the uninjected "
            "run for a survived crash; drop --fused-run (the fault harness "
            "needs the step loop)"
        )
    args.zero = zero_stage
    return args


def main(argv=None):
    ap = build_parser()
    args = parse_args(argv, ap)

    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.checkpoint import CheckpointError
    from shallowspeed_tpu_torch.data import default_data_dir
    from shallowspeed_tpu_torch.observability import HealthError, JsonlMetrics
    from shallowspeed_tpu_torch.observability.program_audit import AuditMismatchError

    metrics = JsonlMetrics(args.metrics_out) if args.metrics_out else None
    try:
        run = TrainingSession(
            metrics=metrics,
            health=args.health,
            digests=args.digests,
            audit=args.audit,
            dp=args.dp,
            pp=args.pp,
            tp=args.tp,
            schedule=args.schedule,
            virtual_stages=args.virtual_stages,
            backward_split=args.backward_split,
            recompute=args.recompute,
            kernel_backend=args.kernel_backend,
            runtime=args.runtime,
            zero=args.zero,
            grad_bucket_bytes=args.grad_bucket_bytes,
            model=args.model,
            global_batch_size=args.global_batch_size,
            mubatches=args.mubatches,
            lr=args.lr,
            data_dir=args.data_dir or default_data_dir(),
            resume=args.resume,
            fuse_mubatches=args.fuse_mubatches,
            megakernel=args.megakernel,
            epoch_kernel=args.epoch_kernel,
            run_kernel=args.run_kernel,
            optimizer=args.optimizer,
            momentum=args.momentum,
            weight_decay=args.weight_decay,
            clip_norm=args.clip_norm,
            precision=args.precision,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_keep=args.keep,
            async_checkpoint=args.async_checkpoint,
            device=args.device,
        )
    except CheckpointError as e:
        # the snapshot to resume from, or every one in the directory, fails
        # verification: a distinct exit code, so a caller can tell "restore
        # is impossible" from a crash
        print(f"CHECKPOINT UNRECOVERABLE: {e}", file=sys.stderr)
        if metrics is not None:
            metrics.close()
        return 4
    if args.fused_run and run.step_in_epoch > 0:
        if metrics is not None:
            metrics.close()
        ap.error(
            f"--resume {args.resume} restored a mid-epoch cursor (epoch "
            f"{run.epoch}, step {run.step_in_epoch}); drop --fused-run to "
            "finish the epoch step by step"
        )
    note = ""
    if args.resume:
        if run.resumed_from is not None:
            note = f" resumed at epoch {run.epoch}"
            if run.step_in_epoch:
                note += f", step {run.step_in_epoch}"
        else:  # --resume auto on an empty checkpoint directory
            note = " no resumable checkpoint found — fresh start"
    if run.sequential:
        layout = "sequential"
    elif args.virtual_stages > 1:
        layout = f"interleaved pipeline, V={args.virtual_stages}"
    elif args.pp > 1:
        layout = f"{args.schedule} pipeline"
    elif args.dp > 1:
        layout = "data-parallel"
    else:
        layout = "tensor-parallel"
    if args.tp > 1 and layout != "tensor-parallel":
        layout += " + tensor-parallel"
    if args.runtime == "mpmd":
        layout += ", mpmd runtime"
    print(
        f"devices=[{run.device}] layout: DP={args.dp} x PP={args.pp} x "
        f"TP={args.tp} ({layout}) batches/epoch={run.batches_per_epoch}" + note
    )

    t0 = time.time()
    try:
        final_acc = _train(run, args, t0, metrics)
    except HealthError as e:
        # --health halt fired: the finding is recorded and the halt snapshot
        # flushed; a distinct exit code tells "numerics blew up" from a crash
        print(f"HEALTH HALT: {e}", file=sys.stderr)
        run.close()
        if metrics is not None:
            metrics.close()
            print(f"telemetry written: {metrics.path}")
        return 3
    except AuditMismatchError as e:
        # a program broke the layout's comms contract before it dispatched:
        # the evidence record is flushed, the state untouched
        print(f"AUDIT MISMATCH: {e}", file=sys.stderr)
        run.close()
        if metrics is not None:
            metrics.close()
            print(f"telemetry written: {metrics.path}")
        return 1
    except BaseException:
        # every exceptional exit drains the async writer, so no accepted
        # snapshot is stranded in its queue; a drain failure must not mask
        # the exception already propagating
        try:
            run.close()
        except Exception as e:  # noqa: BLE001 — never mask the exit
            print(f"checkpoint writer drain failed: {e}", file=sys.stderr)
        raise
    # a clean exit leaves every accepted snapshot durable: writer failures
    # re-raise here and fail the run
    run.close()
    print(
        f"Epoch: {run.epoch}, Time Spent: {time.time() - t0:.2f}s, "
        f"Accuracy: {final_acc * 100:.2f}%"
    )
    run.assert_replicas_in_sync()
    if args.dp > 1:
        print("DP replicas in sync ✓")
    print("final model hash:", run.model_hash())
    if args.dispatch_probe or args.dispatch_probe_out:
        _dispatch_probe(run, args)
    if metrics is not None:
        run.close()
        metrics.close()
        print(f"telemetry written: {metrics.path}")
    return 0


def _dispatch_probe(run, args):
    """The measured op-issue share, after the hash line (the probe trains
    the epochs it times), printed as the root CLI prints it; with
    ``--dispatch-probe-out`` also written as a bench record."""
    rec = run.measure_dispatch_overhead()
    share = rec["dispatch_overhead"]
    if share is None:
        print("dispatch overhead: unmeasurable — " + rec.get("reason", "no op events"))
    else:
        print(
            f"dispatch overhead: >= {share * 100:.1f}% of epoch wall is "
            f"host-side op issue (op busy {rec['device_busy_s'] * 1e3:.1f} ms "
            f"of {rec['host_wall_s'] * 1e3:.1f} ms uninstrumented wall over "
            f"{rec['repeats']} epoch(s); {rec['op_events']} op events, source "
            f"{rec['op_source']}, profiler inflation "
            f"{rec['profiler_inflation']:.2f}x)"
        )
    if not rec["window_valid"]:
        print("dispatch-probe window INVALID: " + (rec["window_invalid_reason"] or "unknown"))
    if args.dispatch_probe_out:
        from shallowspeed_tpu_torch.observability.metrics import json_safe

        bench_rec = {
            "bench": "dispatch_overhead",
            "bench_version": 1,
            "config": {
                "dp": args.dp, "pp": args.pp, "tp": args.tp, "schedule": args.schedule,
                "global_batch_size": args.global_batch_size,
                "mubatches": args.mubatches, "backward_split": args.backward_split,
                "grad_bucket_bytes": args.grad_bucket_bytes, "platform": rec["platform"],
                "device_name": rec["device_name"],
            },
            "value": share,
            "unit": "fraction of epoch wall not covered by op execution",
            **{
                k: rec[k]
                for k in (
                    "program", "runtime", "repeats", "host_wall_s",
                    "host_wall_instrumented_s", "profiler_inflation",
                    "device_busy_s", "device_comm_s", "device_compute_s",
                    "op_events", "op_source", "events_per_batch", "window_valid",
                    "window_invalid_reason", "dispatch_overhead_instrumented",
                    "provenance",
                )
            },
        }
        with open(args.dispatch_probe_out, "w", encoding="utf-8") as f:
            f.write(json.dumps(json_safe(bench_rec), indent=2, allow_nan=False) + "\n")
        print(f"dispatch-overhead record written: {args.dispatch_probe_out}")


def _train(run, args, t0, metrics):
    """The epochs of the run, printing the root CLI's lines (``t0``: the
    run's start on the host clock); returns the final accuracy. With
    ``--profile-dir`` one epoch after the first (whose wall holds the
    kernel build) runs under ``capture``."""
    from shallowspeed_tpu_torch.observability import capture

    cuda = run.device.type == "cuda"
    if args.fused_run and args.epochs > 0:
        if not args.no_eval:
            print(f"Epoch: {run.epoch}, Accuracy: {run.accuracy() * 100:.2f}%")
        start = run.epoch
        with capture(args.profile_dir, metrics, cuda=cuda):
            losses, accs = run.train_run(args.epochs, with_eval=not args.no_eval)
        for e, loss in enumerate(losses):
            print(f"Epoch: {start + e}, mean train loss: {loss:.5f}")
            if not args.no_eval and e < len(losses) - 1:
                print(f"Epoch: {start + e + 1}, Accuracy: {accs[e] * 100:.2f}%")
        if args.checkpoint:
            run.save(args.checkpoint)
        return accs[-1] if accs else run.accuracy()
    # the step loop: chunks cut at the checkpoint grid (and by train_steps
    # at fault-injection steps); a snapshot whenever global_step lands on
    # the grid. Under --resume auto --epochs is the TOTAL target, so a
    # resumed run ends where its uninterrupted twin does
    every = args.checkpoint_every_steps
    target = args.epochs if args.resume == "auto" else run.epoch + args.epochs
    nb = run.batches_per_epoch
    prof_epoch = (
        run.epoch + min(1, max(target - run.epoch - 1, 0))
        if args.profile_dir and target > run.epoch
        else None
    )
    while run.epoch < target:
        if run.step_in_epoch == 0 and not args.no_eval:
            print(
                f"Epoch: {run.epoch}, Time Spent: {time.time() - t0:.2f}s, "
                f"Accuracy: {run.accuracy() * 100:.2f}%"
            )
        if every > 0:
            n = min(every - run.global_step % every, nb - run.step_in_epoch)
        else:
            n = nb - run.step_in_epoch
        with (
            capture(args.profile_dir, metrics, cuda=cuda)
            if run.epoch == prof_epoch
            else contextlib.nullcontext()
        ):
            _, loss = run.train_steps(n)
        if every > 0 and run.global_step % every == 0:
            run.save_step_checkpoint()
        if loss is not None:
            print(f"Epoch: {run.epoch - 1}, mean train loss: {loss:.5f}")
            if args.checkpoint:
                run.save(args.checkpoint)
    return run.accuracy()


if __name__ == "__main__":
    sys.exit(main())
