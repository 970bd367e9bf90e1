"""Training CLI of the port: a subset of the root ``train.py``.

    python -m shallowspeed_tpu_torch.train [--epochs 20] [--data-dir DIR]
    python -m shallowspeed_tpu_torch.train --device cpu --data-dir DIR
    python -m shallowspeed_tpu_torch.train --fuse-mubatches --epoch-kernel
    python -m shallowspeed_tpu_torch.train --dp 2 --pp 4 --schedule gpipe \
        --kernel-backend pallas

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
kernels.
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=1, help="data-parallel replicas")
    ap.add_argument("--pp", type=int, default=1, help="pipeline stages")
    ap.add_argument(
        "--schedule", choices=["naive", "gpipe", "pipedream"], default="naive",
        help="pipeline schedule (ignored unless --pp > 1)",
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
        "--weight-decay", type=float, default=0.0,
        help="decoupled weight decay, uniform over every param element "
        "(0 = reference parity)",
    )
    ap.add_argument(
        "--clip-norm", type=float, default=None,
        help="global-norm gradient clipping over all params; off by default",
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
        "--resume", default=None,
        help="checkpoint to continue from (params, optimizer state, cursor); "
        "--epochs more epochs are trained",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)",
    )
    args = ap.parse_args(argv)

    from shallowspeed_tpu_torch.api import TrainingSession
    from shallowspeed_tpu_torch.data import default_data_dir

    run = TrainingSession(
        dp=args.dp,
        pp=args.pp,
        schedule=args.schedule,
        kernel_backend=args.kernel_backend,
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
        device=args.device,
    )
    if args.fused_run and run.step_in_epoch > 0:
        ap.error(
            f"--resume {args.resume} restored a mid-epoch cursor (epoch "
            f"{run.epoch}, step {run.step_in_epoch}); drop --fused-run to "
            "finish the epoch step by step"
        )
    note = f" resumed at epoch {run.epoch}" if args.resume else ""
    if run.step_in_epoch:
        note += f", step {run.step_in_epoch}"
    if run.sequential:
        layout = "sequential"
    elif args.pp > 1:
        layout = f"{args.schedule} pipeline"
    else:
        layout = "data-parallel"
    print(
        f"device={run.device} layout: DP={args.dp} x PP={args.pp} x TP=1 "
        f"({layout}) batches/epoch={run.batches_per_epoch}" + note
    )

    t0 = time.time()
    if args.fused_run and args.epochs > 0:
        if not args.no_eval:
            print(f"Epoch: {run.epoch}, Accuracy: {run.accuracy() * 100:.2f}%")
        start = run.epoch
        losses, accs = run.train_run(args.epochs, with_eval=not args.no_eval)
        for e, loss in enumerate(losses):
            print(f"Epoch: {start + e}, mean train loss: {loss:.5f}")
            if not args.no_eval and e < len(losses) - 1:
                print(f"Epoch: {start + e + 1}, Accuracy: {accs[e] * 100:.2f}%")
        final_acc = accs[-1] if accs else run.accuracy()
    else:
        target = run.epoch + args.epochs
        while run.epoch < target:
            if run.step_in_epoch:  # a mid-epoch resume: finish that epoch
                _, loss = run.train_steps(run.batches_per_epoch - run.step_in_epoch)
            else:
                if not args.no_eval:
                    print(
                        f"Epoch: {run.epoch}, Time Spent: {time.time() - t0:.2f}s, "
                        f"Accuracy: {run.accuracy() * 100:.2f}%"
                    )
                loss = run.train_epoch()
            print(f"Epoch: {run.epoch - 1}, mean train loss: {loss:.5f}")
        final_acc = run.accuracy()
    print(
        f"Epoch: {run.epoch}, Time Spent: {time.time() - t0:.2f}s, "
        f"Accuracy: {final_acc * 100:.2f}%"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
