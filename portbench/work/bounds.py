"""FLOP and byte counts of the training step, and the card's peaks.

Frozen copies, so that no later change to the port moves the yardstick:
``bound_ms``, ``bwd_bound_ms`` and ``fused_bound_ms`` of ``chip_smoke.py``
(with the peaks as an argument), the model FLOPs a sample of
``observability/costmodel.mlp_train_flops_per_sample`` and its table of
fp32 peaks by card name, without the environment override: a card that is
not in the table fails the run.

The ``*_step_s`` functions are the work a roofline metric holds a kernel
to: what the configuration's step needs, counted from the sizes, the batch
and the Linears the layout of the traffic's session routes to the kernel,
never from a kernel's launch plan.
"""

# The fp32 (non-tensor-core) FLOP/s and the HBM bandwidth of each card, by
# the name torch.cuda.get_device_name() gives; NVIDIA's data sheets, dense
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "datasheet-h100-sxm5: 67 TFLOP/s non-tensor FP32, 3.35 TB/s HBM3",
    },
}

H100_SXM = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks_of(device_name):
    """The peaks of the card named ``device_name``; raises for a card that
    is not in the table."""
    try:
        return PEAKS[device_name]
    except KeyError:
        raise ValueError(
            f"no fp32 peak is known for {device_name!r}: the table has "
            f"{sorted(PEAKS)}"
        ) from None


def mlp_train_flops_per_sample(sizes):
    """Model FLOPs a trained sample: forward 2P, backward 4P, P = sum(in*out)."""
    sizes = tuple(sizes)
    return 6 * sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))


def _bound(nbytes, flops, peaks):
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = flops / peaks["fp32_flops_per_s"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_ms(m, k, n, peaks=H100_SXM):
    """Least time for one linear_act_fwd: x, W, b read once, y (fp32) and
    mask (1 byte) written once; 2*m*n*k FLOPs on the fp32 pipes."""
    nbytes = 4 * (m * k + n * k + n) + 5 * m * n
    return _bound(nbytes, 2.0 * m * n * k, peaks)


def bwd_bound_ms(m, k, n, relu=True, peaks=H100_SXM, need_dx=True):
    """Least time for one linear_act_bwd: g, x, W (and the 1-byte mask)
    read once, dx, dW, db written once; 4*m*n*k FLOPs (two products).
    Without ``need_dx`` (the first Linear, whose dx no step reads) neither
    W is read nor dx written, and the FLOPs are dW's 2*m*n*k."""
    if need_dx:
        nbytes = 4 * (m * n + m * k + n * k + m * k + n * k + n)
        flops = 4.0 * m * n * k
    else:
        nbytes = 4 * (m * n + m * k + n * k + n)
        flops = 2.0 * m * n * k
    nbytes += m * n if relu else 0
    return _bound(nbytes, flops, peaks)


def fused_bound_ms(widths, rows, batches, n_mirrors, peaks=H100_SXM):
    """Least time for the fused train kernel over ``batches`` batches of
    ``rows``: per batch the forward (2 rows K N per layer), dW (the same)
    and dx of every layer but the first, on the fp32 pipes; bytes: each
    batch read once, the params and every optimizer mirror read once and
    written once, the loss written. Returns (ms, bound_by)."""
    kn = [k * n for k, n in zip(widths[:-1], widths[1:])]
    flops = batches * 2.0 * rows * (2 * sum(kn) + sum(kn[1:]))
    params = sum(kn) + sum(widths[1:])
    nbytes = 4 * (batches * rows * (widths[0] + widths[-1]) + 2 * params * (1 + n_mirrors) + 1)
    return _bound(nbytes, flops, peaks)


def kernel_layers(cfg, session):
    """``(index, in, out, relu)`` of the Linears a step of the session's
    layout routes to the layer kernels: none on the fused train kernel's
    paths, every Linear on a pipeline with the flag kernels
    (``kernel_backend`` ``"pallas"``), none on one with plain torch, and on
    the sequential microbatch loop those a relu follows
    (``ops.linear_relu_fused``). Other layouts raise: their rows a launch
    are not the microbatch's."""
    sizes = cfg["sizes"]
    n = len(sizes) - 1
    layers = [(i, sizes[i], sizes[i + 1], i < n - 1) for i in range(n)]
    if any(session.get(k) for k in ("epoch_kernel", "megakernel", "run_kernel")):
        return []
    if session.get("fuse_mubatches") or session.get("dp", 1) > 1 or session.get("tp", 1) > 1:
        raise ValueError(f"no count of the layer kernels' work for the layout {session!r}")
    if session.get("pp", 1) > 1:
        return layers if session.get("kernel_backend") == "pallas" else []
    return [layer for layer in layers if layer[3]] if cfg["activation"] == "relu" else []


def linear_fwd_step_s(ctx):
    """Least seconds of the forward kernel's work over the traced stretch:
    each routed Linear at each microbatch's rows, every step."""
    t = ctx["traffic"]
    mb = t["global_batch_size"] // t["mubatches"]
    step_ms = t["mubatches"] * sum(
        bound_ms(mb, k, n, ctx["peaks"])[0]
        for _, k, n, _ in kernel_layers(ctx["config"], t["session"])
    )
    return 1e-3 * step_ms * ctx["stretch"]["steps"]


def linear_bwd_step_s(ctx):
    """Least seconds of the backward kernel's work over the traced stretch:
    each routed Linear's dW and db, and its dx where a step reads it (not
    the first Linear's), at each microbatch's rows, every step."""
    t = ctx["traffic"]
    mb = t["global_batch_size"] // t["mubatches"]
    step_ms = t["mubatches"] * sum(
        bwd_bound_ms(mb, k, n, relu, ctx["peaks"], need_dx=i > 0)[0]
        for i, k, n, relu in kernel_layers(ctx["config"], t["session"])
    )
    return 1e-3 * step_ms * ctx["stretch"]["steps"]


# params-shaped optimizer state the update reads and writes
MIRRORS = {"sgd": 0, "momentum": 1, "adam": 2}


def fused_train_step_s(ctx):
    """Least seconds of the fused train kernel's work over the traced
    stretch: one launch a chunk over the chunk's batches."""
    cfg = ctx["config"]
    rows = ctx["traffic"]["global_batch_size"]
    mirrors = MIRRORS[cfg["optimizer"]]
    return 1e-3 * sum(
        fused_bound_ms(cfg["sizes"], rows, steps, mirrors, ctx["peaks"])[0]
        for steps in ctx["stretch"]["chunk_steps"]
    )
