"""Analytical cost model + MFU accounting: the port's counterpart of
``shallowspeed_tpu/observability/costmodel.py``.

- The NUMERATOR is model FLOPs — fwd ``2P`` + bwd ``4P`` per sample for
  ``P = sum(in*out)`` (``mlp_train_flops_per_sample``). On mesh layouts the
  PADDED hardware FLOPs the stacked-slot executor multiplies
  (``lowering.program_flops``) ride alongside, so the padding tax is a
  recorded number.
- The DENOMINATOR is the peak FLOP/s of the card the session runs on. The
  port computes in IEEE fp32 on the FMA units with TF32 off (ROADMAP.md,
  parity rules), so the peak is the card's non-tensor fp32 rate from its
  data sheet, looked up by ``torch.cuda.get_device_name()``: 67 TFLOP/s
  for the H100 SXM5, 51 TFLOP/s for the H100 PCIe. Any other card gets
  ``None`` with a source that names it and the ``SHALLOWSPEED_PEAK_FLOPS``
  override — the JAX module's unknown-platform contract, never a guess.
  The CPU row is the JAX module's NOMINAL figure, labeled as such.
- The JAX module's XLA cross-check leg (``compiled_flops``,
  ``xla_flops_per_epoch``) reads a compiled XLA program; the port has none,
  so the record keeps those fields as ``null`` and invents no substitute.

``MFU = samples_per_sec * model_flops_per_sample / (peak_per_chip * chips)``
— model FLOPs in the numerator, so padding and recomputation make MFU
worse, never better. The port's mesh runs every rank on one card, so its
``n_devices`` is 1.

``PIPELINE_OP_COSTS`` is the single source of the executor's per-op FLOP
weights; ``parallel/lowering.py`` reads it from here.
"""

import os

# Per-chip peak model FLOP/s by (platform, precision class) for the host:
# the JAX module's NOMINAL single-socket CPU figure, labeled as such
PEAK_FLOPS_PER_CHIP = {
    ("cpu", "highest"): 2e11,
    ("cpu", "default"): 2e11,
}

# The CUDA cards' fp32 (non-tensor-core) peaks, by the name
# torch.cuda.get_device_name() gives: (peak FLOP/s, source)
CUDA_FP32_PEAKS = {
    "NVIDIA H100 80GB HBM3": (
        67e12, "datasheet-h100-sxm5-fp32: NVIDIA H100 80GB HBM3, 67 TFLOP/s non-tensor FP32"
    ),
    "NVIDIA H100 PCIe": (
        51e12, "datasheet-h100-pcie-fp32: NVIDIA H100 PCIe, 51 TFLOP/s non-tensor FP32"
    ),
}

ENV_PEAK = "SHALLOWSPEED_PEAK_FLOPS"

# Relative per-tick FLOP weights of the pipeline executor's compute ops, in
# units of one forward's matmul work (2P per microbatch): a combined
# backward is dgrad 2P + wgrad 2P = 2 forwards; the split halves are one
# forward each; an OP_RECOMPUTE cell re-runs a stage forward. The single
# source for ``lowering.weighted_utilization`` / ``weighted_makespan``.
PIPELINE_OP_COSTS = {
    "fwd": 1.0, "bwd": 2.0, "bwd_in": 1.0, "bwd_w": 1.0,
    "recompute": 1.0,
}


def mlp_train_flops_per_sample(sizes):
    """Analytical training FLOPs per sample: fwd 2P + bwd 4P (dgrad 2P +
    wgrad 2P) for P = sum(in*out); bias adds, activations and the softmax
    head are O(width) and not counted."""
    sizes = tuple(sizes)
    return 6 * sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))


def peak_flops_per_chip(platform, precision="highest", device_name=None):
    """-> ``(peak_flops, source)`` for one chip; ``(None, source)`` when the
    peak is unknown. ``platform``: a ``torch.device`` type (``"cuda"`` or
    ``"cpu"``); ``device_name``: the card's ``torch.cuda.get_device_name()``
    on ``"cuda"``. ``SHALLOWSPEED_PEAK_FLOPS`` overrides every row."""
    env = os.environ.get(ENV_PEAK)
    if env:
        return float(env), f"env:{ENV_PEAK}"
    if platform == "cuda":
        row = CUDA_FP32_PEAKS.get(device_name) if precision == "highest" else None
        if row is None:
            return None, (
                f"unknown-platform:cuda:{device_name}:{precision} (set "
                f"{ENV_PEAK} to this card's peak FLOP/s)"
            )
        return row
    key = (platform, precision)
    if key not in PEAK_FLOPS_PER_CHIP:
        return None, f"unknown-platform:{platform}"
    return PEAK_FLOPS_PER_CHIP[key], "nominal-cpu-default"


def serving_latency_bound(
    prog, spec, slot_rows, dp=1, platform="cpu", precision="highest", tp=1,
    device_name=None,
):
    """Analytical latency floor for ONE request slot through the layout's
    inference program (the JAX module's definition). Mesh layouts
    (``prog`` = the single-slot lowered inference program):
    ``weighted_makespan(prog)`` forward-units, each ``2 * (slot_rows/dp) *
    padded_P`` FLOPs over the padded slot stack. Sequential (``prog`` None):
    ``2 * P * slot_rows`` FLOPs. Divided by the chip's peak — a lower bound:
    launch overhead, relays and queueing sit on top of it.

    Returns ``{"ticks", "weighted_ticks", "flops", "seconds",
    "peak_flops_per_chip", "peak_source"}`` (``seconds`` None when the peak
    is unknown; ``ticks`` None on the sequential path)."""
    peak, source = peak_flops_per_chip(platform, precision, device_name)
    if prog is None:
        flops = 2 * sum(
            spec.sizes[i] * spec.sizes[i + 1] for i in range(len(spec.sizes) - 1)
        ) * slot_rows
        ticks = weighted = None
    else:
        from shallowspeed_tpu_torch.parallel.executor import slot_shapes
        from shallowspeed_tpu_torch.parallel.lowering import weighted_makespan

        padded_p = sum(o * i for o, i in slot_shapes(spec, tp)) // max(tp, 1)
        weighted = weighted_makespan(prog)
        ticks = int(prog.num_ticks)
        flops = weighted * 2 * (slot_rows // dp) * padded_p
    return {
        "ticks": ticks,
        "weighted_ticks": None if prog is None else float(weighted),
        "flops": float(flops),
        "seconds": (flops / peak) if peak else None,
        "peak_flops_per_chip": peak,
        "peak_source": source,
    }


class CostModel:
    """One session's FLOP ledger: analytical model FLOPs, optional padded
    pipeline FLOPs, and the MFU peak of the card it runs on."""

    def __init__(
        self,
        sizes,
        global_batch,
        batches_per_epoch,
        n_devices=1,
        platform="cpu",
        precision="highest",
        padded_flops_per_batch=None,
        device_name=None,
    ):
        self.sizes = tuple(sizes)
        self.global_batch = int(global_batch)
        self.batches_per_epoch = int(batches_per_epoch)
        self.n_devices = int(n_devices)
        self.platform = platform
        self.precision = precision
        self.device_name = device_name
        self.flops_per_sample = mlp_train_flops_per_sample(sizes)
        self.flops_per_batch = self.flops_per_sample * self.global_batch
        self.flops_per_epoch = self.flops_per_batch * self.batches_per_epoch
        self.padded_flops_per_batch = (
            None if padded_flops_per_batch is None else float(padded_flops_per_batch)
        )
        self.peak_flops_per_chip, self.peak_source = peak_flops_per_chip(
            platform, precision, device_name
        )
        # the JAX module's XLA cost_analysis leg: no compiled program here
        self.xla_flops_per_epoch = None
        self.xla_bytes_per_epoch = None

    @property
    def padded_ratio(self):
        """Padded / logical FLOPs per batch (the pipeline padding tax)."""
        if self.padded_flops_per_batch is None or self.flops_per_batch <= 0:
            return None
        return self.padded_flops_per_batch / self.flops_per_batch

    def achieved_flops_per_sec(self, samples_per_sec):
        """Model-FLOP throughput at an observed samples/s."""
        return samples_per_sec * self.flops_per_sample

    def mfu(self, samples_per_sec):
        """Model FLOP utilization against the layout's total peak (peak per
        chip x participating devices); None when no peak is known."""
        if not self.peak_flops_per_chip or samples_per_sec is None:
            return None
        total_peak = self.peak_flops_per_chip * max(1, self.n_devices)
        return self.achieved_flops_per_sec(samples_per_sec) / total_peak

    def as_record(self):
        """JSON-able snapshot — the ``cost_model`` event's field set (the
        JAX module's fields, plus the card's name)."""
        rec = {
            "flops_per_sample": self.flops_per_sample,
            "flops_per_batch": self.flops_per_batch,
            "flops_per_epoch": self.flops_per_epoch,
            "batches_per_epoch": self.batches_per_epoch,
            "global_batch": self.global_batch,
            "n_devices": self.n_devices,
            "platform": self.platform,
            "precision": self.precision,
            "device_name": self.device_name,
            "peak_flops_per_chip": self.peak_flops_per_chip,
            "peak_source": self.peak_source,
            "xla_flops_per_epoch": self.xla_flops_per_epoch,
            "xla_bytes_per_epoch": self.xla_bytes_per_epoch,
            "flops_ratio": None,
        }
        if self.padded_flops_per_batch is not None:
            rec["padded_flops_per_batch"] = self.padded_flops_per_batch
            rec["padded_ratio"] = self.padded_ratio
        return rec
