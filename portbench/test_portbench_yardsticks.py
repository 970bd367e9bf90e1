"""The frozen yardsticks: work counts pinned to the bounds PERF.md prints,
the inputs' law, the trace arithmetic and the readers."""

import functools
import math

import pytest
import torch

from portbench.families import mlp as mlp_family
from portbench.readers import idle, mfu, ops_per_step, roofline
from portbench.work import bounds, inputs, trace

FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
DEEP = (784,) + (2048,) * 22 + (10,)
TRAFFIC = dict(
    dim=784, classes=10, center_std=1.0, noise_std=2.0, offset=8.0, span=16.0,
    train_rows=300, val_rows=20, global_batch_size=128, mubatches=4,
)


@pytest.mark.parametrize(
    "fn, args, ms, by",
    [
        (bounds.bound_ms, (8, 2048, 2048), 0.00505, "bytes"),  # B2
        (bounds.bwd_bound_ms, (32, 784, 2048), 0.00399, "bytes"),  # B4
        (bounds.fused_bound_ms, (FLAGSHIP, 128, 16, 0), 0.02694, "operations"),  # B10
    ],
)
def test_bounds_are_the_ones_perf_md_prints(fn, args, ms, by):
    got, bound_by = fn(*args)
    assert round(got, 5) == ms
    assert bound_by == by


def test_model_flops_a_sample_are_6p():
    assert bounds.mlp_train_flops_per_sample(FLAGSHIP) == 6 * 180342
    assert bounds.mlp_train_flops_per_sample(DEEP) == 6 * 89706496


def test_peaks_by_card_name_and_an_unknown_card_fails():
    assert bounds.peaks_of("NVIDIA H100 80GB HBM3")["fp32_flops_per_s"] == 67e12
    with pytest.raises(ValueError, match="no fp32 peak"):
        bounds.peaks_of("NVIDIA A100-SXM4-80GB")


def test_a_backward_without_dx_counts_half_the_flops():
    full, _ = bounds.bwd_bound_ms(256, 2048, 2048)
    first, by = bounds.bwd_bound_ms(256, 2048, 2048, need_dx=False)
    assert by == "operations" and first == pytest.approx(full / 2)


SEQ = {}
PP4 = {"pp": 4, "schedule": "gpipe", "kernel_backend": "pallas"}
EPOCH = {"fuse_mubatches": True, "epoch_kernel": True}


def _ctx(sizes, session, steps=10, b=1024, m=4):
    return {
        "config": {"sizes": sizes, "optimizer": "sgd", "activation": "relu"},
        "family": mlp_family,
        "traffic": {"global_batch_size": b, "mubatches": m, "session": session},
        "peaks": bounds.H100_SXM,
        "stretch": {"steps": steps, "chunk_steps": [steps], "gpu": [], "seconds": 1.0,
                    "busy_s": 0.25},
        "window": {"samples_per_s": 1000.0, "seconds": 2.0, "steps": 5},
    }


def test_layer_kernel_work_counts_the_routed_linears():
    relu = bounds.linear_fwd_step_s(_ctx(DEEP, SEQ))
    every = bounds.linear_fwd_step_s(_ctx(DEEP, PP4))
    one = 4 * 10 * bounds.bound_ms(256, 2048, 2048)[0] * 1e-3
    assert 21 * one < relu < 22 * one  # 784 -> 2048 costs less than 2048 -> 2048
    assert every > relu
    # a 256-row 2048 square Linear is FLOP-bound: 2 m n k / 67 TFLOP/s
    assert one == pytest.approx(4 * 10 * 2 * 256 * 2048 * 2048 / 67e12)
    bwd = bounds.linear_bwd_step_s(_ctx(DEEP, SEQ))
    assert bwd == pytest.approx(
        4 * 10 * 1e-3 * sum(
            bounds.bwd_bound_ms(256, k, n, True, need_dx=i > 0)[0]
            for i, (k, n) in enumerate(zip(DEEP[:-2], DEEP[1:-1]))
        )
    )
    cfg = {"sizes": DEEP, "activation": "relu"}
    assert bounds.kernel_layers(cfg, EPOCH) == []
    assert bounds.kernel_layers(cfg, dict(PP4, kernel_backend="xla")) == []
    assert bounds.kernel_layers(dict(cfg, activation="gelu"), SEQ) == []
    for layout in ({"fuse_mubatches": True}, {"dp": 2}, {"tp": 2}):
        with pytest.raises(ValueError, match="no count"):
            bounds.kernel_layers(cfg, layout)


def test_fused_work_is_one_launch_a_chunk():
    ctx = _ctx(FLAGSHIP, EPOCH, b=128)
    ctx["stretch"]["chunk_steps"] = [468, 468]
    want = 2e-3 * bounds.fused_bound_ms(FLAGSHIP, 128, 468, 0)[0]
    assert bounds.fused_train_step_s(ctx) == pytest.approx(want)


def test_inputs_follow_the_seed_and_keep_their_sizes():
    draw = functools.partial(inputs.draw_weights, FLAGSHIP)
    w1, s1 = inputs.make_inputs(draw, TRAFFIC, 2**40 + 7, "cpu")
    w2, s2 = inputs.make_inputs(draw, TRAFFIC, 2**40 + 7, "cpu")
    w3, s3 = inputs.make_inputs(draw, TRAFFIC, 3, "cpu")
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    assert [t.shape for t in s1] == [t.shape for t in s3]
    assert not torch.equal(s1[0], s3[0])
    x, y = s1[0], s1[1]
    assert x.shape == (300, 784) and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert torch.equal(y.sum(dim=1), torch.ones(300))
    again = inputs.weights_again(draw, 2**40 + 7, "cpu")
    for (wa, ba), (wb, bb) in zip(w1, again):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
    w0 = w1[0][0]
    assert w0.shape == (128, 784) and float(w0.std()) == pytest.approx(1 / math.sqrt(784), rel=0.02)
    with pytest.raises(ValueError):
        mlp_family.check_traffic({"sizes": (100, 10)}, TRAFFIC)


def test_union_of_busy_intervals():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.union_us([]) == 0


def test_the_marked_window_runs_between_the_markers():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, s, e, kind=DeviceType.CUDA):
        return NS(name=name, device_type=kind, time_range=NS(start=s, end=e))

    events = [ev("spin_kernel(long)", 5, 6), ev("k1", 10, 20), ev("spin_kernel", 1, 2, DeviceType.CPU),
              ev("k2", 30, 40), ev("at::cuda::spin_kernel(long)", 90, 91)]
    window = trace.marked_window(events, "spin_kernel")
    assert window == (6, 90)
    assert [g[0] for g in trace.gpu_events(events, window)] == ["k1", "k2"]
    with pytest.raises(RuntimeError, match="not 2"):
        trace.marked_window(events[1:], "spin_kernel")


def test_idle_gaps_are_named_by_the_innermost_host_op():
    gpu = [("k1", 10, 20), ("k2", 50, 60), ("k3", 61, 90)]
    host = [("portbench.stretch", 0, 100), ("train_steps", 0, 100), ("aten::copy_", 25, 45)]
    gaps = trace.idle_gaps(gpu, (0, 100), host, skip=("portbench.stretch",))
    assert gaps[0] == ("aten::copy_", pytest.approx(30e-6))
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 10e-6, 10e-6, 1e-6])
    assert trace.idle_gaps(gpu, (0, 100), [], top=1) == [
        ("host: python, then k2", pytest.approx(30e-6))
    ]
    assert trace.top_ops(gpu + [("k1", 95, 99)]) == [
        ("k3", pytest.approx(29e-6)), ("k1", pytest.approx(14e-6)), ("k2", pytest.approx(10e-6))
    ]


def test_readers_read_the_stretch_or_return_nothing():
    ctx = _ctx(DEEP, SEQ)
    # 0.025 s busy a step in the stretch against 0.4 s of wall a step in the window
    assert idle.read(ctx, {}) == pytest.approx(100 * (1 - 0.025 / 0.4))
    assert ops_per_step.read(ctx, {}) == 0
    assert mfu.read(ctx, {}) == pytest.approx(100 * 6 * 89706496 * 1000 / 67e12)
    spec = {"kernel": "linear_act_fwd_kernel", "work": "portbench.work.bounds:linear_fwd_step_s"}
    assert roofline.read(ctx, spec) is None  # no such kernel ran: nothing, never 0
    bound = bounds.linear_fwd_step_s(ctx)
    ctx["stretch"]["gpu"] = [("void linear_act_fwd_kernel<64>(...)", 0.0, 2e6 * bound)]
    assert roofline.read(ctx, spec) == pytest.approx(50.0)
    ctx["traffic"]["session"] = EPOCH  # the kernel ran where no step needs it: no share of 0
    with pytest.raises(ValueError, match="counts no work"):
        roofline.read(ctx, spec)
