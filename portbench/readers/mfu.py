"""The whole step's share of the card's fp32 peak: model FLOPs a sample
(6P) times the samples/s of the run's window, with the profiler off, over
the peak of the card the run used."""

from portbench.work import bounds


def read(ctx, spec):
    flops = bounds.mlp_train_flops_per_sample(ctx["config"]["sizes"])
    return 100.0 * flops * ctx["window"]["samples_per_s"] / ctx["peaks"]["fp32_flops_per_s"]
