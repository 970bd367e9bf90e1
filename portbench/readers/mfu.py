"""The whole step's share of the card's fp32 peak: the model FLOPs of one
trained sample, as the configuration's family counts them (6P for the
MLP), times the samples/s of the run's window, with the profiler off, over
the peak of the card the run used."""


def read(ctx, spec):
    flops = ctx["family"].train_flops_per_sample(ctx["config"])
    return 100.0 * flops * ctx["window"]["samples_per_s"] / ctx["peaks"]["fp32_flops_per_s"]
