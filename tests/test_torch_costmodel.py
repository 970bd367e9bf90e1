"""The port's cost model against the JAX package's on the CPU platform, and
its own peak table.

Model FLOPs per sample, padded pipeline FLOPs per batch, and the serving
latency bound's ticks, weighted ticks and FLOPs are exactly the JAX
package's for the sequential, DP=2 x PP=4 and PP=2 x V=2 inference
programs (both on the nominal CPU peak, so ``seconds`` is equal too). The
peaks of the CUDA cards are the port's own: the non-tensor fp32 data-sheet
rates of the H100 SXM5 and PCIe by the name ``torch.cuda.get_device_name``
gives, ``None`` with a source naming the card and the override for any
other, and ``SHALLOWSPEED_PEAK_FLOPS`` over every row.
"""

import pytest

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import schedules as jS
from shallowspeed_tpu.observability import costmodel as jcost
from shallowspeed_tpu.parallel import lowering as jlow
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import schedules as tS
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch.observability import costmodel as tcost
from shallowspeed_tpu_torch.parallel import lowering as tlow


@pytest.fixture(autouse=True)
def _no_env_peak(monkeypatch):
    monkeypatch.delenv(tcost.ENV_PEAK, raising=False)


def test_h100_peaks_by_card_name():
    peak, src = tcost.peak_flops_per_chip("cuda", "highest", "NVIDIA H100 80GB HBM3")
    assert peak == 67e12 and "H100" in src and "SXM5" in src.upper()
    peak, src = tcost.peak_flops_per_chip("cuda", "highest", "NVIDIA H100 PCIe")
    assert peak == 51e12 and "PCIe" in src
    peak, src = tcost.peak_flops_per_chip("cuda", "highest", "NVIDIA A100-SXM4-80GB")
    assert peak is None
    assert "NVIDIA A100-SXM4-80GB" in src and tcost.ENV_PEAK in src
    # the port computes IEEE fp32 only: no tensor-core class is guessed
    assert tcost.peak_flops_per_chip("cuda", "default", "NVIDIA H100 80GB HBM3")[0] is None


def test_env_override_and_cpu_row(monkeypatch):
    assert tcost.peak_flops_per_chip("cpu", "highest") == jcost.peak_flops_per_chip(
        "cpu", "highest"
    )
    monkeypatch.setenv(tcost.ENV_PEAK, "1.5e13")
    for args in (("cuda", "highest", "NVIDIA A100-SXM4-80GB"), ("cpu", "highest")):
        assert tcost.peak_flops_per_chip(*args) == (1.5e13, f"env:{tcost.ENV_PEAK}")
    assert jcost.peak_flops_per_chip("cpu") == (1.5e13, f"env:{jcost.ENV_PEAK}")


def test_cost_model_record_and_mfu():
    cm = tcost.CostModel(FLAGSHIP_SIZES, 128, 405, platform="cuda",
                         device_name="NVIDIA H100 80GB HBM3")
    jm = jcost.CostModel(FLAGSHIP_SIZES, 128, 405, platform="cpu")
    assert cm.flops_per_sample == jm.flops_per_sample == 6 * 180342
    assert cm.flops_per_epoch == jm.flops_per_epoch
    rec = cm.as_record()
    # the JAX record's fields, the XLA leg null, plus the card
    assert set(jm.as_record()) <= set(rec)
    assert rec["xla_flops_per_epoch"] is None and rec["flops_ratio"] is None
    assert rec["device_name"] == "NVIDIA H100 80GB HBM3"
    assert rec["peak_flops_per_chip"] == 67e12
    assert cm.mfu(42_000) == pytest.approx(42_000 * 6 * 180342 / 67e12)
    assert tcost.CostModel(FLAGSHIP_SIZES, 128, 1, platform="cuda", device_name="x").mfu(1.0) is None


LAYOUTS = [
    ("sequential", 1, 1, 1),
    ("dp2xpp4", 2, 4, 1),
    ("pp2xv2", 1, 2, 2),
]


@pytest.mark.parametrize("label,dp,pp,V", LAYOUTS, ids=[x[0] for x in LAYOUTS])
def test_padded_flops_and_latency_bound_equal_jax(label, dp, pp, V):
    n_stages = pp * V
    tspec = tmodel.make_model_spec(FLAGSHIP_SIZES, n_stages, 128)
    jspec = jmodel.make_model_spec(FLAGSHIP_SIZES, n_stages, 128)
    slot_rows = 8 * dp
    if (dp, pp, V) == (1, 1, 1):
        tprog = jprog = None
    else:
        if V > 1:
            tprog = tlow.lower_schedule(tS.InterleavedInferenceSchedule, 1, pp,
                                        training=False, virtual=V)
            jprog = jlow.lower_schedule(jS.InterleavedInferenceSchedule, 1, pp,
                                        training=False, virtual=V)
        else:
            tprog = tlow.lower_schedule(tS.InferenceSchedule, 1, pp, training=False)
            jprog = jlow.lower_schedule(jS.InferenceSchedule, 1, pp, training=False)
        # padded training FLOPs per batch of the layout's training program
        sched = "interleaved" if V > 1 else "gpipe"
        ttrain = tlow.lower_schedule(tS.SCHEDULES[sched], 4, pp, virtual=V)
        jtrain = jlow.lower_schedule(jS.SCHEDULES[sched], 4, pp, virtual=V)
        mb = 128 // dp // 4
        assert tlow.program_flops(ttrain, tspec, mb) == jlow.program_flops(jtrain, jspec, mb)
    got = tcost.serving_latency_bound(tprog, tspec, slot_rows, dp=dp, platform="cpu")
    want = jcost.serving_latency_bound(jprog, jspec, slot_rows, dp=dp, platform="cpu")
    assert got == want
    card = tcost.serving_latency_bound(tprog, tspec, slot_rows, dp=dp, platform="cuda",
                                       device_name="NVIDIA H100 80GB HBM3")
    assert card["seconds"] == card["flops"] / 67e12 and card["flops"] == want["flops"]


def test_lowering_reads_the_cost_model_table():
    assert tlow.PIPELINE_OP_COSTS is tcost.PIPELINE_OP_COSTS
    assert tcost.PIPELINE_OP_COSTS == jcost.PIPELINE_OP_COSTS
    assert "PIPELINE_OP_COSTS = " not in open(tlow.__file__).read()
    prog = tlow.lower_schedule(tS.SCHEDULES["pipedream"], 4, 4, backward_split=True)
    jprog = jlow.lower_schedule(jS.SCHEDULES["pipedream"], 4, 4, backward_split=True)
    assert tlow.weighted_makespan(prog) == jlow.weighted_makespan(jprog)
