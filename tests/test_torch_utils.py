"""The port's host utilities against the JAX package's: the weight hash,
the per-layer digests, the replica-sync check and the retry helpers.

The hash is the reference's correctness check, so it must be the same
function of the same float32 bytes in both packages: a pinned tree gives
the JAX package's pinned value (``tests/test_divergence.py``), the
flagship's init gives the JAX package's hash, and every layout of the
port's session gives that hash at init (the hash is over the logical
blocks in global layer order).
"""

import numpy as np
import pytest

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import retry as jretry
from shallowspeed_tpu import utils as jutils
from shallowspeed_tpu_torch import retry as tretry
from shallowspeed_tpu_torch import utils as tutils
from shallowspeed_tpu_torch.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch.api import TrainingSession as TorchSession

PINNED_HASH = "29a2cfd20d8a5732b5b216051efe74c6e4a160b6"


def _pinned_tree():
    return [
        [{"W": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros(2, np.float32)}],
        [{"W": np.ones((1, 2), np.float32), "b": np.array([3.0], np.float32)}],
    ]


def test_model_hash_value_is_pinned():
    """The JAX package's pinned hash, block order and checksums."""
    params = _pinned_tree()
    assert tutils.model_hash(params) == PINNED_HASH == jutils.model_hash(params)
    blocks = list(tutils.iter_param_blocks(params))
    assert [(gl, k) for gl, k, _ in blocks] == [(0, "W"), (0, "b"), (1, "W"), (1, "b")]
    assert tutils.block_checksum(np.array([1.0, -0.0, 2.5], np.float32)) == 0xFFA00000
    assert tutils.block_checksum(params[0][0]["W"]) == 0x40E00000
    assert tutils.layer_digests(params) == jutils.layer_digests(params)


def test_flagship_init_hash_and_digests_match_jax():
    """Init is bitwise, so the hash and every layer's digest are equal."""
    spec = jmodel.make_model_spec(FLAGSHIP_SIZES, 1, 128)
    jparams = jmodel.init_model(spec)
    tparams = TorchSession(device="cpu").params()
    assert tutils.model_hash(tparams) == jutils.model_hash(jparams)
    assert tutils.layer_digests(tparams) == jutils.layer_digests(jparams)
    for (_, _, a), (_, _, b) in zip(
        tutils.iter_param_blocks(tparams), jutils.iter_param_blocks(jparams)
    ):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "layout",
    [dict(), dict(dp=4, pp=1), dict(dp=1, pp=4), dict(dp=2, pp=4)],
    ids=["sequential", "dp4", "pp4", "dp2xpp4"],
)
def test_every_layout_gives_the_jax_hash_at_init(layout):
    want = jutils.model_hash(jmodel.init_model(jmodel.make_model_spec(FLAGSHIP_SIZES, 1, 128)))
    ts = TorchSession(device="cpu", **layout)
    assert ts.model_hash() == want
    ts.assert_replicas_in_sync()  # one stacked copy: holds by construction


def test_replica_check_names_a_layout_with_a_replica_axis():
    """The check holds by construction on the lockstep layout and says so
    by checking that layout: a leaf with a replica axis is refused."""
    ts = TorchSession(device="cpu", dp=2, pp=4)
    tutils.assert_dp_replicas_in_sync(ts._stacked, ts.spec)
    per_replica = {
        "W": tuple(w.unsqueeze(0).expand(2, *w.shape) for w in ts._stacked["W"]),
        "b": ts._stacked["b"],
    }
    with pytest.raises(ValueError, match="not one copy of 4 stage slots"):
        tutils.assert_dp_replicas_in_sync(per_replica, ts.spec)


def test_p0print_prints(capsys):
    tutils.p0print("final model hash:", PINNED_HASH)
    assert capsys.readouterr().out == f"final model hash: {PINNED_HASH}\n"


@pytest.mark.parametrize(
    "kw",
    [
        dict(base=1.0, factor=2.0, max_delay=60.0, jitter=0),
        dict(base=1.0, max_delay=60.0, jitter=0.2, seed=7),
        dict(base=0.5, factor=3.0, max_delay=5.0, jitter=0.1, seed=0),
    ],
)
def test_backoff_schedule_matches_jax(kw):
    assert tretry.backoff_delays(8, **kw) == jretry.backoff_delays(8, **kw)


def test_retry_call_budget_filter_and_cli_match_jax(capsys):
    """The bounded budget, the exception filter and the schedule the
    retries sleep, as the JAX package's; and the CLI's lines."""
    for mod in (tretry, jretry):
        calls, sleeps, seen = [], [], []

        def flaky():
            calls.append(1)
            raise OSError("transient")

        with pytest.raises(OSError):
            mod.retry_call(
                flaky, attempts=4, jitter=0, base=1.0,
                on_retry=lambda i, e, d: seen.append((i, d)), sleep=sleeps.append,
            )
        assert (len(calls), sleeps, [i for i, _ in seen]) == (4, [1.0, 2.0, 4.0], [0, 1, 2])
        with pytest.raises(ValueError, match="not retried"):
            mod.retry_call(
                lambda: (_ for _ in ()).throw(ValueError("not retried")),
                sleep=sleeps.append,
            )
        assert mod.retry_call(lambda: 7, sleep=sleeps.append) == 7
        with pytest.raises(ValueError):
            mod.retry_call(lambda: 0, attempts=0)
    argv = ["--attempts", "5", "--base", "2", "--max", "10", "--seed", "3"]
    assert tretry.main(argv) == 0
    ours = capsys.readouterr().out
    assert jretry.main(argv) == 0
    assert ours == capsys.readouterr().out and len(ours.split()) == 5
    assert tretry.main(["--jitter", "1.5"]) == 1
