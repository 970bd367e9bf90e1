"""The port's init, model specs, ops and forward against the JAX package.

Inputs are made from a seed with numpy and go through both packages; the
port runs on the CPU (its plain path), the JAX package on its CPU backend,
with the Pallas kernel in interpret mode where the kernel backend is on.
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from shallowspeed_tpu import init as jinit
from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import ops as jops
from shallowspeed_tpu_torch import convert
from shallowspeed_tpu_torch import init as tinit
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import ops as tops

# probabilities after the softmax head: measured 3e-8 on the CPU
PROB_ATOL = 1e-6


def _size_pairs():
    pairs = set()
    for entry in jmodel.MODEL_ZOO.values():
        s = entry["sizes"]
        pairs.update(zip(s[:-1], s[1:]))
    return sorted(pairs)


@pytest.mark.parametrize("din,dout", _size_pairs())
def test_linear_init_bitwise(din, dout):
    """Every Linear of every zoo model gets the JAX package's exact bits."""
    wj, bj = jinit.linear_init(din, dout)
    wt, bt = tinit.linear_init(din, dout)
    assert wt.dtype == wj.dtype == np.float32
    assert np.array_equal(wt, wj) and np.array_equal(bt, bj)


def test_zoo_and_resolve_model_match():
    assert tmodel.MODEL_ZOO == jmodel.MODEL_ZOO
    for name in jmodel.MODEL_ZOO:
        assert tmodel.resolve_model(name) == jmodel.resolve_model(name)
    with pytest.raises(ValueError, match="unknown model"):
        tmodel.resolve_model("nope")


@pytest.mark.parametrize("pp", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(jmodel.MODEL_ZOO))
def test_model_spec_fields_match(name, pp):
    sizes, act = jmodel.resolve_model(name)
    j = jmodel.make_model_spec(sizes, pp, 128, act=act)
    t = tmodel.make_model_spec(sizes, pp, 128, act=act)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for sj, st in zip(j.stages, t.stages):
        assert (st.n_linears, st.res_flags) == (sj.n_linears, sj.res_flags)
    assert (t.in_dim, t.out_dim) == (j.in_dim, j.out_dim)


def test_zero_linear_last_stage_quirk_and_refusals():
    """8 sizes over 8 stages: both packages warn and keep the final relu;
    both refuse an indivisible split and an odd gelu slice."""
    sizes = jmodel.MODEL_ZOO["mnist-mlp"]["sizes"]
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        j = jmodel.make_model_spec(sizes, 8, 128)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        t = tmodel.make_model_spec(sizes, 8, 128)
    assert len(wj) == len(wt) == 1
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.stages[-2].relu_flags == (True,) and t.stages[-1].n_linears == 0
    with pytest.raises(ValueError, match="divisible"):
        tmodel.make_model_spec(sizes, 3, 128)
    with pytest.raises(ValueError, match="even per-stage slice"):
        tmodel.make_model_spec((784, 64, 64, 64, 64, 64, 10, 10), 8, 128, act="gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        tmodel.make_model_spec(sizes, 1, 128, act="tanh")


def test_init_model_bitwise_and_convert_roundtrip():
    spec = tmodel.make_model_spec(jmodel.MODEL_ZOO["mnist-mlp"]["sizes"], 2, 128)
    jparams = jmodel.init_model(jmodel.make_model_spec(spec.sizes, 2, 128))
    tparams = tmodel.init_model(spec)
    stages = convert.params_from_numpy(tparams, "cpu")
    back = convert.params_to_numpy(stages)
    for sj, st in zip(jparams, back):
        for lj, lt in zip(sj, st):
            assert np.array_equal(lj["W"], lt["W"]) and np.array_equal(lj["b"], lt["b"])
    layer = stages[0]
    assert tuple(layer.W[0].shape) == (128, 784) and tuple(layer.b[0].shape) == (1, 128)
    assert not layer.W[0].requires_grad


@functools.lru_cache(maxsize=None)
def _init_pair(din, dout):
    return jinit.linear_init(din, dout)


def _params(spec):
    """The deterministic init through the JAX package's layout (one
    linear_init per distinct size pair: mlp-deep repeats its 2048x2048)."""
    return [
        [
            dict(zip(("W", "b"), _init_pair(s.local_sizes[l], s.local_sizes[l + 1])))
            for l in range(s.n_linears)
        ]
        for s in spec.stages
    ]


def _forward_both(name, pp, rows=8, head_group_rows=None):
    sizes, act = jmodel.resolve_model(name)
    jspec = jmodel.make_model_spec(sizes, pp, 128, act=act)
    tspec = tmodel.make_model_spec(sizes, pp, 128, act=act)
    params = _params(jspec)
    x = np.random.RandomState(pp).randn(rows, sizes[0]).astype(np.float32)
    pj, _ = jmodel.model_forward(params, jspec, x, head_group_rows=head_group_rows)
    stages = convert.params_from_numpy(params, "cpu")
    pt, res = tmodel.model_forward(
        stages, tspec, torch.from_numpy(x), head_group_rows=head_group_rows
    )
    return np.asarray(pj), pt.numpy(), res


@pytest.mark.parametrize("pp", [1, 2])
@pytest.mark.parametrize("name", sorted(jmodel.MODEL_ZOO))
def test_forward_matches_jax_xla_backend(name, pp):
    """Every zoo model, the JAX kernel backend off (XLA)."""
    pj, pt, _ = _forward_both(name, pp)
    assert pt.shape == pj.shape == (8, 10)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_ATOL)


def test_forward_matches_jax_pallas_backend(monkeypatch):
    """The flagship with the JAX kernel backend on: every hidden Linear
    through pallas_ops.linear_relu_fwd in interpret mode. monkeypatch, not
    ops.set_pallas: the module global would leak into other tests."""
    monkeypatch.setattr(jops, "_PALLAS", True)
    pj, pt, res = _forward_both("mnist-mlp", 1, rows=16, head_group_rows=8)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PROB_ATOL)
    caches, z = res[0]
    assert len(caches) == 7 and z.shape == (16, 10)
    assert all(m.dtype == torch.bool and m.shape[0] == 16 for _, m in caches[:6])
    assert caches[6][1].numel() == 0  # the last Linear has no relu


@pytest.mark.parametrize("group_rows", [None, 4])
def test_softmax_matches_jax(group_rows):
    rng = np.random.RandomState(5)
    z = (3 * rng.randn(12, 10)).astype(np.float32)
    z[4:8] += 20.0  # one group far above the others: the max choice matters
    valid = rng.rand(12, 10) > 0.3
    valid[2] = False  # a fully masked row stays finite (all zeros)
    for mask in (None, valid):
        pj = np.asarray(jops.softmax(z, None if mask is None else mask, group_rows))
        pt = tops.softmax(
            torch.from_numpy(z),
            None if mask is None else torch.from_numpy(mask),
            group_rows,
        ).numpy()
        np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-7)
        if mask is not None:
            assert (pt[~mask] == 0).all() and np.isfinite(pt).all()


def test_elementwise_ops_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(6, 7).astype(np.float32)
    w = rng.randn(5, 7).astype(np.float32)
    b = rng.randn(1, 5).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(tops.relu(t(x)).numpy(), np.asarray(jops.relu(x)))
    np.testing.assert_allclose(tops.gelu(t(x)).numpy(), jops.gelu(x), atol=1e-6)
    np.testing.assert_allclose(
        tops.gelu_grad_mult(t(x)).numpy(), jops.gelu_grad_mult(x), atol=1e-6
    )
    np.testing.assert_allclose(
        tops.linear(t(x), t(w), t(b)).numpy(), jops.linear(x, w, b), atol=1e-5
    )
    y, mask = tops.linear_relu_fused(t(x), t(w), t(b))
    yj, mj = jops.linear_relu_fused(x, w, b)
    np.testing.assert_allclose(y.numpy(), yj, atol=1e-5)
    z = x.astype(np.float64) @ w.T + b
    stable = np.abs(z) > 1e-5
    np.testing.assert_array_equal(mask.numpy()[stable], np.asarray(mj)[stable])
    p = rng.rand(6, 10).astype(np.float32)
    tt = rng.rand(6, 10).astype(np.float32)
    np.testing.assert_allclose(
        float(tops.mse_loss(t(p), t(tt), 128)), float(jops.mse_loss(p, tt, 128)),
        rtol=1e-6,
    )
