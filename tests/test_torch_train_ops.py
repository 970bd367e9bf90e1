"""The port's hand-written backward, model backward and optimizers against
the JAX package.

Inputs are made from a seed with numpy and go through both packages: the
port on the CPU (its plain path), the JAX package on its CPU backend. The
head's VJP is also held to ``torch.autograd`` (the training path itself
uses no autograd).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import model as jmodel
from shallowspeed_tpu import ops as jops
from shallowspeed_tpu import optimizer as jopt
from shallowspeed_tpu_torch import convert
from shallowspeed_tpu_torch import model as tmodel
from shallowspeed_tpu_torch import ops as tops
from shallowspeed_tpu_torch import optimizer as topt

# elementwise ops and small products: the two packages sum in different
# orders (fp32 reduction noise, docs/numerics.md)
RTOL, ATOL = 1e-5, 1e-6
# a model's gradients after the head and 7-8 chained VJPs: the noise above,
# compounded through the chain
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# params after 5 optimizer steps on the same grads: elementwise, one
# rounding per op in both packages; only Adam's float32 pow of the step
# count and its sqrt may differ in the last bit
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7

t = torch.from_numpy


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol,
    )


def test_elementwise_backward_ops_match_jax():
    rng = np.random.RandomState(0)
    g, z = _rand(rng, 6, 7), _rand(rng, 6, 7)
    mask = rng.rand(6, 7) > 0.5
    _close(tops.relu_grad(t(g), t(mask)), jops.relu_grad(g, mask))
    _close(tops.gelu_grad(t(g), t(z)), jops.gelu_grad(g, z))
    p, tt = rng.rand(6, 10).astype(np.float32), rng.rand(6, 10).astype(np.float32)
    _close(tops.mse_loss_grad(t(p), t(tt), 128), jops.mse_loss_grad(p, tt, 128))


def test_linear_vjps_match_jax():
    """The split halves, their composition and the relu-unit halves."""
    rng = np.random.RandomState(1)
    g, x, w = _rand(rng, 9, 5), _rand(rng, 9, 7), _rand(rng, 5, 7)
    mask = rng.rand(9, 5) > 0.5
    _close(tops.linear_grad_input(t(g), t(w)), jops.linear_grad_input(g, w))
    for a, b in zip(tops.linear_grad_weight(t(g), t(x)), jops.linear_grad_weight(g, x)):
        _close(a, b)
    for a, b in zip(tops.linear_grad(t(g), t(x), t(w)), jops.linear_grad(g, x, w)):
        _close(a, b)
    _close(
        tops.linear_relu_grad_input(t(g), t(mask), t(w)),
        jops.linear_relu_grad_input(g, mask, w),
    )
    for a, b in zip(
        tops.linear_relu_grad_weight(t(g), t(mask), t(x)),
        jops.linear_relu_grad_weight(g, mask, x),
    ):
        _close(a, b)
    got = tops.linear_relu_grad_fused(t(g), t(mask), t(x), t(w))
    for a, b in zip(got, jops.linear_relu_grad_fused(g, mask, x, w)):
        _close(a, b)
    assert tuple(got[2].shape) == (5,)


@pytest.mark.parametrize("group_rows", [None, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_and_head_grads_match_jax(group_rows, masked):
    rng = np.random.RandomState(2)
    z, g = _rand(rng, 12, 10, scale=3.0), _rand(rng, 12, 10)
    z[4:8] += 20.0  # one group far above the others: the max choice matters
    tgt = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 12)]
    valid = rng.rand(12, 10) > 0.3 if masked else None
    tv = None if valid is None else t(valid)
    _close(
        tops.softmax_grad(t(g), t(z), tv, group_rows),
        jops.softmax_grad(g, z, valid, group_rows),
    )
    got = tops.softmax_mse_head_grad(t(z), t(tgt), 128, tv, group_rows)
    _close(got, jops.softmax_mse_head_grad(z, tgt, 128, valid, group_rows))
    if valid is not None:
        assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("group_rows", [None, 4])
def test_head_grad_matches_torch_autograd(group_rows):
    """The fused head VJP against autograd of softmax -> MSE."""
    rng = np.random.RandomState(3)
    z = t(_rand(rng, 8, 10, scale=2.0)).requires_grad_(True)
    tgt = t(np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
    tops.mse_loss(tops.softmax(z, group_rows=group_rows), tgt, 128).backward()
    got = tops.softmax_mse_head_grad(z.detach(), tgt, 128, group_rows=group_rows)
    _close(got, z.grad.numpy(), rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# stage_backward / model_backward
# ---------------------------------------------------------------------------

NARROW_BLOCKS = (20, 24, 12, 24, 12, 24, 12, 10)  # the transformer zoo, narrowed


def _model_case(name, pp, rows=16):
    if name == "mnist-mlp":
        sizes, act = jmodel.resolve_model(name)
    else:
        sizes, act = NARROW_BLOCKS, "gelu"
    jspec = jmodel.make_model_spec(sizes, pp, 128, act=act)
    tspec = tmodel.make_model_spec(sizes, pp, 128, act=act)
    rng = np.random.RandomState(pp)
    params = [
        [
            {
                "W": _rand(
                    rng, s.local_sizes[l + 1], s.local_sizes[l],
                    scale=1.0 / np.sqrt(s.local_sizes[l]),
                ),
                "b": _rand(rng, 1, s.local_sizes[l + 1], scale=0.1),
            }
            for l in range(s.n_linears)
        ]
        for s in jspec.stages
    ]
    x = rng.randn(rows, sizes[0]).astype(np.float32)
    y = np.eye(sizes[-1], dtype=np.float32)[rng.randint(0, sizes[-1], rows)]
    return jspec, tspec, params, x, y


@pytest.mark.parametrize("pp", [1, 2, 4])
@pytest.mark.parametrize("name", ["mnist-mlp", "transformer"])
def test_model_backward_matches_jax(name, pp):
    """The flagship (relu, kernel switch point on its hidden Linears) and a
    narrowed transformer-family spec (gelu + residual adds) at pp=1,2,4."""
    jspec, tspec, params, x, y = _model_case(name, pp)
    jx = jnp.asarray(x)
    _, jres = jmodel.model_forward(params, jspec, jx, head_group_rows=8)
    jdx, jgrads = jmodel.model_backward(params, jspec, jres, y, head_group_rows=8)
    stages = convert.params_from_numpy(params, "cpu")
    _, tres = tmodel.model_forward(stages, tspec, t(x), head_group_rows=8)
    tdx, tgrads = tmodel.model_backward(stages, tspec, tres, t(y), head_group_rows=8)
    _close(tdx, jdx, GRAD_RTOL, GRAD_ATOL)
    for sj, st in zip(jgrads, tgrads):
        assert len(sj) == len(st)
        for lj, lt in zip(sj, st):
            assert tuple(lt["b"].shape) == tuple(np.shape(lj["b"]))
            _close(lt["W"], lj["W"], GRAD_RTOL, GRAD_ATOL)
            _close(lt["b"], lj["b"], GRAD_RTOL, GRAD_ATOL)


def test_model_backward_matches_torch_autograd():
    """The hand-written VJPs of the flagship against autograd through the
    same forward expressions."""
    jspec, tspec, params, x, y = _model_case("mnist-mlp", 1, rows=8)
    stages = convert.params_from_numpy(params, "cpu")
    _, res = tmodel.model_forward(stages, tspec, t(x))
    _, grads = tmodel.model_backward(stages, tspec, res, t(y))
    leaves = [
        t(a).requires_grad_(True) for l in params[0] for a in (l["W"], l["b"])
    ]
    h = t(x)
    for i in range(0, len(leaves), 2):
        h = tops.linear(h, leaves[i], leaves[i + 1])
        if i + 2 < len(leaves):
            h = torch.relu(h)
    tops.mse_loss(tops.softmax(h), t(y), 128).backward()
    got = topt.tree_leaves(grads)
    for a, leaf in zip(got, leaves):
        _close(a, leaf.grad.numpy(), GRAD_RTOL, GRAD_ATOL)


def test_params_from_numpy_copies_so_updates_stay_inside():
    """The optimizer updates the params in place, so the carrier must not
    share memory with the caller's arrays on the CPU (torch.as_tensor
    would): training a CPU session leaves the init arrays untouched."""
    spec = tmodel.make_model_spec((6, 5, 4), 1, 8)
    host = tmodel.init_model(spec)
    before = [l["W"].copy() for l in host[0]]
    stages = convert.params_from_numpy(host, "cpu")
    grads = topt.tree_map(torch.ones_like, tmodel.param_tree(stages))
    topt.SGD(0.5).apply(tmodel.param_tree(stages), grads)
    assert all(np.array_equal(l["W"], b) for l, b in zip(host[0], before))
    assert not torch.equal(stages[0].W[0], t(before[0]))


def test_param_tree_is_a_view_of_the_modules():
    spec = tmodel.make_model_spec((6, 5, 4), 1, 8)
    stages = convert.params_from_numpy(tmodel.init_model(spec), "cpu")
    tree = tmodel.param_tree(stages)
    assert [sorted(l) for l in tree[0]] == [["W", "b"], ["W", "b"]]
    tree[0][1]["b"].add_(1.0)
    assert float(stages[0].b[1].sum()) == 4.0


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.01),
    "sgd-wd": lambda m: m.SGD(0.01, weight_decay=0.1),
    "momentum": lambda m: m.MomentumSGD(0.01, 0.9),
    "momentum-wd": lambda m: m.MomentumSGD(0.01, 0.9, weight_decay=0.1),
    "adam": lambda m: m.Adam(1e-3),
    "adamw": lambda m: m.Adam(1e-3, weight_decay=0.1),
}


def _tree(rng, sizes=((5, 4), (3, 5)), scale=1.0):
    return [
        [{"W": _rand(rng, o, i, scale=scale), "b": _rand(rng, 1, o, scale=scale)}]
        for i, o in sizes
    ]


def _to_torch(tree):
    return topt.tree_map(lambda a: t(np.array(a)), tree)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_jax_over_five_steps(name, clip):
    """The same params and the same 5 gradients through both packages'
    optimizer (and, with ``clip``, the global-norm clip first)."""
    rng = np.random.RandomState(4)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    assert to.state_layout() == jo.state_layout()
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jg, tg = jax.tree.map(jnp.asarray, g), _to_torch(g)
        if clip is not None:
            jg, tg = jopt.clip_tree(jg, clip), topt.clip_tree(tg, clip)
        jp, js = jo.apply(jp, jg, js)
        tp, ts = to.apply(tp, tg, ts)
    for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, OPT_RTOL, OPT_ATOL)
    if not topt.is_stateless(to):
        for a, b in zip(topt.tree_leaves(ts), jax.tree.leaves(js)):
            _close(a, b, OPT_RTOL, OPT_ATOL)
    if name.startswith("adam"):
        assert ts["t"].dtype == torch.float32 and ts["t"].dim() == 0
        assert float(ts["t"]) == 5.0


def test_apply_updates_in_place_and_no_fused_rounding():
    """The update writes into the params' own tensors, and ``p - lr*g``
    rounds twice (never one fused multiply-add): checked bitwise against
    the two-op expression."""
    rng = np.random.RandomState(5)
    params, g = _to_torch(_tree(rng)), _to_torch(_tree(rng))
    before = [p.clone() for p in topt.tree_leaves(params)]
    ids = [id(p) for p in topt.tree_leaves(params)]
    topt.SGD(0.0123).apply(params, g)
    assert ids == [id(p) for p in topt.tree_leaves(params)]
    for p, p0, gg in zip(topt.tree_leaves(params), before, topt.tree_leaves(g)):
        assert torch.equal(p, p0 - 0.0123 * gg)


def test_clip_and_norms_match_jax():
    rng = np.random.RandomState(6)
    g = _tree(rng, scale=3.0)
    jg = jax.tree.map(jnp.asarray, g)
    tg = _to_torch(g)
    _close(topt.tree_sq_sum(tg), jopt.tree_sq_sum(jg), 1e-6, 0)
    _close(topt.global_norm(tg), jopt.global_norm(jg), 1e-6, 0)
    for c in (0.1, 1e6):
        _close(topt.clip_scale(topt.tree_sq_sum(tg), c), jopt.clip_scale(jopt.tree_sq_sum(jg), c), 1e-6, 0)
        for a, b in zip(topt.tree_leaves(topt.clip_tree(tg, c)), jax.tree.leaves(jopt.clip_tree(jg, c))):
            _close(a, b, 1e-6, 1e-8)
    assert float(topt.clip_scale(torch.tensor(0.0), 1.0)) == 1.0


def test_tree_leaves_order_is_jax_order():
    tree = [[{"b": "b0", "W": "W0"}, {"W": "W1", "b": "b1"}], [{"W": "W2", "b": "b2"}]]
    assert topt.tree_leaves(tree) == jax.tree.leaves(tree)


def test_make_optimizer_and_refusals_match_jax():
    for name in ("sgd", "momentum", "adam"):
        jo = jopt.make_optimizer(name, 0.01, 0.8, 0.1)
        to = topt.make_optimizer(name, 0.01, 0.8, 0.1)
        assert type(to).__name__ == type(jo).__name__
        assert to.state_layout() == jo.state_layout()
        assert topt.is_stateless(to) == jopt.is_stateless(jo)
    with pytest.raises(ValueError, match="optimizer must be"):
        topt.make_optimizer("lion", 0.1)
    with pytest.raises(ValueError, match=">= 0"):
        topt.make_optimizer("sgd", 0.1, weight_decay=-1.0)
    with pytest.raises(ValueError, match="flip"):
        topt.make_optimizer("sgd", 0.5, weight_decay=2.0)
    assert topt._decay_factor(0.01, 0.1) == jopt._decay_factor(0.01, 0.1)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_state_split_join_and_numpy_carrier_roundtrip(name):
    """split_state/join_state and convert's numpy carrier: a JAX
    optimizer's state, as numpy, seeds the port's bit for bit."""
    rng = np.random.RandomState(7)
    params = _tree(rng)
    jo, to = jopt.make_optimizer(name, 0.01), topt.make_optimizer(name, 0.01)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    for _ in range(2):
        jp, js = jo.apply(jp, jax.tree.map(jnp.asarray, _tree(rng)), js)
    if jopt.is_stateless(jo):
        assert convert.opt_state_from_numpy(to, None, "cpu") == ()
        assert convert.opt_state_to_numpy(to, ()) is None
        return
    parts, scalars = jopt.split_state(jo, js)
    logical = {
        "parts": {k: jax.tree.map(np.asarray, v) for k, v in parts.items()},
        "scalars": {k: float(v) for k, v in scalars.items()},
    }
    ts = convert.opt_state_from_numpy(to, logical, "cpu")
    for a, b in zip(topt.tree_leaves(ts), jax.tree.leaves(js)):
        assert np.array_equal(a.numpy(), np.asarray(b).reshape(a.shape))
    back = convert.opt_state_to_numpy(to, ts)
    assert back["scalars"] == logical["scalars"]
    for k in logical["parts"]:
        for a, b in zip(jax.tree.leaves(back["parts"][k]), jax.tree.leaves(logical["parts"][k])):
            assert np.array_equal(a, np.asarray(b).reshape(a.shape))
    rejoined = topt.join_state(to, *topt.split_state(to, ts))
    assert all(a is b for a, b in zip(topt.tree_leaves(rejoined), topt.tree_leaves(ts)))
