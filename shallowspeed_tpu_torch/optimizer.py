"""Optimizers over the parameter tree: the counterpart of
``shallowspeed_tpu/optimizer.py``.

Parameters, gradients and optimizer state share the JAX package's pytree
layout: per stage a list of ``{"W", "b"}`` dicts of tensors
(``model.param_tree`` gives that view of the ``Stage`` modules). The state
protocol is the JAX package's: ``init(params)`` returns the state (``()``
= stateless); ``apply(params, grads, state) -> (params, state)`` is
elementwise over the leaves; ``state_layout()`` names the state's parts:

    SGD      -> {}                                (no state)
    Momentum -> {"": "params"}                    (state IS one params mirror)
    Adam     -> {"m": "params", "v": "params", "t": "scalar"}

State lives in plain tensors on the params' device: ``()`` for SGD, a
params mirror for momentum, ``{"m", "v", "t"}`` for Adam with ``t`` a 0-d
float32 tensor.

``apply`` updates in place: it writes the new values into the params' and
the state's own tensors and returns them (the JAX step donates its params
and state the same way). Every update is the JAX package's expression, op
by op, each op rounding once in fp32 — an in-place ``mul_``/``add_``/
``sub_`` without ``alpha`` gives the bits of the out-of-place expression.
Never ``alpha=``, ``addcmul_``, ``addcdiv_`` or ``torch.optim``: a fused
multiply-add rounds once where the reference rounds twice.
"""

import dataclasses

import torch


def tree_leaves(tree):
    """The tensors of a params-shaped tree in ``jax.tree.leaves`` order:
    lists in order, dict keys sorted (``"W"`` before ``"b"``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every tensor of a params-shaped tree, keeping its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def _zeros_mirror(params):
    return tree_map(torch.zeros_like, params)


@dataclasses.dataclass(frozen=True)
class SGD:
    """Stateless SGD: ``p <- p*(1 - lr*wd) - lr*g``. Grads are SUMS over the
    global batch (the loss is pre-scaled by the global batch size), so no
    averaging happens here. ``weight_decay`` is decoupled; 0 = reference
    parity."""

    lr: float
    weight_decay: float = 0.0

    def init(self, params):
        return ()  # no optimizer state

    def state_layout(self):
        return {}

    def apply(self, params, grads, state=()):
        _update_params(self, params, grads)
        return params, state


@dataclasses.dataclass(frozen=True)
class MomentumSGD:
    """Heavy-ball SGD: ``v <- mu*v + g; p <- p*(1 - lr*wd) - lr*v``."""

    lr: float
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params):
        return _zeros_mirror(params)

    def state_layout(self):
        return {"": "params"}

    def apply(self, params, grads, state):
        for v, g in zip(tree_leaves(state), tree_leaves(grads)):
            v.mul_(self.momentum).add_(g)
        _update_params(self, params, state)
        return params, state


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam (Kingma & Ba 2014), elementwise over the leaves; decoupled
    weight decay (AdamW) when ``weight_decay`` > 0. State
    ``{"m", "v", "t"}``: two params mirrors and one float32 step count."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        dev = tree_leaves(params)[0].device
        return {
            "m": _zeros_mirror(params),
            "v": _zeros_mirror(params),
            "t": torch.zeros((), dtype=torch.float32, device=dev),
        }

    def state_layout(self):
        return {"m": "params", "v": "params", "t": "scalar"}

    def apply(self, params, grads, state):
        t = state["t"] + 1.0
        # float32 powers of the float32 step count, as jnp computes them
        c1 = 1.0 - self.b1**t
        c2 = 1.0 - self.b2**t
        wd = _decay_factor(self.lr, self.weight_decay) if self.weight_decay else None
        for p, m, v, g in zip(
            tree_leaves(params),
            tree_leaves(state["m"]),
            tree_leaves(state["v"]),
            tree_leaves(grads),
        ):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            step = self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if wd is not None:  # the reference multiplies by 1.0 otherwise
                p.mul_(wd)
            p.sub_(step)
        state["t"] = t
        return params, state


def _update_params(opt, params, direction):
    """``p <- p*(1 - lr*wd) - lr*d`` in place: SGD's step along the
    gradient, momentum's along the velocity."""
    wd = _decay_factor(opt.lr, opt.weight_decay) if opt.weight_decay else None
    for p, d in zip(tree_leaves(params), tree_leaves(direction)):
        step = opt.lr * d
        if wd is not None:
            p.mul_(wd)
        p.sub_(step)


def is_stateless(opt) -> bool:
    """True iff the optimizer carries no state (SGD)."""
    return not opt.state_layout()


def make_optimizer(name: str, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
    """Optimizer registry for the CLI/API surface. ``weight_decay`` is
    decoupled and uniform over every param element, biases included."""
    if weight_decay:
        _decay_factor(lr, weight_decay)  # validate eagerly
    if name == "sgd":
        return SGD(lr, weight_decay=weight_decay)
    if name == "momentum":
        return MomentumSGD(lr, momentum, weight_decay=weight_decay)
    if name == "adam":
        return Adam(lr, weight_decay=weight_decay)
    raise ValueError(
        f"optimizer must be one of ['adam', 'momentum', 'sgd'], got {name!r}"
    )


def clip_scale(grads_sq_sum, clip_norm):
    """Global-norm clip factor ``min(1, clip/||g||)`` from the sum of
    squares of the full gradient."""
    norm = torch.sqrt(grads_sq_sum)
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def tree_sq_sum(tree):
    """Sum of squares over every leaf: a Python sum over the leaves in
    ``tree_leaves`` order, starting from 0, as the reference sums them."""
    return sum(torch.sum(g * g) for g in tree_leaves(tree))


def global_norm(tree):
    """Global L2 norm over every leaf (see ``tree_sq_sum``)."""
    return torch.sqrt(tree_sq_sum(tree))


def clip_tree(grads, clip_norm):
    """A new gradient tree scaled by the global-norm clip factor."""
    s = clip_scale(tree_sq_sum(grads), clip_norm)
    return tree_map(lambda g: g * s, grads)


def _decay_factor(lr, weight_decay):
    """Decoupled weight decay multiplier ``1 - lr*wd``, validated."""
    if weight_decay < 0:
        raise ValueError(f"weight_decay must be >= 0, got {weight_decay}")
    f = 1.0 - lr * weight_decay
    if f <= 0:
        raise ValueError(
            f"lr * weight_decay = {lr * weight_decay} >= 1 would flip the "
            "decay factor's sign"
        )
    return f


def split_state(opt, state):
    """State -> ({key: params-mirroring subtree}, {key: scalar}), keyed per
    ``state_layout()``. The inverse is ``join_state``."""
    parts, scalars = {}, {}
    for key, kind in opt.state_layout().items():
        sub = state if key == "" else state[key]
        (parts if kind == "params" else scalars)[key] = sub
    return parts, scalars


def join_state(opt, parts, scalars):
    """({key: subtree}, {key: scalar}) -> the state ``apply`` expects."""
    layout = opt.state_layout()
    if not layout:
        return ()
    if set(layout) == {""}:
        return parts[""]
    return {
        key: (parts[key] if kind == "params" else scalars[key])
        for key, kind in layout.items()
    }
