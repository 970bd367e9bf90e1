"""Model layer: stage partitioning, parameters as modules, and the forward.

The counterpart of ``shallowspeed_tpu/model.py``. The specs
(``StageSpec``/``ModelSpec``), ``partition_sizes``, ``make_model_spec``
(with the zero-Linear last-stage quirk), ``MODEL_ZOO``/``resolve_model``
and the host init are the reference's arithmetic, kept field for field so
the tests can compare them. Parameters live in one ``Stage`` module per
pipeline stage, holding each Linear's ``W`` as ``(out, in)`` and ``b`` as
``(1, out)`` exactly as the JAX pytree does; the forward and backward are
plain functions over those modules. The forward returns the same residual
structure (``(layer_caches, z)`` per stage) the JAX forward returns, and the
backward consumes it with hand-written VJPs (no autograd) and returns the
gradients in the JAX pytree layout, ``[{"W", "b"}, ...]`` per stage.

Faithful reference quirk: when the last stage owns ZERO Linears (e.g. 8
sizes at PP=8), the no-relu-on-final-Linear rule never fires — the global
final Linear (owned by the second-to-last stage) keeps its ReLU, so that
layout is architecturally DIFFERENT from the sequential model.
"""

import dataclasses
import warnings
from typing import Sequence

import torch
from torch import nn

from shallowspeed_tpu_torch import ops
from shallowspeed_tpu_torch.init import linear_init


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Static description of one pipeline stage."""

    local_sizes: tuple  # activation dims owned by this stage, len = n_linears+1
    relu_flags: tuple  # per-Linear fused-activation flag (act names which one)
    has_head: bool  # softmax + MSE head lives on the last stage
    global_batch_size: int
    act: str = "relu"  # activation family: "relu" (MLP) or "gelu" (block zoo)
    residual_flags: tuple = ()  # per-Linear: output += the PREVIOUS Linear's
    # input; () means no residuals (every relu-family spec)

    @property
    def n_linears(self):
        return len(self.local_sizes) - 1

    @property
    def in_dim(self):
        return self.local_sizes[0]

    @property
    def out_dim(self):
        return self.local_sizes[-1]

    @property
    def res_flags(self):
        """residual_flags normalized to one bool per Linear."""
        if len(self.residual_flags) == self.n_linears:
            return self.residual_flags
        return (False,) * self.n_linears


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of the whole (possibly pipelined) model."""

    sizes: tuple
    n_stages: int
    global_batch_size: int
    stages: tuple  # tuple[StageSpec]
    act: str = "relu"

    @property
    def in_dim(self):
        return self.sizes[0]

    @property
    def out_dim(self):
        return self.sizes[-1]


def partition_sizes(sizes: Sequence[int], n_stages: int):
    """Slice the global layer-size list into per-stage local size lists,
    with the overlapping boundary entry and the possibility of a 0-Linear
    trailing stage."""
    sizes = tuple(int(s) for s in sizes)
    if len(sizes) % n_stages != 0:
        raise ValueError(
            f"len(sizes)={len(sizes)} must be divisible by n_stages={n_stages}"
        )
    stage_size = len(sizes) // n_stages
    return [
        sizes[i * stage_size : min(len(sizes), i * stage_size + stage_size + 1)]
        for i in range(n_stages)
    ]


def make_model_spec(sizes, n_stages, global_batch_size, act="relu") -> ModelSpec:
    if act not in ("relu", "gelu"):
        raise ValueError(f"unknown activation family {act!r} (relu|gelu)")
    locals_ = partition_sizes(sizes, n_stages)
    stage_size = len(sizes) // n_stages
    n_lin_total = len(sizes) - 1
    if act == "gelu" and n_stages > 1 and stage_size % 2 != 0:
        raise ValueError(
            f"gelu-family models need an even per-stage slice so local slot "
            f"parity equals global Linear parity; len(sizes)={len(sizes)} "
            f"over {n_stages} stages gives {stage_size}"
        )
    if act == "relu" and len(locals_[-1]) == 1:
        warnings.warn(
            f"the last of {n_stages} pipeline stages owns no Linear under "
            "this partitioning, so the 'no relu on the final Linear' rule "
            "never fires and the trained MODEL differs from shallower "
            "partitionings (faithful reference quirk) — expect worse "
            "accuracy; prefer a size list that gives every stage a Linear",
            stacklevel=2,
        )
    stages = []
    for i, loc in enumerate(locals_):
        is_last = i == n_stages - 1
        n_lin = len(loc) - 1
        if act == "relu":
            # last Linear of last stage has no activation
            act_flags = tuple(
                not (is_last and l == n_lin - 1) for l in range(n_lin)
            )
            res_flags = ()
        else:
            # transformer-style blocks: even global Linear g is the
            # up-projection (gelu), odd g the down-projection whose output
            # takes the block-input residual when the dims agree; the
            # GLOBAL final Linear feeds the softmax head raw
            act_flags = []
            res_flags = []
            for l in range(n_lin):
                g = i * stage_size + l
                act_flags.append(g % 2 == 0 and g != n_lin_total - 1)
                res_flags.append(g % 2 == 1 and sizes[g - 1] == sizes[g + 1])
            act_flags = tuple(act_flags)
            res_flags = tuple(res_flags)
        stages.append(
            StageSpec(
                local_sizes=tuple(loc),
                relu_flags=act_flags,
                has_head=is_last,
                global_batch_size=global_batch_size,
                act=act,
                residual_flags=res_flags,
            )
        )
    return ModelSpec(
        sizes=tuple(int(s) for s in sizes),
        n_stages=n_stages,
        global_batch_size=global_batch_size,
        stages=tuple(stages),
        act=act,
    )


# Named configurations; ``mnist-mlp`` is the flagship reference model.
MODEL_ZOO = {
    # the reference ShallowSpeed MNIST MLP
    "mnist-mlp": dict(sizes=(784, 128, 127, 126, 125, 124, 123, 10), act="relu"),
    # compute-bound MLP, same depth as the flagship
    "mlp-wide": dict(sizes=(784, 512, 512, 512, 512, 512, 512, 10), act="relu"),
    # 23 Linears x 2048 wide
    "mlp-deep": dict(sizes=(784,) + (2048,) * 22 + (10,), act="relu"),
    # transformer-style blocks: 256-wide trunk, 1024-wide gelu up/down
    # projections with residual adds on every dim-matched block
    "transformer": dict(
        sizes=(784, 1024, 256, 1024, 256, 1024, 256, 10), act="gelu"
    ),
}


def resolve_model(name):
    """MODEL_ZOO name -> (sizes, act)."""
    try:
        entry = MODEL_ZOO[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; zoo: {', '.join(sorted(MODEL_ZOO))}"
        ) from None
    return tuple(entry["sizes"]), entry["act"]


def init_stage_params(spec: StageSpec):
    """Host-side deterministic init for one stage; list of {"W","b"} numpy."""
    return [
        dict(zip(("W", "b"), linear_init(spec.local_sizes[l], spec.local_sizes[l + 1])))
        for l in range(spec.n_linears)
    ]


def init_model(spec: ModelSpec):
    """Per-stage parameter lists of {"W","b"} (host numpy), the JAX
    package's pytree layout; ``convert.params_from_numpy`` makes modules."""
    return [init_stage_params(s) for s in spec.stages]


class Stage(nn.Module):
    """One pipeline stage's Linears: ``W[l]`` is ``(out, in)``, ``b[l]`` is
    ``(1, out)``. Inference holds no autograd state (requires_grad off)."""

    def __init__(self, weights, biases):
        super().__init__()
        self.W = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in weights]
        )
        self.b = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for b in biases]
        )


# ---------------------------------------------------------------------------
# Forward. Residuals per stage, as in the JAX package: (layer_caches, z)
#   layer_caches: per Linear (x_in, mask) — mask the relu bitmask, or the
#                 gelu derivative multiplier, or an empty placeholder
#   z:            head-input logits if has_head else an empty placeholder
# ---------------------------------------------------------------------------


def _placeholder(like, dtype=torch.float32):
    return torch.zeros((0,), dtype=dtype, device=like.device)


@torch.no_grad()
def stage_forward(params: Stage, spec: StageSpec, x, head_group_rows=None):
    """Run one stage's Linears (+head); return (out, residuals).

    ``head_group_rows``: when several microbatches are fused into one call,
    the softmax head's stability max is taken per group of this many rows
    so the result equals a per-microbatch loop."""
    caches = []
    if spec.act == "gelu":
        res = spec.res_flags
        x_prev = None  # input of the PREVIOUS Linear (the block input)
        for l in range(spec.n_linears):
            y = ops.linear(x, params.W[l], params.b[l])
            if spec.relu_flags[l]:
                caches.append((x, ops.gelu_grad_mult(y)))
                y_act = ops.gelu(y)
            else:
                caches.append((x, _placeholder(x)))
                y_act = y
            if res[l]:
                y_act = y_act + x_prev
            x_prev = x
            x = y_act
    else:
        for l in range(spec.n_linears):
            if spec.relu_flags[l]:
                y, mask = ops.linear_relu_fused(x, params.W[l], params.b[l])
                caches.append((x, mask))
            else:
                y = ops.linear(x, params.W[l], params.b[l])
                caches.append((x, _placeholder(x, torch.bool)))
            x = y
    if spec.has_head:
        z = x
        out = ops.softmax(z, group_rows=head_group_rows)
        return out, (tuple(caches), z)
    return x, (tuple(caches), _placeholder(x))


def model_forward(params_list, spec: ModelSpec, x, head_group_rows=None):
    """Chain all stages (the sequential / single-process path)."""
    residuals = []
    for params, sspec in zip(params_list, spec.stages):
        x, res = stage_forward(params, sspec, x, head_group_rows=head_group_rows)
        residuals.append(res)
    return x, residuals


def param_tree(stages):
    """The JAX pytree view of ``Stage`` modules: per stage a list of
    ``{"W", "b"}`` dicts holding the modules' own tensors (no copy), the
    layout the gradients and the optimizer state share. The tensors are read
    from each ParameterList's own dict, in its order: its per-item lookup
    costs ~2 µs a leaf, and the step graph's key reads every leaf a step."""
    return [
        [
            {"W": w, "b": b}
            for w, b in zip(stage.W._parameters.values(), stage.b._parameters.values())
        ]
        for stage in stages
    ]


# ---------------------------------------------------------------------------
# Backward: hand-written VJPs, the JAX package's expressions in its order
# ---------------------------------------------------------------------------


@torch.no_grad()
def stage_backward(params: Stage, spec: StageSpec, residuals, dout, head_group_rows=None):
    """Backward through one stage; returns (dx, grads) with grads the
    stage's ``[{"W", "b"}, ...]`` (``b`` as ``(1, out)``).

    For the head stage ``dout`` is the TARGET microbatch (the softmax-MSE
    head's backward consumes it); for other stages it is the gradient with
    respect to this stage's output. The relu family's hidden Linears run
    ``ops.linear_relu_grad_fused`` (the kernel on the card); the last
    Linear and the gelu family run the plain VJPs."""
    caches, z = residuals
    if spec.has_head:
        g = ops.softmax_mse_head_grad(
            z, dout, spec.global_batch_size, group_rows=head_group_rows
        )
    else:
        g = dout
    grads = [None] * spec.n_linears
    if spec.act == "gelu":
        res = spec.res_flags
        g_prev = None  # incoming grad at the previously-processed Linear l+1
        for l in reversed(range(spec.n_linears)):
            x_in, dact = caches[l]
            g_in = g
            g_pre = g_in * dact if spec.relu_flags[l] else g_in
            g, dw, db = ops.linear_grad(g_pre, x_in, params.W[l])
            if l + 1 < spec.n_linears and res[l + 1]:
                # the residual at l+1 adds this Linear's INPUT to y_{l+1}:
                # the incoming grad there flows straight into dx here
                g = g + g_prev
            grads[l] = {"W": dw, "b": db.reshape(1, -1)}
            g_prev = g_in
    else:
        for l in reversed(range(spec.n_linears)):
            x_in, bitmask = caches[l]
            if spec.relu_flags[l]:
                g, dw, db = ops.linear_relu_grad_fused(g, bitmask, x_in, params.W[l])
            else:
                g, dw, db = ops.linear_grad(g, x_in, params.W[l])
            grads[l] = {"W": dw, "b": db.reshape(1, -1)}
    return g, grads


def model_backward(params_list, spec: ModelSpec, residuals, target, head_group_rows=None):
    """Chain all stages backward; ``target`` feeds the head stage."""
    g = target
    grads_list = [None] * spec.n_stages
    for i in reversed(range(spec.n_stages)):
        g, grads_list[i] = stage_backward(
            params_list[i], spec.stages[i], residuals[i], g,
            head_group_rows=head_group_rows,
        )
    return g, grads_list
