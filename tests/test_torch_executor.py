"""The port's pipeline executor (shallowspeed_tpu_torch/parallel/executor.py)
and its flag kernels against the JAX package's.

- The stacked layout (``slot_shapes``, ``relay_width``, ``stack_params``,
  ``unstack_params``) is a copy: held exactly.
- The flag kernels' plain versions (``cuda_ops.linear_flag_fwd`` /
  ``linear_flag_bwd`` on CPU tensors) against ``pallas_ops.linear_flag_fwd``
  / ``linear_flag_bwd`` in interpret mode, as tests/test_pallas_ops.py runs
  them: ``rtol=1e-6`` and ``atol=1e-6`` per 128 of the reduction's length
  single-block (XLA and PyTorch's CPU matmuls sum in different orders: a
  784-deep product of unit-normal operands differs by up to 2.3e-6),
  ``rtol=1e-5, atol=1e-7`` per 128 tiled (the JAX tiling pads the
  contraction and regroups its sums), masks equal.
- The executor on the CPU against ``E.make_pipeline_step`` (the XLA
  backend) on the 8-device virtual CPU mesh: 3 SGD steps on every layout of
  tests/test_executor.py's ``LAYOUTS`` at its ``SMALL`` sizes, both kernel
  backends, params and losses within the cross-engine class ``rtol=2e-4,
  atol=2e-6``; the flagship at DP=2 x PP=4 GPipe for one step; momentum
  and Adam with a binding clip; the inference program within 1e-6.
- Within the port: the pallas backend is bitwise the xla backend on the
  CPU, and every layout matches the port's sequential trainer within the
  executor's cross-layout class ``rtol=3e-4, atol=3e-6``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from shallowspeed_tpu import model as JM
from shallowspeed_tpu import pallas_ops
from shallowspeed_tpu import schedules as JS
from shallowspeed_tpu.optimizer import make_optimizer as jmake_optimizer
from shallowspeed_tpu.parallel import executor as JE
from shallowspeed_tpu.parallel import lower_schedule as jlower
from shallowspeed_tpu.parallel import make_mesh as jmesh
from shallowspeed_tpu_torch import convert, cuda_ops, trainer
from shallowspeed_tpu_torch import model as TM
from shallowspeed_tpu_torch import schedules as TS
from shallowspeed_tpu_torch.optimizer import make_optimizer
from shallowspeed_tpu_torch.parallel import executor as TE
from shallowspeed_tpu_torch.parallel.lowering import lower_schedule as tlower
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
MLP_DEEP = TM.MODEL_ZOO["mlp-deep"]["sizes"]
SMALL = (24, 20, 18, 16, 14, 12, 11, 10)  # tests/test_executor.py's
B, M, LR, NB = 64, 4, 0.01, 3
RTOL, ATOL = 2e-4, 2e-6  # cross-engine (tests/test_torch_oracle.py)
LAYOUT_RTOL, LAYOUT_ATOL = 3e-4, 3e-6  # cross-layout (tests/test_executor.py)

LAYOUTS = [  # tests/test_executor.py:78-88
    (1, 1, "GPipeSchedule"),
    (4, 1, "NaiveParallelSchedule"),
    (8, 1, "GPipeSchedule"),
    (1, 4, "NaiveParallelSchedule"),
    (1, 4, "GPipeSchedule"),
    (1, 4, "PipeDreamFlushSchedule"),
    (2, 4, "GPipeSchedule"),
    (2, 4, "PipeDreamFlushSchedule"),
    (2, 2, "NaiveParallelSchedule"),
]


def _data(sizes, nb=NB, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(nb, B, sizes[0]).astype(np.float32)
    Y = np.eye(sizes[-1], dtype=np.float32)[rng.randint(0, sizes[-1], (nb, B))]
    return X, Y


# ---------------------------------------------------------------------------
# The stacked layout: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sizes,pp", [(FLAGSHIP, 1), (FLAGSHIP, 2), (FLAGSHIP, 4), (MLP_DEEP, 4)],
    ids=["flagship-pp1", "flagship-pp2", "flagship-pp4", "mlp-deep-pp4"],
)
def test_stacked_layout_equal(sizes, pp):
    jspec = JM.make_model_spec(sizes, pp, 128)
    tspec = TM.make_model_spec(sizes, pp, 128)
    assert TE.slot_shapes(tspec) == JE.slot_shapes(jspec)
    assert TE.relay_width(tspec) == JE.relay_width(jspec)
    assert TE.stash_slot_nbytes(tspec, 16) == JE.stash_slot_nbytes(jspec, 16)
    params = JM.init_model(jspec)
    (jst, jfl), (tst, tfl) = JE.stack_params(params, jspec), TE.stack_params(params, tspec)
    for k in ("W", "b"):
        assert len(tst[k]) == len(jst[k])
        for a, b in zip(tst[k], jst[k]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(tfl) == set(jfl)
    for k in jfl:
        assert tfl[k].dtype == jfl[k].dtype and np.array_equal(tfl[k], jfl[k]), k
    back = TE.unstack_params(convert.stacked_from_numpy(params, tspec, "cpu")[0], tspec)
    want = JE.unstack_params(jst, jspec)
    for sa, sb, s0 in zip(back, want, params):
        for la, lb, l0 in zip(sa, sb, s0):
            for k in ("W", "b"):
                assert np.array_equal(la[k], lb[k])
                assert np.array_equal(la[k], np.asarray(l0[k]).reshape(la[k].shape))


def test_flagship_pp4_slots_and_flags():
    """The flagship's PP=4 layout: slot 0 is (128, 784), so stages 1-3 run
    K = 784 over zero-padded inputs; 2/2/2/1 active Linears; the relay is
    127 wide; only the last stage's last Linear has no relu."""
    spec = TM.make_model_spec(FLAGSHIP, 4, 128)
    assert TE.slot_shapes(spec) == [(128, 784), (127, 128)]
    assert TE.relay_width(spec) == 127
    _, flags = TE.stack_params(TM.init_model(spec), spec)
    assert flags["active"].tolist() == [[True, True]] * 3 + [[True, False]]
    assert flags["relu"].tolist() == [[True, True]] * 3 + [[False, False]]
    assert flags["head_mask"][3].sum() == 10 and not flags["head_mask"][:3].any()


def test_mesh_shape_and_refusals(monkeypatch):
    mesh = VirtualMesh(2, 4, "cpu")
    assert mesh.shape == {"dp": 2, "pp": 4} and mesh.device == torch.device("cpu")
    # the default device is the card, as for every entry point: no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualMesh(2, 4)
    with pytest.raises(ValueError, match="dp must be a positive int"):
        VirtualMesh(0, 1)
    with pytest.raises(ValueError, match="pp must be a positive int"):
        VirtualMesh(1, 2.0)
    spec = TM.make_model_spec(SMALL, 4, B)
    # the JAX executor's pallas refusals, in its words (executor.py:1392-1409)
    for kw, match in (
        (dict(backward_split=True), "backward_split needs the XLA per-slot backward"),
        (dict(recompute=True), "recompute re-runs the stage forward through the XLA"),
    ):
        prog = tlower(TS.GPipeSchedule, 4, 4, **kw)
        with pytest.raises(ValueError, match=match):
            TE.make_pipeline_step(
                VirtualMesh(1, 4, "cpu"), spec, prog, 16, make_optimizer("sgd", LR),
                kernel_backend="pallas",
            )
    # virtual stages: the model's stages must be the mesh's pp x V
    with pytest.raises(ValueError, match="2 devices x 2 chunks"):
        TE.make_pipeline_step(
            VirtualMesh(1, 2, "cpu"), TM.make_model_spec(SMALL, 2, B),
            tlower(TS.InterleavedSchedule, 4, 2, virtual=2), 16, make_optimizer("sgd", LR),
        )
    prog = tlower(TS.GPipeSchedule, 4, 4)
    with pytest.raises(ValueError, match="kernel_backend"):
        TE.make_pipeline_step(VirtualMesh(1, 4, "cpu"), spec, prog, 16, make_optimizer("sgd", LR), kernel_backend="triton")
    with pytest.raises(ValueError, match="needs an optimizer"):
        TE.make_pipeline_step(VirtualMesh(1, 4, "cpu"), spec, prog, 16)
    gelu = TM.make_model_spec((784, 256, 256, 10), 2, B, act="gelu")
    with pytest.raises(ValueError, match="relu family only; use kernel_backend='xla'"):
        TE.make_pipeline_step(
            VirtualMesh(1, 2, "cpu"), gelu, tlower(TS.GPipeSchedule, 4, 2), 16,
            make_optimizer("sgd", LR), kernel_backend="pallas",
        )


# ---------------------------------------------------------------------------
# The flag kernels' plain versions against pallas_ops (interpret mode)
# ---------------------------------------------------------------------------


def _fwd_operands(rows, din, dout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, din).astype(np.float32)
    w = (rng.randn(dout, din) / np.sqrt(din)).astype(np.float32)
    b2 = (0.1 * rng.randn(1, dout)).astype(np.float32)
    return x, w, b2


FLAG_SHAPES = [  # (rows, K, N): executor slots, and a ragged shape
    (16, 784, 128), (16, 128, 127), (32, 784, 128), (37, 29, 23),
]


def _tiled(monkeypatch):
    monkeypatch.setattr(pallas_ops, "SINGLE_BLOCK_BUDGET_BYTES", 0)
    monkeypatch.setattr(pallas_ops, "TILE", 128)


def _tol(regime, length):
    """(rtol, atol) for a reduction of ``length`` terms (see the header)."""
    per = -(-length // 128)
    return (1e-6, 1e-6 * per) if regime == "single" else (1e-5, 1e-7 * per)


@pytest.mark.parametrize("regime", ["single", "tiled"])
@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("shape", FLAG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flag_fwd_plain_matches_pallas(monkeypatch, regime, flag, shape):
    if regime == "tiled":
        _tiled(monkeypatch)
    rtol, atol = _tol(regime, shape[1])
    x, w, b2 = _fwd_operands(*shape, seed=sum(shape) + flag)
    yj, mj = pallas_ops.linear_flag_fwd(
        x, w, b2, jnp.int32(flag), precision=lax.Precision.HIGHEST
    )
    yt, mt = cuda_ops.linear_flag_fwd(*(torch.from_numpy(a) for a in (x, w, b2)), flag)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=rtol, atol=atol)
    assert mt.dtype == torch.bool
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj) > 0)
    assert (yt.numpy() < 0).any() != bool(flag)  # negatives survive only without relu


def _bwd_operands(rows, din, dout, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(rows, dout).astype(np.float32)
    mask = rng.rand(rows, dout) > 0.5
    x = rng.randn(rows, din).astype(np.float32)
    w = (rng.randn(dout, din) / np.sqrt(din)).astype(np.float32)
    return g, mask, x, w


@pytest.mark.parametrize("regime", ["single", "tiled"])
@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("shape", FLAG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flag_bwd_plain_matches_pallas(monkeypatch, regime, flag, shape):
    if regime == "tiled":
        _tiled(monkeypatch)
    g, mask, x, w = _bwd_operands(*shape, seed=sum(shape) + 7 * flag)
    want = pallas_ops.linear_flag_bwd(
        g, mask.astype(np.float32), x, w, jnp.int32(flag), precision=lax.Precision.HIGHEST
    )
    got = cuda_ops.linear_flag_bwd(*(torch.from_numpy(a) for a in (g, mask, x, w)), flag)
    assert tuple(got[2].shape) == (1, shape[2])  # db as the TPU kernel returns it
    # dx reduces over N, dW and db over the rows
    for t, j, length in zip(got, want, (shape[2], shape[0], shape[0])):
        rtol, atol = _tol(regime, length)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_flag_bwd_nan_at_masked_position_matches_pallas():
    """A NaN / Inf in g where the mask is off: both multiply by the mask,
    so the poison reaches dx's row, dW's row and db (flag 1); with the flag
    off g passes unmasked either way."""
    g, mask, x, w = _bwd_operands(6, 9, 7, seed=2)
    mask[0, 1] = mask[3, 4] = False
    g[0, 1], g[3, 4] = np.nan, np.inf
    for flag in (0, 1):
        want = pallas_ops.linear_flag_bwd(
            g, mask.astype(np.float32), x, w, jnp.int32(flag), precision=lax.Precision.HIGHEST
        )
        got = cuda_ops.linear_flag_bwd(*(torch.from_numpy(a) for a in (g, mask, x, w)), flag)
        for t, j in zip(got, want):
            t, j = t.numpy(), np.asarray(j)
            np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
            ok = np.isfinite(j)
            np.testing.assert_allclose(t[ok], j[ok], rtol=1e-6, atol=1e-6)
        dx = got[0].numpy()
        if flag:  # NaN * 0 and Inf * 0 are NaN
            assert np.isnan(dx[[0, 3]]).all()
        else:  # the unmasked Inf reaches dx as Inf
            assert np.isnan(dx[0]).all() and np.isinf(dx[3]).all()


def test_flag_entries_on_cpu_count_no_launch_and_refuse_tensor_flags():
    x, w, b2 = (torch.from_numpy(a) for a in _fwd_operands(8, 12, 5, seed=1))
    before = dict(cuda_ops.LAUNCHES)
    y, mask = cuda_ops.linear_flag_fwd(x, w, b2, True)
    g = torch.randn(8, 5)
    dx, dw, db2 = cuda_ops.linear_flag_bwd(g, mask, x, w, 1)
    assert cuda_ops.LAUNCHES == before
    ry, rmask = cuda_ops.linear_act_fwd_reference(x, w, b2, True)
    assert torch.equal(y, ry) and torch.equal(mask, rmask)
    rdx, rdw, rdb = cuda_ops.linear_act_bwd_reference(g, mask, x, w, True)
    assert torch.equal(dx, rdx) and torch.equal(dw, rdw) and torch.equal(db2, rdb.reshape(1, -1))
    with pytest.raises(TypeError, match="host int"):
        cuda_ops.linear_flag_fwd(x, w, b2, torch.tensor(1))
    with pytest.raises(TypeError, match="host int"):
        cuda_ops.linear_flag_bwd(g, mask, x, w, torch.tensor(1))


# ---------------------------------------------------------------------------
# The executor against E.make_pipeline_step
# ---------------------------------------------------------------------------


@functools.cache
def _jax_run(sizes, dp, pp, sched, opt_name="sgd", lr=LR, clip_norm=None, nb=NB):
    """E.make_pipeline_step (XLA backend) from the deterministic init over
    ``nb`` batches: (logical params, losses)."""
    X, Y = _data(sizes, nb)
    mesh = jmesh(dp, pp)
    spec = JM.make_model_spec(sizes, pp, B)
    prog = jlower(getattr(JS, sched), M, pp)
    stacked, flags = JE.init_stacked(spec, mesh)
    opt = jmake_optimizer(opt_name, lr)
    state = opt.init(stacked)
    step = JE.make_pipeline_step(mesh, spec, prog, B // dp // M, opt, clip_norm=clip_norm)
    losses = []
    for i in range(nb):
        stacked, state, loss = step(stacked, flags, state, jnp.asarray(X[i]), jnp.asarray(Y[i]))
        losses.append(float(loss))
    return JE.unstack_params(stacked, spec), losses


def _torch_run(sizes, dp, pp, sched, kernel_backend, opt_name="sgd", lr=LR,
               clip_norm=None, nb=NB, epoch=False):
    X, Y = _data(sizes, nb)
    mesh = VirtualMesh(dp, pp, "cpu")
    spec = TM.make_model_spec(sizes, pp, B)
    prog = tlower(getattr(TS, sched), M, pp)
    stacked, flags = TE.init_stacked(spec, mesh)
    opt = make_optimizer(opt_name, lr)
    state = opt.init(stacked)
    kw = dict(clip_norm=clip_norm, kernel_backend=kernel_backend)
    if epoch:
        fn = TE.make_pipeline_epoch(mesh, spec, prog, B // dp // M, opt, **kw)
        stacked, state, mean = fn(stacked, flags, state, torch.from_numpy(X), torch.from_numpy(Y))
        return TE.unstack_params(stacked, spec), [float(mean)]
    step = TE.make_pipeline_step(mesh, spec, prog, B // dp // M, opt, **kw)
    losses = []
    for i in range(nb):
        stacked, state, loss = step(
            stacked, flags, state, torch.from_numpy(X[i]), torch.from_numpy(Y[i])
        )
        losses.append(float(loss))
    return TE.unstack_params(stacked, spec), losses


def _flat(params):
    return [layer for stage in params for layer in stage]


def _assert_close(got, want, rtol, atol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["W"], np.asarray(b["W"]), rtol=rtol, atol=atol)
        np.testing.assert_allclose(
            a["b"].reshape(-1), np.asarray(b["b"]).reshape(-1), rtol=rtol, atol=atol
        )


def _bitwise(a, b):
    return all(
        np.array_equal(x[k], y[k]) for x, y in zip(_flat(a), _flat(b)) for k in ("W", "b")
    )


@pytest.mark.parametrize("kernel_backend", ["xla", "pallas"])
@pytest.mark.parametrize("dp,pp,sched", LAYOUTS)
def test_layout_matches_jax(dp, pp, sched, kernel_backend):
    got, losses = _torch_run(SMALL, dp, pp, sched, kernel_backend)
    want, jlosses = _jax_run(SMALL, dp, pp, sched)
    _assert_close(got, want, RTOL, ATOL)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dp,pp,sched", LAYOUTS)
def test_pallas_backend_bitwise_xla_on_cpu(dp, pp, sched):
    """The JAX claim (tests/test_executor.py:119-144): the flag-kernel
    backend reproduces the XLA backend bit for bit — on the CPU both issue
    the same torch ops."""
    a, la = _torch_run(SMALL, dp, pp, sched, "xla")
    b, lb = _torch_run(SMALL, dp, pp, sched, "pallas")
    assert la == lb and _bitwise(a, b)


@functools.cache
def _sequential(sizes, nb=NB):
    """The port's sequential trainer (microbatch loop, SGD) over the same
    batches: the layouts' common oracle."""
    X, Y = _data(sizes, nb)
    spec = TM.make_model_spec(sizes, 1, B)
    params = convert.params_from_numpy(TM.init_model(spec), "cpu")
    step = trainer.make_train_step(spec, make_optimizer("sgd", LR))
    state = ()
    for i in range(nb):
        params, state = step(
            params, state,
            torch.from_numpy(X[i]).reshape(M, B // M, -1),
            torch.from_numpy(Y[i]).reshape(M, B // M, -1),
        )
    return convert.params_to_numpy(params)


@pytest.mark.parametrize("dp,pp,sched", LAYOUTS)
def test_layout_matches_port_sequential_trainer(dp, pp, sched):
    got, _ = _torch_run(SMALL, dp, pp, sched, "pallas")
    _assert_close(got, _sequential(SMALL), LAYOUT_RTOL, LAYOUT_ATOL)


def test_flagship_dp2_pp4_gpipe_one_step_matches_jax():
    """Full width, uneven 2/2/2/1 stages, the reference's DP=2 x PP=4."""
    got, losses = _torch_run(FLAGSHIP, 2, 4, "GPipeSchedule", "pallas", nb=1)
    want, jlosses = _jax_run(FLAGSHIP, 2, 4, "GPipeSchedule", nb=1)
    _assert_close(got, want, RTOL, ATOL)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)


# the gradient norm of SMALL's first batches is ~0.3: a clip of 0.05 binds
@pytest.mark.parametrize("opt_name,lr", [("momentum", LR), ("adam", 1e-3)])
def test_stateful_optimizer_with_binding_clip_matches_jax(opt_name, lr):
    got, losses = _torch_run(SMALL, 1, 4, "GPipeSchedule", "pallas", opt_name, lr, 0.05)
    want, jlosses = _jax_run(SMALL, 1, 4, "GPipeSchedule", opt_name, lr, 0.05)
    _assert_close(got, want, RTOL, ATOL)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    unclipped, _ = _torch_run(SMALL, 1, 4, "GPipeSchedule", "pallas", opt_name, lr)
    assert not _bitwise(got, unclipped)  # the clip changed the trajectory


def test_epoch_is_the_loop_of_steps():
    """``make_pipeline_epoch`` is the step loop: bitwise params, and its
    loss the mean of the steps' losses."""
    a, la = _torch_run(SMALL, 2, 4, "GPipeSchedule", "pallas", epoch=True)
    b, lb = _torch_run(SMALL, 2, 4, "GPipeSchedule", "pallas")
    assert _bitwise(a, b)
    np.testing.assert_allclose(la[0], np.mean(lb), rtol=1e-6)


def test_padded_regions_stay_zero_and_dp_replicas_share_one_copy():
    X, Y = _data(SMALL)
    mesh = VirtualMesh(2, 4, "cpu")
    spec = TM.make_model_spec(SMALL, 4, B)
    stacked, flags = TE.init_stacked(spec, mesh)
    opt = make_optimizer("momentum", LR)
    state = opt.init(stacked)
    step = TE.make_pipeline_step(mesh, spec, tlower(TS.GPipeSchedule, M, 4), B // 2 // M, opt)
    for i in range(NB):
        stacked, state, _ = step(stacked, flags, state, torch.from_numpy(X[i]), torch.from_numpy(Y[i]))
    for tree in (stacked, state):
        Ws = [w.numpy() for w in tree["W"]]
        bs = [b.numpy() for b in tree["b"]]
        for s, sspec in enumerate(spec.stages):
            for l in range(len(Ws)):
                if l < sspec.n_linears:
                    out_d, in_d = sspec.local_sizes[l + 1], sspec.local_sizes[l]
                    block = Ws[l][s].copy()
                    assert np.abs(block[:out_d, :in_d]).sum() > 0
                    block[:out_d, :in_d] = 0
                    assert (block == 0).all() and (bs[l][s, out_d:] == 0).all()
                else:
                    assert (Ws[l][s] == 0).all() and (bs[l][s] == 0).all()


@pytest.mark.parametrize("dp,pp", [(2, 4), (1, 4), (4, 1)])
def test_inference_program_matches_jax(dp, pp):
    X, _ = _data(SMALL)
    jspec, tspec = JM.make_model_spec(SMALL, pp, B), TM.make_model_spec(SMALL, pp, B)
    jst, jfl = JE.init_stacked(jspec, jmesh(dp, pp))
    jstep = JE.make_pipeline_step(
        jmesh(dp, pp), jspec, jlower(JS.InferenceSchedule, M, pp, training=False), B // dp // M
    )
    want = np.asarray(jstep(jst, jfl, jnp.asarray(X[0])))
    for kb in ("xla", "pallas"):
        tst, tfl = TE.init_stacked(tspec, VirtualMesh(dp, pp, "cpu"))
        tstep = TE.make_pipeline_step(
            VirtualMesh(dp, pp, "cpu"), tspec, tlower(TS.InferenceSchedule, M, pp, training=False),
            B // dp // M, kernel_backend=kb,
        )
        got = tstep(tst, tfl, torch.from_numpy(X[0])).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got[:, SMALL[-1]:] == 0).all()
    with pytest.raises(ValueError, match="rows"):
        tstep(tst, tfl, torch.from_numpy(X[0][:-1]))
