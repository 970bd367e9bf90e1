"""The port's kernel module (shallowspeed_tpu_torch/cuda_ops.py) against the
JAX package's Pallas kernels.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py`` (the CPU test run has no GPU and no nvcc). Here the plain
versions are held against ``pallas_ops.linear_relu_fwd`` and
``pallas_ops.linear_relu_bwd`` run in interpret mode, as
tests/test_pallas_ops.py runs them, in both of their regimes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from shallowspeed_tpu import ops as jops
from shallowspeed_tpu import pallas_ops
from shallowspeed_tpu.api import FLAGSHIP_SIZES
from shallowspeed_tpu_torch import _build, cuda_ops

# fp32 sums in another order than XLA's: measured on the CPU, a
# 2048-deep layer differs by 2.4e-6 at magnitude 3.8
RTOL, ATOL = 1e-5, 1e-5


def _operands(rows, din, dout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, din).astype(np.float32)
    w = (rng.randn(dout, din) / np.sqrt(din)).astype(np.float32)
    b = (0.1 * rng.randn(1, dout)).astype(np.float32)
    return x, w, b


def _both(x, w, b):
    y_j, mask_j = pallas_ops.linear_relu_fwd(x, w, b, precision=lax.Precision.HIGHEST)
    y_t, mask_t = cuda_ops.linear_act_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    )
    z = x.astype(np.float64) @ w.T.astype(np.float64) + b
    return np.asarray(y_j), np.asarray(mask_j) > 0, y_t.numpy(), mask_t.numpy(), z


@pytest.mark.parametrize(
    "din,dout", list(zip(FLAGSHIP_SIZES[:-2], FLAGSHIP_SIZES[1:-1]))
)
def test_reference_matches_pallas_single_block(din, dout):
    """Every flagship relu layer at one 8-row serving slot."""
    y_j, m_j, y_t, m_t, z = _both(*_operands(8, din, dout, seed=din))
    np.testing.assert_allclose(y_t, y_j, rtol=RTOL, atol=ATOL)
    stable = np.abs(z) > 1e-5
    np.testing.assert_array_equal(m_t[stable], m_j[stable])
    assert m_t.dtype == np.bool_


def test_reference_matches_pallas_tiled(monkeypatch):
    """The grid-tiled regime, forced as test_pallas_ops.py forces it, on a
    shape ragged in every dimension."""
    monkeypatch.setattr(pallas_ops, "SINGLE_BLOCK_BUDGET_BYTES", 0)
    monkeypatch.setattr(pallas_ops, "TILE", 128)
    y_j, m_j, y_t, m_t, z = _both(*_operands(37, 29, 23, seed=7))
    np.testing.assert_allclose(y_t, y_j, rtol=RTOL, atol=ATOL)
    stable = np.abs(z) > 1e-5
    np.testing.assert_array_equal(m_t[stable], m_j[stable])


def test_reference_without_relu_matches_linear():
    """apply_relu=0 (the flag kernels' identity slot): y is z itself."""
    x, w, b = _operands(37, 29, 23, seed=3)
    y_t, m_t = cuda_ops.linear_act_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), False
    )
    z = np.asarray(jops.linear(x, w, b))
    np.testing.assert_allclose(y_t.numpy(), z, rtol=RTOL, atol=ATOL)
    assert (y_t.numpy() < 0).any()  # negatives survive without the relu
    stable = np.abs(z) > 1e-5
    np.testing.assert_array_equal(m_t.numpy()[stable], (z > 0)[stable])


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    """A CPU tensor takes the plain version and counts no launch; a 1-D
    bias and the (1, out) bias give the same bits."""
    x, w, b = (torch.from_numpy(a) for a in _operands(8, 784, 128))
    before = dict(cuda_ops.LAUNCHES)
    y, mask = cuda_ops.linear_relu_fwd(x, w, b)
    y1, mask1 = cuda_ops.linear_act_fwd(x, w, b.reshape(-1), True)
    assert cuda_ops.LAUNCHES == before
    ref_y, ref_mask = cuda_ops.linear_act_fwd_reference(x, w, b)
    assert torch.equal(y, ref_y) and torch.equal(mask, ref_mask)
    assert torch.equal(y, y1) and torch.equal(mask, mask1)
    assert torch.equal(y, torch.relu(y))


def test_relu_keeps_nan():
    """NaN propagates through the relu (as jnp.maximum does), so a poisoned
    weight stays visible to the serving engine's finiteness gate."""
    x, w, b = (torch.from_numpy(a) for a in _operands(4, 6, 5))
    w[0, 0] = float("nan")
    y, mask = cuda_ops.linear_act_fwd_reference(x, w, b)
    assert torch.isnan(y[:, 0]).all() and not mask[:, 0].any()


def test_reset_launches():
    cuda_ops.LAUNCHES["linear_act_fwd"] += 3
    cuda_ops.LAUNCHES["linear_act_bwd"] += 2
    cuda_ops.LAUNCHES["fused_train"] += 1
    cuda_ops.LAUNCHES["linear_flag_fwd"] += 4
    cuda_ops.LAUNCHES["linear_flag_bwd"] += 5
    cuda_ops.reset_launches()
    assert cuda_ops.LAUNCHES == {
        "linear_act_fwd": 0, "linear_act_bwd": 0, "fused_train": 0,
        "linear_flag_fwd": 0, "linear_flag_bwd": 0,
    }


# ---------------------------------------------------------------------------
# backward: linear_act_bwd_reference against pallas_ops.linear_relu_bwd
# ---------------------------------------------------------------------------

# dx sums over N and dW/db over the rows, in another order than XLA's: the
# forward's class above
BWD_RTOL, BWD_ATOL = 1e-5, 1e-5


def _bwd_operands(rows, din, dout, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(rows, dout).astype(np.float32)
    mask = rng.rand(rows, dout) > 0.5
    x = rng.randn(rows, din).astype(np.float32)
    w = (rng.randn(dout, din) / np.sqrt(din)).astype(np.float32)
    return g, mask, x, w


def _bwd_both(jax_fn, g, mask, x, w):
    got = cuda_ops.linear_act_bwd_reference(
        *(torch.from_numpy(a) for a in (g, mask, x, w))
    )
    want = jax_fn(g, mask.astype(np.float32), x, w, precision=lax.Precision.HIGHEST)
    for t, j in zip(got, want):
        np.testing.assert_allclose(
            t.numpy(), np.asarray(j).reshape(t.shape), rtol=BWD_RTOL, atol=BWD_ATOL
        )
    assert got[2].shape == (g.shape[1],)


@pytest.mark.parametrize(
    "din,dout", list(zip(FLAGSHIP_SIZES[:-2], FLAGSHIP_SIZES[1:-1]))
)
def test_bwd_reference_matches_pallas_single_block(din, dout):
    """Every flagship relu layer at one 32-row training microbatch."""
    _bwd_both(pallas_ops.linear_relu_bwd, *_bwd_operands(32, din, dout, seed=din))


def test_bwd_reference_matches_pallas_tiled():
    """The grid-tiled regime (two pallas_calls, tile 128) on a shape ragged
    in every dimension with several tiles along each."""

    def tiled(g, mask, x, w, precision):
        return pallas_ops.linear_relu_bwd_tiled(g, mask, x, w, tile=128, precision=precision)

    _bwd_both(tiled, *_bwd_operands(300, 260, 200, seed=11))


def test_bwd_reference_without_relu_is_linear_grad():
    """apply_relu=0 (the flag kernels' identity slot): the mask is not read
    and the result is ops.linear_grad of g itself."""
    g, mask, x, w = _bwd_operands(37, 29, 23, seed=5)
    got = cuda_ops.linear_act_bwd_reference(
        torch.from_numpy(g), None, torch.from_numpy(x), torch.from_numpy(w), False
    )
    want = jops.linear_grad(g, x, w)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=BWD_RTOL, atol=BWD_ATOL)
    same = cuda_ops.linear_act_bwd(
        torch.from_numpy(g), torch.from_numpy(mask), torch.from_numpy(x),
        torch.from_numpy(w), apply_relu=0,
    )
    assert all(torch.equal(a, b) for a, b in zip(got, same))


def test_bwd_nan_at_masked_position_propagates_like_jax(monkeypatch):
    """A NaN or Inf in g where the mask is off: g * mask is NaN (a multiply,
    not a select), so the poisoned gradient reaches dx's row, dW's row and
    db — exactly where ops.linear_relu_grad_fused puts it with the JAX
    kernel backend on (the Pallas kernel multiplies by an f32 mask). The
    JAX package's XLA path is not the oracle here: XLA rewrites
    ``g * convert(mask)`` into a select and gives 0 (ROADMAP.md §C)."""
    monkeypatch.setattr(jops, "_PALLAS", True)
    g, mask, x, w = _bwd_operands(6, 9, 7, seed=2)
    mask[0, 1] = mask[3, 4] = False
    g[0, 1], g[3, 4] = np.nan, np.inf
    got = cuda_ops.linear_relu_bwd(*(torch.from_numpy(a) for a in (g, mask, x, w)))
    want = jops.linear_relu_grad_fused(
        *(jnp.asarray(a) for a in (g, mask, x, w)), precision=lax.Precision.HIGHEST
    )
    for t, j in zip(got, want):
        t, j = t.numpy(), np.asarray(j)
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        ok = np.isfinite(j)
        np.testing.assert_allclose(t[ok], j[ok], rtol=BWD_RTOL, atol=BWD_ATOL)
    assert np.isnan(got[0].numpy()[[0, 3]]).all()
    assert np.isnan(got[2].numpy()[[1, 4]]).all() and np.isfinite(got[2].numpy()[0])


def test_bwd_wrapper_on_cpu_runs_plain_version_without_launch():
    """A CPU tensor takes the plain version and counts no launch; it is
    bitwise ops.linear_grad(ops.relu_grad(g, mask), x, w); relu without a
    mask raises."""
    from shallowspeed_tpu_torch import ops as tops

    g, mask, x, w = (torch.from_numpy(a) for a in _bwd_operands(32, 128, 127))
    before = dict(cuda_ops.LAUNCHES)
    got = cuda_ops.linear_relu_bwd(g, mask, x, w)
    assert cuda_ops.LAUNCHES == before
    want = tops.linear_grad(tops.relu_grad(g, mask), x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tuple(got[0].shape) == (32, 128) and tuple(got[1].shape) == (127, 128)
    with pytest.raises(ValueError, match="mask"):
        cuda_ops.linear_act_bwd(g, None, x, w, apply_relu=True)


def test_build_is_keyed_by_source_and_flags():
    """The library name hashes the source and the nvcc flags; the target is
    Hopper's sm_90a; every kernel named by the package has a source."""
    p = _build.library_path("linear_act_fwd")
    assert p == _build.library_path("linear_act_fwd")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("linear_act_fwd-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert set(cuda_ops.LAUNCHES) == set(cuda_ops.KERNEL_OF)
    for name in cuda_ops.KERNEL_OF.values():
        assert (_build.CSRC / f"{name}.cu").is_file()


@pytest.mark.parametrize("entry", sorted(cuda_ops.KERNEL_OF))
def test_ctypes_signature_matches_the_source(entry):
    """The argtypes each wrapper entry declares match the C entry point of
    the kernel it launches (pointers, then ints, then the stream): a
    mismatch shows only on the card otherwise. The flag entries launch the
    ``linear_act_*`` kernels."""
    import re

    name = cuda_ops.KERNEL_OF[entry]
    src = (_build.CSRC / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
    kinds = ["ptr" if "*" in p else "int" for p in params]
    n_ptrs, n_ints = cuda_ops.SIGNATURES[name]
    assert kinds == ["ptr"] * n_ptrs + ["int"] * n_ints + ["ptr"]
    assert params[-1].strip() == "void* stream"


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    """Without a CUDA compiler the build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
