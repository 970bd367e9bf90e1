"""The port's kernel module (shallowspeed_tpu_torch/cuda_ops.py) against the
JAX package's Pallas kernels.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py`` (the CPU test run has no GPU and no nvcc). Here the plain
version is held against ``pallas_ops.linear_relu_fwd`` run in interpret
mode, as tests/test_pallas_ops.py runs it, in both of its regimes.
"""

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
    cuda_ops.reset_launches()
    assert cuda_ops.LAUNCHES == {"linear_act_fwd": 0}


def test_build_is_keyed_by_source_and_flags():
    """The library name hashes the source and the nvcc flags; the target is
    Hopper's sm_90a; every kernel named by the package has a source."""
    p = _build.library_path("linear_act_fwd")
    assert p == _build.library_path("linear_act_fwd")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("linear_act_fwd-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    for name in cuda_ops.LAUNCHES:
        assert (_build.CSRC / f"{name}.cu").is_file()


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    """Without a CUDA compiler the build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
