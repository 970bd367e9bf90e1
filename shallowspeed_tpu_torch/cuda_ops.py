"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

The counterpart of ``shallowspeed_tpu/pallas_ops.py``. One kernel so far:

- ``linear_act_fwd(x, W, b, apply_relu) -> (y, mask)``, built from
  ``csrc/linear_act_fwd.cu``: ``z = x @ W.T + b``, ``y = relu(z)`` when
  ``apply_relu`` else ``z``, ``mask = z > 0`` (torch.bool). It replaces both
  regimes of the TPU forward (``linear_relu_fwd``, single-block and
  grid-tiled): on Hopper one tiled kernel covers every shape.
  ``linear_relu_fwd`` keeps the JAX name and pins ``apply_relu=1``.

Dispatch is by the device of the tensors and nothing else: a CPU tensor
runs the plain version (``linear_act_fwd_reference``), a CUDA tensor
launches the kernel or raises — there is no fallback from one to the
other. Every launch adds one to ``LAUNCHES[<kernel>]``, so a caller can
show that its path went through the kernel.
"""

import ctypes
import functools

import torch

LAUNCHES = {"linear_act_fwd": 0}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def linear_act_fwd_reference(x, w, b, apply_relu=True):
    """Plain PyTorch version of the kernel: the CPU path and the kernel's
    oracle. ``b`` may be ``(out,)`` or ``(1, out)``."""
    z = torch.matmul(x, w.T) + b.reshape(1, -1)
    y = torch.relu(z) if apply_relu else z
    return y, z > 0


@functools.cache
def _fn():
    from shallowspeed_tpu_torch import _build

    fn = _build.load("linear_act_fwd").linear_act_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def linear_act_fwd(x, w, b, apply_relu=True):
    """``(y, mask)`` of ``z = x @ w.T + b`` — the kernel on CUDA tensors,
    the plain version on CPU tensors. x ``(M, K)``, w ``(N, K)``, b
    ``(N,)`` or ``(1, N)``; all float32 and contiguous on one device."""
    if not (x.is_cuda or w.is_cuda or b.is_cuda):
        return linear_act_fwd_reference(x, w, b, apply_relu)
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(
                f"linear_act_fwd: {name} is on {t.device}, x on {x.device} — "
                "all operands must be on one CUDA device"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"linear_act_fwd: {name} is {t.dtype}, needs float32")
        if not t.is_contiguous():
            raise ValueError(f"linear_act_fwd: {name} must be contiguous")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"linear_act_fwd: x and w must be 2-D, got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    M, K = x.shape
    N = w.shape[0]
    if w.shape[1] != K:
        raise ValueError(f"linear_act_fwd: w is {tuple(w.shape)}, x has K={K}")
    if b.numel() != N:
        raise ValueError(f"linear_act_fwd: b has {b.numel()} elements, w has N={N}")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    mask = torch.empty((M, N), dtype=torch.bool, device=x.device)
    if M == 0 or N == 0:
        return y, mask
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mask.data_ptr(), M, N, K, int(bool(apply_relu)), stream,
        )
    if err != 0:
        raise RuntimeError(f"linear_act_fwd: launch failed with CUDA error {err}")
    LAUNCHES["linear_act_fwd"] += 1
    return y, mask


def linear_relu_fwd(x, w, b):
    """The TPU kernel's name and contract: ``(relu(z), z > 0)``."""
    return linear_act_fwd(x, w, b, apply_relu=True)
