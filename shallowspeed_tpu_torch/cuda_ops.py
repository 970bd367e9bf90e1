"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

The counterpart of ``shallowspeed_tpu/pallas_ops.py``. Two kernels:

- ``linear_act_fwd(x, W, b, apply_relu) -> (y, mask)``, built from
  ``csrc/linear_act_fwd.cu``: ``z = x @ W.T + b``, ``y = relu(z)`` when
  ``apply_relu`` else ``z``, ``mask = z > 0`` (torch.bool). It replaces both
  regimes of the TPU forward (``linear_relu_fwd``, single-block and
  grid-tiled): on Hopper one tiled kernel covers every shape.
  ``linear_relu_fwd`` keeps the JAX name and pins ``apply_relu=1``.
- ``linear_act_bwd(g, mask, x, W, apply_relu) -> (dx, dW, db)``, built from
  ``csrc/linear_act_bwd.cu``: ``ge = g * mask`` (``g`` when not
  ``apply_relu``), ``dx = ge @ W``, ``dW = ge.T @ x``, ``db = sum_rows(ge)``
  in one launch. It replaces both regimes of the TPU backward
  (``linear_relu_bwd``, single-block and grid-tiled). ``linear_relu_bwd``
  keeps the JAX name and pins ``apply_relu=1``.

Dispatch is by the device of the tensors and nothing else: CPU tensors
run the plain version (``*_reference``), CUDA tensors launch the kernel or
raise — there is no fallback from one to the other. Every launch adds one
to ``LAUNCHES[<kernel>]``, so a caller can show that its path went through
the kernel.
"""

import ctypes
import functools

import torch

LAUNCHES = {"linear_act_fwd": 0, "linear_act_bwd": 0}

# each kernel's C entry point: (pointer arguments, int arguments), then the
# stream; tests/test_torch_kernels.py holds this to the sources' signatures
SIGNATURES = {"linear_act_fwd": (5, 4), "linear_act_bwd": (7, 4)}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cuda_operands(kernel, device, **tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on ``device``,
    float32 (bool for ``mask``)."""
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(
                f"{kernel}: {name} is on {t.device}, the first operand on "
                f"{device} — all operands must be on one CUDA device"
            )
        want = torch.bool if name == "mask" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, needs {want}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _launch(kernel, *args):
    """Call a kernel's C entry point on the current stream; count it."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = _fn(kernel)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")
    LAUNCHES[kernel] += 1


@functools.cache
def _fn(name):
    from shallowspeed_tpu_torch import _build

    fn = getattr(_build.load(name), name)
    n_ptrs, n_ints = SIGNATURES[name]
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# forward: linear_act_fwd (B1, B2)
# ---------------------------------------------------------------------------


def linear_act_fwd_reference(x, w, b, apply_relu=True):
    """Plain PyTorch version of the kernel: the CPU path and the kernel's
    oracle. ``b`` may be ``(out,)`` or ``(1, out)``."""
    z = torch.matmul(x, w.T) + b.reshape(1, -1)
    y = torch.relu(z) if apply_relu else z
    return y, z > 0


def linear_act_fwd(x, w, b, apply_relu=True):
    """``(y, mask)`` of ``z = x @ w.T + b`` — the kernel on CUDA tensors,
    the plain version on CPU tensors. x ``(M, K)``, w ``(N, K)``, b
    ``(N,)`` or ``(1, N)``; all float32 and contiguous on one device."""
    if not (x.is_cuda or w.is_cuda or b.is_cuda):
        return linear_act_fwd_reference(x, w, b, apply_relu)
    _check_cuda_operands("linear_act_fwd", x.device, x=x, w=w, b=b)
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
    _launch("linear_act_fwd", x, w, b, y, mask, M, N, K, int(bool(apply_relu)))
    return y, mask


def linear_relu_fwd(x, w, b):
    """The TPU kernel's name and contract: ``(relu(z), z > 0)``."""
    return linear_act_fwd(x, w, b, apply_relu=True)


# ---------------------------------------------------------------------------
# backward: linear_act_bwd (B3, B4)
# ---------------------------------------------------------------------------


def linear_act_bwd_reference(g, mask, x, w, apply_relu=True):
    """Plain PyTorch version of the kernel: the CPU path and the kernel's
    oracle. ``ops.linear_grad`` of ``ge = g * mask`` (a multiply by the
    float mask, as ``ops.relu_grad`` writes it: NaN * 0 stays NaN), or of
    ``g`` when not ``apply_relu``. ``db`` is ``(N,)``."""
    ge = g * mask.to(g.dtype) if apply_relu else g
    return torch.matmul(ge, w), torch.matmul(ge.T, x), ge.sum(dim=0)


def linear_act_bwd(g, mask, x, w, apply_relu=True):
    """``(dx, dw, db)`` of the Linear (+ relu) that produced ``mask`` — the
    kernel on CUDA tensors, the plain version on CPU tensors. g ``(M, N)``
    float32, mask ``(M, N)`` bool (read only when ``apply_relu``; may then
    be None), x ``(M, K)``, w ``(N, K)``; contiguous on one device. Returns
    dx ``(M, K)``, dw ``(N, K)``, db ``(N,)``."""
    apply_relu = bool(apply_relu)
    if apply_relu and mask is None:
        raise ValueError("linear_act_bwd: apply_relu needs the forward's mask")
    operands = dict(g=g, x=x, w=w)
    if apply_relu:
        operands["mask"] = mask
    if not any(t.is_cuda for t in operands.values()):
        return linear_act_bwd_reference(g, mask, x, w, apply_relu)
    _check_cuda_operands("linear_act_bwd", g.device, **operands)
    if g.dim() != 2 or x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"linear_act_bwd: g, x and w must be 2-D, got {tuple(g.shape)}, "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    M, N = g.shape
    K = x.shape[1]
    if x.shape[0] != M or tuple(w.shape) != (N, K):
        raise ValueError(
            f"linear_act_bwd: g {tuple(g.shape)}, x {tuple(x.shape)} and w "
            f"{tuple(w.shape)} do not fit (M, N), (M, K), (N, K)"
        )
    if apply_relu and tuple(mask.shape) != (M, N):
        raise ValueError(
            f"linear_act_bwd: mask is {tuple(mask.shape)}, g is {(M, N)}"
        )
    dev = g.device
    dx = torch.empty((M, K), dtype=torch.float32, device=dev)
    dw = torch.empty((N, K), dtype=torch.float32, device=dev)
    db = torch.empty((N,), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:  # empty sums: nothing to launch
        return dx.zero_(), dw.zero_(), db.zero_()
    # without the relu the kernel never reads the mask; g stands in as a
    # valid device address
    _launch(
        "linear_act_bwd",
        g, mask if apply_relu else g, x, w, dx, dw, db, M, N, K, int(apply_relu),
    )
    return dx, dw, db


def linear_relu_bwd(g, mask, x, w):
    """The TPU kernel's name and contract: ``(dx, dw, db)`` of ``g * mask``."""
    return linear_act_bwd(g, mask, x, w, apply_relu=True)
