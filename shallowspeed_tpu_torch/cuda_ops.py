"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

The counterpart of ``shallowspeed_tpu/pallas_ops.py``. Three kernels:

- ``linear_act_fwd(x, W, b, apply_relu) -> (y, mask)``, built from
  ``csrc/linear_act_fwd.cu``: ``z = x @ W.T + b``, ``y = relu(z)`` when
  ``apply_relu`` else ``z``, ``mask = z > 0`` (torch.bool). It replaces both
  regimes of the TPU forward (``linear_relu_fwd``, single-block and
  grid-tiled): on Hopper one kernel covers every shape, with a launch plan
  sized to it (``fwd_plan``). ``linear_relu_fwd`` keeps the JAX name and
  pins ``apply_relu=1``.
- ``linear_act_bwd(g, mask, x, W, apply_relu) -> (dx, dW, db)``, built from
  ``csrc/linear_act_bwd.cu``: ``ge = g * mask`` (``g`` when not
  ``apply_relu``), ``dx = ge @ W``, ``dW = ge.T @ x``, ``db = sum_rows(ge)``
  in one launch (``bwd_plan``). It replaces both regimes of the TPU
  backward (``linear_relu_bwd``, single-block and grid-tiled).
  ``linear_relu_bwd`` keeps the JAX name and pins ``apply_relu=1``.
- ``fused_train_call(stage_params, x, y, ...)``, built from
  ``csrc/fused_train.cu``: a whole training batch (forward, softmax-MSE
  head, backward, optional global-norm clip, SGD / momentum / Adam update),
  a whole epoch or a whole run of epochs in one cooperative launch in thread
  block clusters — the TPU's fused train kernels
  (``pallas_ops.fused_train_call``) in their step, epoch and run modes. Its
  partition (``fused_plan``: head groups to clusters, columns to the blocks
  of a cluster, dW tiles) comes from the wrapper as ints, and a batch
  crosses 2 grid-wide barriers (3 with a clip). ``fused_train_reference`` is
  its plain version.

and the pipeline executor's two flag entries, which launch the first two
kernels with the relu chosen per call:

- ``linear_flag_fwd(x, W, b2, flag) -> (y, mask)``: ``linear_act_fwd`` with
  ``apply_relu = flag``, the TPU's ``linear_flag_fwd`` (single-block and
  grid-tiled, B5/B6). On the TPU one compiled kernel takes the traced flag
  as an SMEM operand; here the flag is a host int passed to the kernel as a
  run-time argument, so one compiled kernel serves every (stage, slot).
- ``linear_flag_bwd(g, mask, x, W, flag) -> (dx, dW, db2)``:
  ``linear_act_bwd`` with ``apply_relu = flag``, the TPU's
  ``linear_flag_bwd`` (B7/B8); ``db2`` is ``(1, out)`` as the TPU returns it.

Dispatch is by the device of the tensors and nothing else: CPU tensors
run the plain version (``*_reference``), CUDA tensors launch the kernel or
raise — there is no fallback from one to the other. Every launch adds one
to ``LAUNCHES[<entry>]`` (the flag entries count under their own names,
though they launch the ``linear_act_*`` kernels: ``KERNEL_OF`` maps each
entry to its source), so a caller can show that its path went through the
kernel. While the program trace records (``observability/spans.py``), a
launch also adds one to its counter ``cuda_ops.launches`` and the host ns
from the launching wrapper's entry to the C call's return to
``cuda_ops.launch_ns``. Inside ``capture_launches()`` a thread's launches
count into the block's own tally instead of ``LAUNCHES``: a CUDA graph's
capture runs the wrappers but launches nothing, and its replays count what
the capture tallied.

The two linear kernels take a launch plan from the wrapper (``fwd_plan``,
``bwd_plan``): a row tile sized to M, and the reduction split into chunks
over the blocks of a thread block cluster, added in rank order on chip.
The forward's chunking is a function of K alone, so a row's bits do not
depend on the other rows of the launch (the sources state the order rule).
At M >= 128 with N, K >= 512 and N * K >= 768 * 512 the backward's plan
is its wide family (``bwd_is_wide``: 128 x 128 tiles, N's chunks balanced
against the dW tiles on the card), counted in the trace's
``cuda_ops.bwd_wide_launches``.
"""

import contextlib
import ctypes
import functools
import heapq
import threading
import time

import torch

from shallowspeed_tpu_torch.observability import spans
from shallowspeed_tpu_torch.optimizer import _decay_factor, clip_tree

# each wrapper's launch-count entry -> the kernel (csrc/<name>.cu and its C
# entry point <name>) it launches
KERNEL_OF = {
    "linear_act_fwd": "linear_act_fwd",
    "linear_act_bwd": "linear_act_bwd",
    "fused_train": "fused_train",
    "linear_flag_fwd": "linear_act_fwd",
    "linear_flag_bwd": "linear_act_bwd",
}
LAUNCHES = dict.fromkeys(KERNEL_OF, 0)
_capturing = threading.local()  # .counts: this thread's capture tally, else None

# each kernel's C entry point: (pointer arguments, int arguments), then the
# stream; tests/test_torch_kernels.py holds this to the sources' signatures
SIGNATURES = {"linear_act_fwd": (5, 8), "linear_act_bwd": (7, 9), "fused_train": (6, 6)}

# The two linear kernels' launch plans. The sources take the plan as ints,
# check it and refuse any other (csrc/staging.cuh, chunks_cover; the tile
# dispatch of each entry point); tests/test_torch_kernel_plan.py holds these
# constants to the sources.
STAGE_DEPTH = 16  # staging.cuh BK: the reduction depth of one cp.async stage
MAX_CLUSTER = 8  # staging.cuh MAX_CLUSTER: the portable thread block cluster
CHUNK_TERMS = 32  # a reduction of L terms: at most min(8, ceil(L / 32)) chunks
ROW_TILES = (8, 16, 32, 64)  # a row tile sized to M (see row_tile)
FWD_COL_TILE = {8: 32, 16: 32, 32: 32, 64: 64}  # linear_act_fwd.cu's tiles
BWD_TILE = 64  # linear_act_bwd.cu: dx's column tile, dW's tile edge
SM_COUNT = 132  # an H100 SXM's SMs: below this many dW tiles, M splits over a cluster
# linear_act_bwd.cu's wide family: 128 x 128 tiles of both products, for
# M >= BWD_WIDE_MIN_ROWS, N, K >= BWD_WIDE_MIN_WIDTH and N * K >=
# BWD_WIDE_MIN_WEIGHTS, WIDE_BLOCKS_PER_SM blocks sharing an SM. The line is
# where the family beat the 64-wide plans on an H100 at 128-256 rows: it
# lost at 512 x 512 (by 10-41%) and, at 256 rows, at 512 x 640 and 512 x 704
# (N x K), and won from 768 x 512 and 640 x 640 up
BWD_WIDE_TILE = 128
BWD_WIDE_MIN_ROWS = 128
BWD_WIDE_MIN_WIDTH = 512
BWD_WIDE_MIN_WEIGHTS = 768 * 512
WIDE_BLOCKS_PER_SM = 1


def _cdiv(a, b):
    return -(-a // b)


def reduction_chunks(length):
    """``(chunks, chunk_len)``: a reduction of ``length`` terms cut into
    ``chunks`` consecutive chunks of ``chunk_len`` terms (the last one
    shorter), one per rank of a thread block cluster. A function of
    ``length`` alone, with chunk edges on stage edges: the forward's order
    rule, which keeps a row's bits independent of the other rows."""
    if length <= 0:
        return 1, 0
    want = min(MAX_CLUSTER, _cdiv(length, CHUNK_TERMS))
    chunk_len = _cdiv(_cdiv(length, want), STAGE_DEPTH) * STAGE_DEPTH
    return _cdiv(length, chunk_len), chunk_len


def row_tile(rows):
    """The row tile (one of ``ROW_TILES``) for ``rows`` rows: 8 or 16 for a
    serving slot and the executor's slots, 32 up to 64 rows (a microbatch),
    64 above (fused microbatches, the eval chunk)."""
    if rows <= 16:
        return 8 if rows <= 8 else 16
    return 32 if rows <= 64 else 64


def fwd_plan(M, N, K):
    """``linear_act_fwd``'s launch plan for x ``(M, K)``, W ``(N, K)``: a
    row x column output tile per block, K in ``chunks`` chunks of
    ``chunk_len`` over the ranks of a cluster of ``chunks`` blocks (the
    cluster size), and the grid ``(column tiles x chunks, row tiles)``."""
    rt = row_tile(M)
    ct = FWD_COL_TILE[rt]
    chunks, chunk_len = reduction_chunks(K)
    grid = (_cdiv(N, ct) * chunks, _cdiv(M, rt))
    return dict(row_tile=rt, col_tile=ct, chunks=chunks, chunk_len=chunk_len, grid=grid,
                blocks=grid[0] * grid[1])


def bwd_is_wide(M, N, K):
    """Whether ``linear_act_bwd`` at g ``(M, N)``, x ``(M, K)`` takes the
    wide family: FLOP-bound shapes, enough rows and weights for 128 x 128
    tiles to fill the card."""
    return (M >= BWD_WIDE_MIN_ROWS and min(N, K) >= BWD_WIDE_MIN_WIDTH
            and N * K >= BWD_WIDE_MIN_WEIGHTS)


def _makespan(blocks, slots):
    """Stages until the last of ``blocks`` (each its count of stages) ends,
    each started in grid order on the first of ``slots`` to come free."""
    free = [0] * slots
    for stages in blocks:
        heapq.heappush(free, heapq.heappop(free) + stages)
    return max(free)


def _wide_chunks(M, N, K):
    """dx's ``(chunks, chunk_len)`` of N in the wide family: of N cut into
    1 to 8 chunks on stage edges, the cut whose blocks (the dx blocks
    first, then the dW blocks, each reducing all of M) end soonest on the
    card's block slots; the fewer chunks on a tie, since each chunk adds a
    partial tile to the cluster's sum."""
    tiles_k = _cdiv(K, BWD_WIDE_TILE)
    dw_blocks = [_cdiv(M, STAGE_DEPTH)] * (_cdiv(N, BWD_WIDE_TILE) * tiles_k)
    best = None
    for want in range(1, MAX_CLUSTER + 1):
        chunk_len = _cdiv(_cdiv(N, want), STAGE_DEPTH) * STAGE_DEPTH
        chunks = _cdiv(N, chunk_len)
        dx_blocks = [chunk_len // STAGE_DEPTH] * (_cdiv(M, BWD_WIDE_TILE) * tiles_k * chunks)
        span = _makespan(dx_blocks + dw_blocks, WIDE_BLOCKS_PER_SM * SM_COUNT)
        if best is None or span < best[0]:
            best = (span, chunks, chunk_len)
    return best[1:]


def bwd_plan(M, N, K):
    """``linear_act_bwd``'s launch plan for g ``(M, N)``, x ``(M, K)``, W
    ``(N, K)``, in clusters of ``chunks`` blocks: dx in (row tile x 64)
    tiles with N in ``chunks`` chunks of ``chunk_len`` over a cluster
    (``dx_blocks`` blocks); then dW in 64 x 64 tiles (``dw_tiles``, at least
    one K-tile so that db is written). Too few dW tiles to fill the card
    (and more than one stage of rows) split M over a cluster too, in
    ``chunks`` chunks of ``dw_chunk_len`` rows; else ``dw_chunk_len`` is 0
    and a cluster's ranks take adjacent tiles, padded to whole clusters.

    Where ``bwd_is_wide``, the wide family instead: both products in 128 x
    128 tiles (``row_tile`` = ``col_tile`` = 128), N in the chunks of
    ``_wide_chunks``, dW's tiles whole (``dw_chunk_len`` 0)."""
    if bwd_is_wide(M, N, K):
        chunks, chunk_len = _wide_chunks(M, N, K)
        tiles_k = _cdiv(K, BWD_WIDE_TILE)
        dx_blocks = _cdiv(M, BWD_WIDE_TILE) * tiles_k * chunks
        dw_tiles = _cdiv(N, BWD_WIDE_TILE) * tiles_k
        blocks = dx_blocks + _cdiv(dw_tiles, chunks) * chunks
        return dict(row_tile=BWD_WIDE_TILE, col_tile=BWD_WIDE_TILE, chunks=chunks,
                    chunk_len=chunk_len, dw_chunk_len=0, dx_blocks=dx_blocks,
                    dw_tiles=dw_tiles, grid=(blocks,), blocks=blocks)
    rt = row_tile(M)
    chunks, chunk_len = reduction_chunks(N)
    dx_blocks = _cdiv(M, rt) * _cdiv(K, BWD_TILE) * chunks
    dw_tiles = _cdiv(N, BWD_TILE) * max(1, _cdiv(K, BWD_TILE))
    if chunks > 1 and M > STAGE_DEPTH and dw_tiles < SM_COUNT:
        dw_chunk_len = _cdiv(_cdiv(M, chunks), STAGE_DEPTH) * STAGE_DEPTH
        dw_blocks = dw_tiles * chunks
    else:
        dw_chunk_len = 0
        dw_blocks = _cdiv(dw_tiles, chunks) * chunks
    blocks = dx_blocks + dw_blocks
    return dict(row_tile=rt, col_tile=BWD_TILE, chunks=chunks, chunk_len=chunk_len,
                dw_chunk_len=dw_chunk_len, dx_blocks=dx_blocks, dw_tiles=dw_tiles,
                grid=(blocks,), blocks=blocks)


def plan_ints(plan):
    """The plan as the C entry points take it, after the shapes and the
    relu flag."""
    keys = ("row_tile", "col_tile", "chunks", "chunk_len", "dw_chunk_len")
    return tuple(plan[k] for k in keys if k in plan)


# the plans' ints per shape, kept: the main path launches a few shapes
# thousands of times, and the host pays for every microsecond of a launch
@functools.lru_cache(maxsize=4096)
def _fwd_ints(M, N, K):
    return plan_ints(fwd_plan(M, N, K))


@functools.lru_cache(maxsize=4096)
def _bwd_ints(M, N, K):
    return plan_ints(bwd_plan(M, N, K))


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def capture_launches():
    """Count this thread's launches inside the block into the dict it
    yields (per entry) instead of ``LAUNCHES``; other threads' still count
    in ``LAUNCHES``."""
    counts = dict.fromkeys(KERNEL_OF, 0)
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = None


def _count(entry):
    """One launch of ``entry``: into this thread's capture tally, if one is
    open, else ``LAUNCHES``."""
    counts = getattr(_capturing, "counts", None)
    (LAUNCHES if counts is None else counts)[entry] += 1


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


def _launch(entry, t0, *args):
    """Call the C entry point of ``KERNEL_OF[entry]`` on the current stream;
    count the launch under ``entry``. ``t0``: the wrapper's entry on
    ``time.perf_counter_ns()`` while the program trace records (else 0);
    then the launch is also counted in the trace's ``cuda_ops.launches``
    (and ``cuda_ops.bwd_wide_launches`` when it is a backward launch whose
    plan is the wide family), and the host ns from ``t0`` to here in
    ``cuda_ops.launch_ns``."""
    kernel = KERNEL_OF[entry]
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = _fn(kernel)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: launch of {kernel} failed with CUDA error {err}")
    _count(entry)
    if t0:
        spans.add("cuda_ops.launches")
        # the backward's plan ints end its arguments, the row tile first
        if kernel == "linear_act_bwd" and args[-5] == BWD_WIDE_TILE:
            spans.add("cuda_ops.bwd_wide_launches")
        spans.add("cuda_ops.launch_ns", time.perf_counter_ns() - t0)


@functools.cache
def _fn(name):
    from shallowspeed_tpu_torch import _build

    return _bind(_build.load(name), name)


def _bind(lib, name):
    """The C entry point ``name`` of ``lib`` with its ctypes signature."""
    fn = getattr(lib, name)
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


def linear_act_fwd(x, w, b, apply_relu=True, _entry="linear_act_fwd"):
    """``(y, mask)`` of ``z = x @ w.T + b`` — the kernel on CUDA tensors,
    the plain version on CPU tensors. x ``(M, K)``, w ``(N, K)``, b
    ``(N,)`` or ``(1, N)``; all float32 and contiguous on one device."""
    t0 = time.perf_counter_ns() if spans.TRACE is not None else 0
    if not (x.is_cuda or w.is_cuda or b.is_cuda):
        return linear_act_fwd_reference(x, w, b, apply_relu)
    _check_cuda_operands(_entry, x.device, x=x, w=w, b=b)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"{_entry}: x and w must be 2-D, got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    M, K = x.shape
    N = w.shape[0]
    if w.shape[1] != K:
        raise ValueError(f"{_entry}: w is {tuple(w.shape)}, x has K={K}")
    if b.numel() != N:
        raise ValueError(f"{_entry}: b has {b.numel()} elements, w has N={N}")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    mask = torch.empty((M, N), dtype=torch.bool, device=x.device)
    if M == 0 or N == 0:
        return y, mask
    _launch(
        _entry, t0, x, w, b, y, mask, M, N, K, int(bool(apply_relu)),
        *_fwd_ints(M, N, K),
    )
    return y, mask


def linear_relu_fwd(x, w, b):
    """The TPU kernel's name and contract: ``(relu(z), z > 0)``."""
    return linear_act_fwd(x, w, b, apply_relu=True)


def linear_flag_fwd_reference(x, w, b2, flag):
    """Plain version of ``linear_flag_fwd`` (the CPU path and its oracle):
    ``linear_act_fwd_reference`` with ``apply_relu = flag``."""
    return linear_act_fwd_reference(x, w, b2, bool(flag))


def linear_flag_fwd(x, w, b2, flag):
    """The TPU kernel's name and contract (B5/B6, ``pallas_ops.py:215``):
    ``(y, mask)`` with ``y = relu(z) if flag else z``, ``z = x @ w.T + b2``,
    ``mask = z > 0`` (torch.bool). ``b2`` is ``(1, out)``; ``flag`` a HOST
    int or bool (the executor reads it from its host copy of the stacked
    flags, so no launch waits on the device). The ``linear_act_fwd`` kernel
    with ``apply_relu = flag`` on CUDA tensors, counted under
    ``LAUNCHES["linear_flag_fwd"]``; the plain version on CPU tensors."""
    if isinstance(flag, torch.Tensor):
        raise TypeError("linear_flag_fwd: flag must be a host int or bool, not a tensor")
    if not (x.is_cuda or w.is_cuda or b2.is_cuda):
        return linear_flag_fwd_reference(x, w, b2, flag)
    return linear_act_fwd(x, w, b2, bool(flag), _entry="linear_flag_fwd")


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


def linear_act_bwd(g, mask, x, w, apply_relu=True, _entry="linear_act_bwd"):
    """``(dx, dw, db)`` of the Linear (+ relu) that produced ``mask`` — the
    kernel on CUDA tensors, the plain version on CPU tensors. g ``(M, N)``
    float32, mask ``(M, N)`` bool (read only when ``apply_relu``; may then
    be None), x ``(M, K)``, w ``(N, K)``; contiguous on one device. Returns
    dx ``(M, K)``, dw ``(N, K)``, db ``(N,)``."""
    t0 = time.perf_counter_ns() if spans.TRACE is not None else 0
    apply_relu = bool(apply_relu)
    if apply_relu and mask is None:
        raise ValueError(f"{_entry}: apply_relu needs the forward's mask")
    operands = dict(g=g, x=x, w=w)
    if apply_relu:
        operands["mask"] = mask
    if not any(t.is_cuda for t in operands.values()):
        return linear_act_bwd_reference(g, mask, x, w, apply_relu)
    _check_cuda_operands(_entry, g.device, **operands)
    if g.dim() != 2 or x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"{_entry}: g, x and w must be 2-D, got {tuple(g.shape)}, "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    M, N = g.shape
    K = x.shape[1]
    if x.shape[0] != M or tuple(w.shape) != (N, K):
        raise ValueError(
            f"{_entry}: g {tuple(g.shape)}, x {tuple(x.shape)} and w "
            f"{tuple(w.shape)} do not fit (M, N), (M, K), (N, K)"
        )
    if apply_relu and tuple(mask.shape) != (M, N):
        raise ValueError(
            f"{_entry}: mask is {tuple(mask.shape)}, g is {(M, N)}"
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
        _entry, t0,
        g, mask if apply_relu else g, x, w, dx, dw, db, M, N, K, int(apply_relu),
        *_bwd_ints(M, N, K),
    )
    return dx, dw, db


def linear_relu_bwd(g, mask, x, w):
    """The TPU kernel's name and contract: ``(dx, dw, db)`` of ``g * mask``."""
    return linear_act_bwd(g, mask, x, w, apply_relu=True)


def linear_flag_bwd_reference(g, mask, x, w, flag):
    """Plain version of ``linear_flag_bwd`` (the CPU path and its oracle):
    ``linear_act_bwd_reference`` with ``apply_relu = flag``, db as ``(1, out)``."""
    dx, dw, db = linear_act_bwd_reference(g, mask, x, w, bool(flag))
    return dx, dw, db.reshape(1, -1)


def linear_flag_bwd(g, mask, x, w, flag):
    """The TPU kernel's name and contract (B7/B8, ``pallas_ops.py:322``):
    ``(dx, dw, db2)`` of the ``linear_flag_fwd`` that produced ``mask``, with
    ``ge = g * mask`` when ``flag`` (a multiply: NaN at a masked position
    stays NaN) and ``ge = g`` otherwise; ``db2`` is ``(1, out)``. ``flag`` is
    a HOST int or bool. The ``linear_act_bwd`` kernel with ``apply_relu =
    flag`` on CUDA tensors, counted under ``LAUNCHES["linear_flag_bwd"]``;
    the plain version on CPU tensors."""
    if isinstance(flag, torch.Tensor):
        raise TypeError("linear_flag_bwd: flag must be a host int or bool, not a tensor")
    if not any(t.is_cuda for t in (g, mask, x, w) if t is not None):
        return linear_flag_bwd_reference(g, mask, x, w, flag)
    dx, dw, db = linear_act_bwd(g, mask, x, w, bool(flag), _entry="linear_flag_bwd")
    return dx, dw, db.reshape(1, -1)


# ---------------------------------------------------------------------------
# the fused train kernel: fused_train (B9 step, B10 epoch, B11 run)
# ---------------------------------------------------------------------------

# per-optimizer operand geometry: (param-mirror state groups, scalar slots)
_OPT_GEOMETRY = {"sgd": (0, 0), "momentum": (1, 0), "adam": (2, 1)}
_OPT_CODES = {"sgd": 0, "momentum": 1, "adam": 2}

# The JAX package's single-block budget (pallas_ops.SINGLE_BLOCK_BUDGET_BYTES,
# one TPU core's VMEM less headroom). The port applies it as the JAX package
# does off the TPU, so both accept the same configurations; the kernel itself
# keeps its working set in device memory.
SINGLE_BLOCK_BUDGET_BYTES = 8 * 1024 * 1024

# csrc/fused_train.cu's partition (its constants of the same names;
# tests/test_torch_fused_plan.py holds them to the source): group-pass output
# tiles of FUSED_ROW_TILE rows x FUSED_COL_TILE columns on clusters of
# FUSED_CLUSTER blocks, a reduction staged in chunks of at most FUSED_KC
# terms cut into FUSED_WARPS warp ranges, dW tiles of FUSED_DW_N x FUSED_DW_K
FUSED_CLUSTER = 8
FUSED_ROW_TILE = 32
FUSED_COL_TILE = 16
FUSED_KC = 800
FUSED_WARPS = 8
FUSED_DW_N, FUSED_DW_K = 32, 64
# and its operand table: a header of HEADER_LEN int64 fields, then one record
# of LAYER_LEN per layer, for at most MAX_LAYERS layers; the names are the
# source's enums without their H_ / R_ prefix, in order.
FUSED_MAX_LAYERS = 24
TABLE_HEADER_LEN = 16
TABLE_HEADER = (
    "L", "OPT", "ROWS", "GROUP_ROWS", "N_GROUPS", "ROW_LOSS", "T", "HAS_CLIP",
    "HAS_DECAY",
)
TABLE_LAYER = (
    "K", "N", "RELU", "W", "B", "S1W", "S1B", "S2W", "S2B", "ACT_IN", "ACT_OUT",
    "G", "DW", "DB", "SQW", "SQB",
)
# the float hyperparameters, in the order of the source's struct Hyper
HYPER = ("lr", "decay", "mu", "b1", "b2", "omb1", "omb2", "eps", "clip", "batch_size")


def _kernel_bytes(batch_rows, sizes, state_mirrors=0):
    """The JAX package's byte model of the fused train kernel's working set
    (``pallas_ops._kernel_bytes``): params twice (in and out), an in+out
    pair per optimizer state mirror, activations and masks at
    ``batch_rows``, and the batch."""
    widths = list(sizes)
    params = sum(widths[i] * widths[i + 1] + widths[i + 1] for i in range(len(widths) - 1))
    state = 2 * params * state_mirrors
    acts = batch_rows * sum(widths)
    masks = batch_rows * sum(widths[1:-1])
    io = batch_rows * (widths[0] + widths[-1])
    return 4 * (2 * params + state + acts + masks + io)


def train_step_kernel_fits(batch_rows, sizes, state_mirrors=0):
    """True when a batch of ``batch_rows`` fits the step kernel's budget
    (``pallas_ops.train_step_kernel_fits``)."""
    return _kernel_bytes(batch_rows, sizes, state_mirrors) <= SINGLE_BLOCK_BUDGET_BYTES


def train_epoch_kernel_fits(batch_rows, sizes, state_mirrors=0):
    """True when the epoch (and run) kernel fits: the step kernel's bytes
    plus a second copy of the streamed x/y blocks, against the full budget
    (``pallas_ops.train_epoch_kernel_fits`` as it runs off the TPU, where
    it holds back no margin)."""
    widths = list(sizes)
    stream_extra = 4 * batch_rows * (widths[0] + widths[-1])
    return (
        _kernel_bytes(batch_rows, sizes, state_mirrors) + stream_extra
        <= SINGLE_BLOCK_BUDGET_BYTES
    )


def _check_geometry(opt, mirrors, scalars):
    if _OPT_GEOMETRY[opt["kind"]] != (len(mirrors), len(scalars)):
        raise ValueError(
            f"optimizer kind {opt['kind']!r} expects "
            f"{_OPT_GEOMETRY[opt['kind']]} (mirror, scalar) operand groups, "
            f"got ({len(mirrors)}, {len(scalars)})"
        )


def _batch_grads_reference(x, y, ws, bs, relu_flags, group_rows, batch_size, clip_norm):
    """``pallas_ops._batch_grads`` in torch: the forward with live
    activations and masks, the softmax-MSE head with the stability max per
    ``group_rows``-row group and ``+ 1e-7``, the backward from the given
    (pre-update) weights, the optional global-norm clip. Returns ``(dws,
    dbs, loss)``, gradient sums over the batch with ``b`` as ``(1, out)``.
    The same torch ops as the port's fused-microbatch model path
    (``model.model_forward``/``model_backward``, ``ops``, ``clip_tree``), so
    on one device the two give the same bits."""
    L = len(ws)
    a = x
    acts, masks = [], [None] * L
    for l in range(L):
        acts.append(a)
        z = torch.matmul(a, ws[l].T) + bs[l].reshape(1, -1)
        if relu_flags[l]:
            masks[l] = z > 0
            a = torch.relu(z)
        else:
            a = z
    groups = a.reshape(-1, group_rows, a.shape[-1])
    m = torch.amax(groups, dim=(1, 2), keepdim=True).expand(groups.shape).reshape(a.shape)
    ze = torch.exp(a - m)
    p = ze / (ze.sum(dim=1, keepdim=True) + 1e-7)
    loss = ((y - p) ** 2).sum() / batch_size
    gl = -2.0 * (y - p) / batch_size
    gz = p * gl
    g = gz - p * gz.sum(dim=-1, keepdim=True)
    dws, dbs = [None] * L, [None] * L
    for l in reversed(range(L)):
        ge = g * masks[l].to(g.dtype) if relu_flags[l] else g
        dws[l] = torch.matmul(ge.T, acts[l])
        dbs[l] = ge.sum(dim=0).reshape(1, -1)
        if l > 0:
            g = torch.matmul(ge, ws[l])
    if clip_norm is not None:
        clipped = clip_tree([{"W": dws[l], "b": dbs[l]} for l in range(L)], clip_norm)
        dws = [layer["W"] for layer in clipped]
        dbs = [layer["b"] for layer in clipped]
    return dws, dbs, loss


def _update_reference(kind, opt, params, grads, mirrors, t, lr, weight_decay):
    """One optimizer step in place, the port's optimizer expressions op by
    op (``optimizer.SGD``/``MomentumSGD``/``Adam``.apply)."""
    decay = _decay_factor(lr, weight_decay) if weight_decay else None
    if kind == "adam":
        t_new = t + 1.0
        c1 = 1.0 - opt["b1"] ** t_new
        c2 = 1.0 - opt["b2"] ** t_new
    for i, (p, g) in enumerate(zip(params, grads)):
        if kind == "sgd":
            step = lr * g
        elif kind == "momentum":
            v = mirrors[0][i]
            v.mul_(opt["mu"]).add_(g)
            step = lr * v
        else:
            m, v = mirrors[0][i], mirrors[1][i]
            m.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
            v.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
            step = lr * (m / c1) / (torch.sqrt(v / c2) + opt["eps"])
        if decay is not None:
            p.mul_(decay)
        p.sub_(step)
    if kind == "adam":
        t.copy_(t_new)


def _flat_group(group):
    """A stage's ``[{"W", "b"}, ...]`` as ``[W_0, b_0, W_1, b_1, ...]``."""
    return [leaf for layer in group for leaf in (layer["W"], layer["b"])]


def fused_train_reference(
    stage_params, x, y, *, epoch_mode, relu_flags, group_rows, batch_size,
    lr, weight_decay, opt=None, mirrors=(), scalars=(), clip_norm=None,
    n_epochs=None,
):
    """Plain PyTorch version of the fused train kernel: the CPU path and the
    kernel's oracle, with ``fused_train_call``'s contract (see there).
    Per batch ``_batch_grads_reference`` then the update; an epoch's loss
    is ``(0 + l_0 + ... + l_{nb-1}) / nb``, the order of the port's epoch
    loop. Params, mirrors and the scalar slot are updated in place."""
    opt = opt or {"kind": "sgd"}
    _check_geometry(opt, mirrors, scalars)
    kind = opt["kind"]
    L = len(stage_params)
    ws = [layer["W"] for layer in stage_params]
    bs = [layer["b"] for layer in stage_params]
    params = _flat_group(stage_params)
    flat_mirrors = [_flat_group(mirror) for mirror in mirrors]
    t = scalars[0] if scalars else None
    X, Y = (x, y) if epoch_mode else (x.unsqueeze(0), y.unsqueeze(0))
    losses = []
    for _ in range(1 if n_epochs is None else n_epochs):
        loss_sum = torch.zeros((), dtype=torch.float32, device=X.device)
        for xb, yb in zip(X, Y):
            dws, dbs, loss = _batch_grads_reference(
                xb, yb, ws, bs, relu_flags, group_rows, batch_size, clip_norm
            )
            grads = [g for l in range(L) for g in (dws[l], dbs[l])]
            _update_reference(kind, opt, params, grads, flat_mirrors, t, lr, weight_decay)
            loss_sum = loss_sum + loss
        losses.append(loss_sum / X.shape[0] if epoch_mode else loss)
    loss = losses[0] if n_epochs is None else torch.stack(losses)
    return stage_params, list(mirrors), list(scalars), loss


def reduction_split(length):
    """``(chunk_len, warp_len)``: how the fused train kernel cuts a group-pass
    reduction of ``length`` terms — chunks of ``chunk_len`` terms staged at
    once, each cut into ``FUSED_WARPS`` ranges of ``warp_len`` terms (whole
    float4s). Warp ``w`` sums its range of every chunk in order, and the warp
    partials are added in warp order: a function of ``length`` alone."""
    step = 4 * FUSED_WARPS
    chunk_len = min(FUSED_KC, _cdiv(length, step) * step)
    return chunk_len, chunk_len // FUSED_WARPS


def group_tiles(i0, i1, n, cluster=FUSED_CLUSTER):
    """The group pass's tiles of one phase over the rows ``[i0, i1)`` of an
    item, ``n`` output columns wide, as the kernel walks them: ``{rank:
    [(r0, c0), ...]}``, tile ``u`` (row tile ``u // column tiles``, column
    tile ``u % column tiles``) to rank ``u % cluster``."""
    ct = _cdiv(n, FUSED_COL_TILE)
    units = _cdiv(i1 - i0, FUSED_ROW_TILE) * ct
    out = {r: [] for r in range(cluster)}
    for u in range(units):
        out[u % cluster].append((i0 + (u // ct) * FUSED_ROW_TILE, (u % ct) * FUSED_COL_TILE))
    return out


def dw_tile_grid(n, k):
    """The dW tiles of an ``(n, k)`` weight: ``(tiles along N, tiles along K)``,
    at least one along K so that db is computed."""
    return _cdiv(n, FUSED_DW_N), max(1, _cdiv(k, FUSED_DW_K))


def fused_plan(widths, rows, group_rows, clip=False):
    """The fused train kernel's partition of one batch, from the shapes alone
    (never the number of batches or epochs): the group pass's items
    (``item_rows`` rows of whole head groups each, ``n_items`` of them, one
    cluster of ``cluster`` blocks an item: up to ``FUSED_ROW_TILE`` rows of
    small groups, else one group; each phase's tiles split over the blocks
    by ``group_tiles``), the weight-gradient pass's ``dw_tiles`` over every
    layer (``dw_grid``: per layer ``dw_tile_grid``), and the barriers a
    batch: ``grid_barriers`` (2, 3 with a clip) and ``cluster_barriers`` per
    item (L forward, the head, L - 2 in the dX chain)."""
    L = len(widths) - 1
    item_rows = min(rows, max(1, FUSED_ROW_TILE // group_rows) * group_rows)
    n_items = _cdiv(rows, item_rows)
    dw_grid = [dw_tile_grid(widths[l + 1], widths[l]) for l in range(L)]
    return dict(
        cluster=FUSED_CLUSTER, item_rows=item_rows, n_items=n_items,
        items=[(i * item_rows, min(rows, (i + 1) * item_rows)) for i in range(n_items)],
        dw_grid=dw_grid, dw_tiles=sum(a * b for a, b in dw_grid),
        grid_barriers=3 if clip else 2,
        cluster_barriers=L + (1 if L > 1 else 0) + max(0, L - 2),
    )


FUSED_PLAN_INTS = ("cluster", "item_rows", "n_items", "dw_tiles")


def fused_train_layout(widths, rows):
    """The kernel's workspace, in float32 elements: per layer ``l`` (``K``
    inputs, ``N`` outputs) its activation ``ACT_OUT`` (rows x N), the head
    or backward gradient ``G`` (rows x N), ``DW`` (N x K), ``DB`` (N), and
    the clip's sums of squares per dW tile ``SQW`` and per column of tiles
    ``SQB``; then each row's share of the loss. Returns ``(layers, row_loss,
    total)``: ``layers`` one dict of offsets per layer (``ACT_IN`` is -1 for
    the first, whose input is the batch)."""
    L = len(widths) - 1
    layers = [dict(K=widths[l], N=widths[l + 1]) for l in range(L)]
    off = 0
    for rec in layers:
        rec["ACT_OUT"] = off
        off += rows * rec["N"]
    for l, rec in enumerate(layers):
        K, N = rec["K"], rec["N"]
        tn, tk = dw_tile_grid(N, K)
        rec["ACT_IN"] = layers[l - 1]["ACT_OUT"] if l else -1
        for name, size in (
            ("G", rows * N), ("DW", N * K), ("DB", N), ("SQW", tn * tk), ("SQB", tn),
        ):
            rec[name] = off
            off += size
    row_loss = off
    off += rows
    return layers, row_loss, off


def _fused_train_table(stage_params, mirrors, scalars, kind, rows, group_rows,
                       relu_flags, clip_norm, weight_decay):
    """The kernel's int64 operand table, a host tensor the C entry point
    copies into the launch's parameters, the workspace size and the plan's
    ints (``FUSED_PLAN_INTS``)."""
    widths = [layer["W"].shape[1] for layer in stage_params]
    widths.append(stage_params[-1]["W"].shape[0])
    layers, row_loss, total = fused_train_layout(widths, rows)
    plan = fused_plan(widths, rows, group_rows, clip_norm is not None)
    header = dict(
        L=len(layers), OPT=_OPT_CODES[kind], ROWS=rows, GROUP_ROWS=group_rows,
        N_GROUPS=rows // group_rows, ROW_LOSS=row_loss,
        T=scalars[0].data_ptr() if scalars else 0,
        HAS_CLIP=int(clip_norm is not None), HAS_DECAY=int(bool(weight_decay)),
    )
    content = [header[k] for k in TABLE_HEADER]
    content += [0] * (TABLE_HEADER_LEN - len(content))
    for l, rec in enumerate(layers):
        rec.update(W=stage_params[l]["W"].data_ptr(), B=stage_params[l]["b"].data_ptr(),
                   RELU=int(bool(relu_flags[l])))
        for i, name in enumerate(("S1", "S2")):
            has = i < len(mirrors)
            rec[name + "W"] = mirrors[i][l]["W"].data_ptr() if has else 0
            rec[name + "B"] = mirrors[i][l]["b"].data_ptr() if has else 0
        content += [rec[k] for k in TABLE_LAYER]
    ints = tuple(plan[k] for k in FUSED_PLAN_INTS)
    return torch.tensor(content, dtype=torch.int64), total, ints


def fused_train_call(
    stage_params, x, y, *, epoch_mode, relu_flags, group_rows, batch_size,
    lr, weight_decay, opt=None, mirrors=(), scalars=(), clip_norm=None,
    n_epochs=None,
):
    """The fused train kernel (``pallas_ops.fused_train_call``'s name and
    contract): one launch trains a whole batch, epoch or run of a relu MLP.

    ``stage_params``: the stage's ``[{"W": (out, in), "b": (1, out)}, ...]``.
    ``opt``: ``{"kind": "sgd"}`` (default), ``{"kind": "momentum", "mu"}`` or
    ``{"kind": "adam", "b1", "b2", "eps"}``; ``mirrors`` one params-shaped
    group per optimizer state mirror (momentum: the velocity; Adam: m then
    v) and ``scalars`` one 0-d float32 tensor per scalar slot (Adam's step
    count t), as ``_OPT_GEOMETRY`` says. ``epoch_mode=False``: x ``(B, in)``,
    y ``(B, out)``, one batch, loss a 0-d tensor. ``epoch_mode=True``: X
    ``(nb, B, in)``, Y ``(nb, B, out)``, the whole epoch, loss the mean of
    the batch losses; with ``n_epochs`` also the whole run, loss the
    ``(n_epochs,)`` per-epoch means. ``relu_flags``: per layer, relu on its
    output; ``group_rows``: rows per stability-max group of the head;
    ``batch_size``: the global batch that scales the loss; ``lr``,
    ``weight_decay`` (decoupled), ``clip_norm`` (global norm, None = off).

    Returns ``(new_stage_params, new_mirrors, new_scalars, loss)``. The
    params, mirrors and scalar slot are UPDATED IN PLACE (as the port's
    optimizers update), so the returned trees are the tensors passed in.
    CUDA tensors launch the kernel (or raise: a stage of more than
    ``FUSED_MAX_LAYERS`` layers is refused before any launch); CPU tensors
    run ``fused_train_reference``."""
    t0 = time.perf_counter_ns() if spans.TRACE is not None else 0
    opt = opt or {"kind": "sgd"}
    _check_geometry(opt, mirrors, scalars)
    if n_epochs is not None and not epoch_mode:
        raise ValueError("n_epochs requires epoch_mode=True")
    if n_epochs is not None and n_epochs < 1:
        raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
    if weight_decay:
        _decay_factor(lr, weight_decay)  # validates
    kw = dict(
        epoch_mode=epoch_mode, relu_flags=relu_flags, group_rows=group_rows,
        batch_size=batch_size, lr=lr, weight_decay=weight_decay, opt=opt,
        mirrors=mirrors, scalars=scalars, clip_norm=clip_norm, n_epochs=n_epochs,
    )
    leaves = _flat_group(stage_params) + [
        leaf for mirror in mirrors for leaf in _flat_group(mirror)
    ]
    if not any(t.is_cuda for t in [x, y, *leaves, *scalars]):
        return fused_train_reference(stage_params, x, y, **kw)

    dev = x.device
    X, Y = (x, y) if epoch_mode else (x.unsqueeze(0), y.unsqueeze(0))
    _check_cuda_operands("fused_train", dev, x=X, y=Y)
    for i, leaf in enumerate(leaves):
        _check_cuda_operands("fused_train", dev, **{f"param/state leaf {i}": leaf})
    for t in scalars:
        _check_cuda_operands("fused_train", dev, t=t)
        if t.dim() != 0:
            raise ValueError(f"fused_train: a scalar slot must be 0-d, got {tuple(t.shape)}")
    if X.dim() != 3 or Y.dim() != 3:
        raise ValueError(
            f"fused_train: x and y must be (B, dim) per batch, got {tuple(x.shape)} "
            f"and {tuple(y.shape)}"
        )
    nb, rows, din = X.shape
    L = len(stage_params)
    if L > FUSED_MAX_LAYERS:
        raise ValueError(
            f"fused_train: {L} layers; the kernel's operand table holds at most "
            f"{FUSED_MAX_LAYERS}"
        )
    if len(relu_flags) != L:
        raise ValueError(f"fused_train: {len(relu_flags)} relu flags for {L} layers")
    prev = din
    for l, layer in enumerate(stage_params):
        n_out, n_in = layer["W"].shape
        if n_in != prev or layer["b"].numel() != n_out:
            raise ValueError(
                f"fused_train: layer {l} has W {tuple(layer['W'].shape)} and b "
                f"{tuple(layer['b'].shape)} after width {prev}"
            )
        prev = n_out
    for i, mirror in enumerate(mirrors):
        for l, (a, b) in enumerate(zip(_flat_group(mirror), _flat_group(stage_params))):
            if a.shape != b.shape:
                raise ValueError(f"fused_train: mirror {i} leaf {l} is not shaped as its param")
    if tuple(Y.shape) != (nb, rows, prev):
        raise ValueError(f"fused_train: y is {tuple(y.shape)}, want {(nb, rows, prev)} per batch")
    if nb == 0 or rows == 0 or group_rows < 1 or rows % group_rows:
        raise ValueError(
            f"fused_train: needs at least one batch of rows divisible by group_rows, "
            f"got {nb} batches of {rows} rows, group_rows={group_rows}"
        )
    table, ws_floats, plan_ints = _fused_train_table(
        stage_params, mirrors, scalars, opt["kind"], rows, group_rows, relu_flags,
        clip_norm, weight_decay,
    )
    hp = dict(
        lr=lr, decay=_decay_factor(lr, weight_decay) if weight_decay else 1.0,
        mu=opt.get("mu", 0.0), b1=opt.get("b1", 0.0), b2=opt.get("b2", 0.0),
        omb1=1 - opt.get("b1", 0.0), omb2=1 - opt.get("b2", 0.0),
        eps=opt.get("eps", 0.0), clip=0.0 if clip_norm is None else clip_norm,
        batch_size=batch_size,
    )
    # HOST arrays, like the table: the C entry point copies them into the
    # launch's parameters
    hyper = torch.tensor([hp[k] for k in HYPER], dtype=torch.float32)
    epochs = 1 if n_epochs is None else n_epochs
    loss = torch.empty((epochs,), dtype=torch.float32, device=dev)
    ws = torch.empty((ws_floats,), dtype=torch.float32, device=dev)
    _launch("fused_train", t0, X, Y, loss, ws, table, hyper, nb, epochs, *plan_ints)
    return stage_params, list(mirrors), list(scalars), loss if n_epochs else loss[0]
