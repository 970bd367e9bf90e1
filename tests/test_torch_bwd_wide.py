"""The backward kernel's wide family on the CPU (shallowspeed_tpu_torch/
cuda_ops.py: ``bwd_is_wide``, ``_wide_chunks``, ``bwd_plan``; the 128 x 128
tiles of csrc/linear_act_bwd.cu).

The kernel runs only on a card, so what can be held here is held here: where
the family engages, that its dx and dW blocks cover the outputs and the
reductions, that every narrower shape keeps the plan it had before the family
existed (written out below), that the plan's constants and dispatch match the
source, and that the program trace counts the family's launches.
"""

import contextlib
import re

import pytest
import torch

from shallowspeed_tpu_torch import _build, cuda_ops
from shallowspeed_tpu_torch.observability import spans

WIDE = cuda_ops.BWD_WIDE_TILE

# (M, N, K): mlp-deep's two Linear shapes at 256-row and 128-row
# microbatches, a ragged shape, mlp-wide's first Linear (784 -> 512) and
# the narrowest shapes the family won at on the card
WIDE_SHAPES = [(256, 2048, 2048), (256, 2048, 784), (128, 2048, 2048), (128, 2048, 784),
               (200, 2000, 784), (128, 512, 784), (256, 512, 768), (128, 640, 640)]

# the plans of the shapes below the family, as bwd_plan gave them before it:
# the flagship at 8-128 rows (the 784 -> 128 ... 123 -> 10 Linears), mlp-deep
# at 8-32 rows (B2/B4/B6/B8) and its 2048 -> 10 head, executor slots padded
# to 784 -> 128 (B7), a ragged shape; (M, N, K) -> plan
NARROW_PLANS = {
    (8, 128, 784): dict(row_tile=8, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=52, dw_tiles=26, grid=(80,), blocks=80),
    (8, 127, 128): dict(row_tile=8, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (8, 126, 127): dict(row_tile=8, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (8, 125, 126): dict(row_tile=8, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (8, 124, 125): dict(row_tile=8, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (8, 123, 124): dict(row_tile=8, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (8, 10, 123): dict(row_tile=8, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=2, dw_tiles=2, grid=(4,), blocks=4),
    (16, 128, 784): dict(row_tile=16, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=52, dw_tiles=26, grid=(80,), blocks=80),
    (16, 127, 128): dict(row_tile=16, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (16, 126, 127): dict(row_tile=16, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (16, 125, 126): dict(row_tile=16, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (16, 124, 125): dict(row_tile=16, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (16, 123, 124): dict(row_tile=16, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=0, dx_blocks=8, dw_tiles=4, grid=(12,), blocks=12),
    (16, 10, 123): dict(row_tile=16, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=2, dw_tiles=2, grid=(4,), blocks=4),
    (32, 128, 784): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=52, dw_tiles=26, grid=(156,), blocks=156),
    (32, 127, 128): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=8, dw_tiles=4, grid=(24,), blocks=24),
    (32, 126, 127): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=8, dw_tiles=4, grid=(24,), blocks=24),
    (32, 125, 126): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=8, dw_tiles=4, grid=(24,), blocks=24),
    (32, 124, 125): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=8, dw_tiles=4, grid=(24,), blocks=24),
    (32, 123, 124): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=8, dw_tiles=4, grid=(24,), blocks=24),
    (32, 10, 123): dict(row_tile=32, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=2, dw_tiles=2, grid=(4,), blocks=4),
    (64, 128, 784): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=104, dw_tiles=26, grid=(208,), blocks=208),
    (64, 127, 128): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (64, 126, 127): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (64, 125, 126): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (64, 124, 125): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (64, 123, 124): dict(row_tile=32, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=16, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (64, 10, 123): dict(row_tile=32, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=4, dw_tiles=2, grid=(6,), blocks=6),
    (128, 128, 784): dict(row_tile=64, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=32, dx_blocks=104, dw_tiles=26, grid=(208,), blocks=208),
    (128, 127, 128): dict(row_tile=64, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=32, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (128, 126, 127): dict(row_tile=64, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=32, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (128, 125, 126): dict(row_tile=64, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=32, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (128, 124, 125): dict(row_tile=64, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=32, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (128, 123, 124): dict(row_tile=64, col_tile=64, chunks=4, chunk_len=32, dw_chunk_len=32, dx_blocks=16, dw_tiles=4, grid=(32,), blocks=32),
    (128, 10, 123): dict(row_tile=64, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=4, dw_tiles=2, grid=(6,), blocks=6),
    (8, 2048, 784): dict(row_tile=8, col_tile=64, chunks=8, chunk_len=256, dw_chunk_len=0, dx_blocks=104, dw_tiles=416, grid=(520,), blocks=520),
    (8, 2048, 2048): dict(row_tile=8, col_tile=64, chunks=8, chunk_len=256, dw_chunk_len=0, dx_blocks=256, dw_tiles=1024, grid=(1280,), blocks=1280),
    (8, 10, 2048): dict(row_tile=8, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=32, dw_tiles=32, grid=(64,), blocks=64),
    (16, 2048, 784): dict(row_tile=16, col_tile=64, chunks=8, chunk_len=256, dw_chunk_len=0, dx_blocks=104, dw_tiles=416, grid=(520,), blocks=520),
    (16, 2048, 2048): dict(row_tile=16, col_tile=64, chunks=8, chunk_len=256, dw_chunk_len=0, dx_blocks=256, dw_tiles=1024, grid=(1280,), blocks=1280),
    (16, 10, 2048): dict(row_tile=16, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=32, dw_tiles=32, grid=(64,), blocks=64),
    (32, 2048, 784): dict(row_tile=32, col_tile=64, chunks=8, chunk_len=256, dw_chunk_len=0, dx_blocks=104, dw_tiles=416, grid=(520,), blocks=520),
    (32, 2048, 2048): dict(row_tile=32, col_tile=64, chunks=8, chunk_len=256, dw_chunk_len=0, dx_blocks=256, dw_tiles=1024, grid=(1280,), blocks=1280),
    (32, 10, 2048): dict(row_tile=32, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=32, dw_tiles=32, grid=(64,), blocks=64),
    (128, 10, 2048): dict(row_tile=64, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=64, dw_tiles=32, grid=(96,), blocks=96),
    (256, 10, 2048): dict(row_tile=64, col_tile=64, chunks=1, chunk_len=16, dw_chunk_len=0, dx_blocks=128, dw_tiles=32, grid=(160,), blocks=160),
    (37, 23, 29): dict(row_tile=32, col_tile=64, chunks=1, chunk_len=32, dw_chunk_len=0, dx_blocks=2, dw_tiles=1, grid=(3,), blocks=3),
    # mlp-wide's 512 -> 512 Linears, and the widths at which the wide family
    # lost to these plans on the card
    (128, 512, 512): dict(row_tile=64, col_tile=64, chunks=8, chunk_len=64, dw_chunk_len=16, dx_blocks=128, dw_tiles=64, grid=(640,), blocks=640),
    (256, 512, 512): dict(row_tile=64, col_tile=64, chunks=8, chunk_len=64, dw_chunk_len=32, dx_blocks=256, dw_tiles=64, grid=(768,), blocks=768),
    (256, 512, 704): dict(row_tile=64, col_tile=64, chunks=8, chunk_len=64, dw_chunk_len=32, dx_blocks=352, dw_tiles=88, grid=(1056,), blocks=1056),
    (128, 512, 640): dict(row_tile=64, col_tile=64, chunks=8, chunk_len=64, dw_chunk_len=16, dx_blocks=160, dw_tiles=80, grid=(800,), blocks=800),
}


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("m,n,k", WIDE_SHAPES)
def test_wide_family_engages_and_covers(m, n, k):
    """128 x 128 tiles; dx's chunks of N cover N on stage edges (the
    source's chunks_cover), and its blocks, decoded as the kernel decodes
    blockIdx, give every (row tile, column tile) each chunk once; dW's
    tiles cover N x K once, each over all of M; whole clusters."""
    p = cuda_ops.bwd_plan(m, n, k)
    assert cuda_ops.bwd_is_wide(m, n, k)
    assert (p["row_tile"], p["col_tile"], p["dw_chunk_len"]) == (WIDE, WIDE, 0)
    chunks, chunk_len = p["chunks"], p["chunk_len"]
    assert 1 <= chunks <= cuda_ops.MAX_CLUSTER and chunk_len % cuda_ops.STAGE_DEPTH == 0
    assert (chunks - 1) * chunk_len < n <= chunks * chunk_len
    tiles_m, tiles_n, tiles_k = _cdiv(m, WIDE), _cdiv(n, WIDE), _cdiv(k, WIDE)
    assert p["dx_blocks"] == tiles_m * tiles_k * chunks
    dx = sorted(
        ((b // chunks) // tiles_k * WIDE, (b // chunks) % tiles_k * WIDE, b % chunks)
        for b in range(p["dx_blocks"])
    )
    assert dx == [(m0, k0, r) for m0 in range(0, m, WIDE) for k0 in range(0, k, WIDE)
                  for r in range(chunks)]
    assert p["dw_tiles"] == tiles_n * tiles_k
    dw = sorted((t // tiles_k * WIDE, t % tiles_k * WIDE) for t in range(p["dw_tiles"]))
    assert dw == [(n0, k0) for n0 in range(0, n, WIDE) for k0 in range(0, k, WIDE)]
    assert p["blocks"] == p["grid"][0] == p["dx_blocks"] + _cdiv(p["dw_tiles"], chunks) * chunks
    assert p["blocks"] % chunks == 0


@pytest.mark.parametrize(
    "m,n,k,chunks,chunk_len,span",
    [(256, 2048, 2048, 2, 1024, 64), (256, 2048, 784, 4, 512, 32), (128, 2048, 2048, 4, 512, 32)],
)
def test_wide_chunks_balance_the_card(m, n, k, chunks, chunk_len, span):
    """One block an SM, 132 slots. At mlp-deep's 256 rows, 64 dx blocks of
    64 stages (N in 2 chunks) and 256 dW blocks of 16 end together after 64
    stages, as 4 or 8 chunks would, so the fewest; its first Linear (K =
    784) and 128-row microbatches have fewer tiles, and 4 chunks end at 32
    stages as 8 would."""
    p = cuda_ops.bwd_plan(m, n, k)
    assert (p["chunks"], p["chunk_len"]) == (chunks, chunk_len)
    slots = cuda_ops.WIDE_BLOCKS_PER_SM * cuda_ops.SM_COUNT
    stages = [chunk_len // 16] * p["dx_blocks"] + [_cdiv(m, 16)] * p["dw_tiles"]
    assert slots == 132 and cuda_ops._makespan(stages, slots) == span


@pytest.mark.parametrize(
    "m,n,k",
    [(127, 2048, 2048), (128, 511, 2048), (128, 2048, 511), (256, 10, 2048), (32, 2048, 784),
     (128, 512, 512), (256, 512, 704), (256, 704, 512), (4096, 640, 512)],
)
def test_wide_family_needs_rows_and_widths(m, n, k):
    """Below 128 rows, 512 columns of either product or 768 x 512 weights,
    the 64-wide plans."""
    assert not cuda_ops.bwd_is_wide(m, n, k)
    assert cuda_ops.bwd_plan(m, n, k)["col_tile"] == cuda_ops.BWD_TILE


@pytest.mark.parametrize("shape", list(NARROW_PLANS), ids=lambda s: "x".join(map(str, s)))
def test_narrow_shapes_keep_their_plans(shape):
    """Every shape below the family keeps its plan, and so its bits."""
    assert cuda_ops.bwd_plan(*shape) == NARROW_PLANS[shape]


def _source():
    return (_build.CSRC / "linear_act_bwd.cu").read_text()


def test_wide_constants_match_the_source():
    """The tile edge and blocks an SM the plan assumes are the source's; the
    entry point dispatches the family on the plan's tiles; every kernel's
    name holds the string the benchmark's roofline reads."""
    src = _source()
    assert int(re.search(r"constexpr int WIDE = (\d+);", src).group(1)) == WIDE
    per_sm = re.search(r"constexpr int WIDE_BLOCKS_PER_SM = (\d+);", src).group(1)
    assert int(per_sm) == cuda_ops.WIDE_BLOCKS_PER_SM
    assert re.search(r"__launch_bounds__\(WIDE_THREADS, WIDE_BLOCKS_PER_SM\)\s*linear_act_bwd_kernel_wide\(", src)
    assert "if (row_tile == WIDE && col_tile == WIDE)" in src
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", src)
    assert names == ["linear_act_bwd_kernel", "linear_act_bwd_kernel_wide"]
    assert "launch_wide<true> : launch_wide<false>" in src  # 16-byte copies where they fit


def test_wide_plan_ints_follow_the_c_signature():
    """The wide plan goes to the same C entry point, in the same order."""
    params = re.search(r'extern "C" int linear_act_bwd\(([^)]*)\)', _source()).group(1)
    names = [q.split()[-1].lstrip("*") for q in params.split(",")]
    after = names[names.index("apply_relu") + 1 : -1]
    p = cuda_ops.bwd_plan(256, 2048, 2048)
    assert cuda_ops.plan_ints(p) == tuple(p[key] for key in after) == (WIDE, WIDE, 2, 1024, 0)
    assert cuda_ops._bwd_ints(256, 2048, 2048) == cuda_ops.plan_ints(p)
    assert cuda_ops.SIGNATURES["linear_act_bwd"][1] == 4 + len(after)  # M, N, K, apply_relu


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one, so that they plan
    and launch (into a stand-in C entry point)."""

    @property
    def is_cuda(self):
        return True


def _operands(m, n, k):
    return [torch.zeros(*s).as_subclass(_OnCard) for s in ((m, n), (m, n), (m, k), (n, k))]


def test_trace_counts_the_wide_launches(monkeypatch):
    """Under ``recording()`` a launch of the wide family adds one to
    ``cuda_ops.bwd_wide_launches`` beside ``cuda_ops.launches``, through
    both backward entries; narrower shapes and the forward add nothing to
    it, ``LAUNCHES`` counts one a wrapper call, and with the trace off no
    counter moves."""
    calls = []
    monkeypatch.setattr(cuda_ops, "_fn", lambda kernel: lambda *a: calls.append((kernel, a)) or 0)
    monkeypatch.setattr(cuda_ops, "_check_cuda_operands", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0})()
    )
    monkeypatch.setattr(cuda_ops, "LAUNCHES", dict.fromkeys(cuda_ops.KERNEL_OF, 0))

    def step():
        cuda_ops.linear_act_bwd(*_operands(256, 2048, 2048), True)  # wide
        cuda_ops.linear_act_bwd(*_operands(256, 2048, 784), False)  # wide
        cuda_ops.linear_act_bwd(*_operands(256, 10, 2048), False)  # the head
        cuda_ops.linear_flag_bwd(*_operands(128, 2048, 2048), 0)  # wide
        cuda_ops.linear_flag_bwd(*_operands(32, 2048, 2048), 1)
        x, _, _, w = _operands(256, 2048, 2048)
        cuda_ops.linear_act_fwd(x, w, torch.zeros(2048).as_subclass(_OnCard))

    step()  # off
    with spans.recording() as tr:
        step()
        step()
    assert tr.counters["cuda_ops.bwd_wide_launches"] == 2 * 3
    assert tr.counters["cuda_ops.launches"] == 2 * 6
    assert cuda_ops.LAUNCHES == dict(
        linear_act_fwd=3, linear_act_bwd=9, fused_train=0, linear_flag_fwd=0, linear_flag_bwd=6
    )
    wide = [a for kernel, a in calls if kernel == "linear_act_bwd" and a[11] == WIDE]
    assert len(wide) == 3 * 3 and len(calls) == 3 * 6
