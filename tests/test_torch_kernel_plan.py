"""The launch plans of the port's two linear kernels (shallowspeed_tpu_torch/
cuda_ops.py: ``reduction_chunks``, ``row_tile``, ``fwd_plan``, ``bwd_plan``).

The wrapper computes the plan and passes it to the C entry point as ints;
the CUDA sources only check it. So the rules the kernels rely on are held
here, on the CPU: a reduction's chunks cover it exactly, the forward's
chunking is a function of K alone (its row-independence rule), clusters
stay within the portable size, few rows still give the card many blocks,
and the plan's constants and argument order match the sources.
"""

import re

import pytest

from shallowspeed_tpu_torch import _build, cuda_ops

LENGTHS = [0, 1, 10, 16, 23, 29, 31, 32, 33, 123, 124, 127, 128, 129, 784, 2048, 4096, 100003]
ROWS = [1, 4, 8, 9, 16, 17, 32, 33, 37, 64, 65, 128, 1000]
FLAGSHIP_KN = [(784, 128), (128, 127), (127, 126), (126, 125), (125, 124), (124, 123), (123, 10)]
SHAPES = FLAGSHIP_KN + [(784, 2048), (2048, 2048), (2048, 10), (29, 23)]


def _chunks_of(length, chunks, chunk_len):
    """The [lo, hi) ranges of the chunks, as the kernels walk them."""
    return [(r * chunk_len, min(length, (r + 1) * chunk_len)) for r in range(chunks)]


@pytest.mark.parametrize("length", LENGTHS)
def test_reduction_chunks_partition_the_reduction(length):
    """Consecutive, non-empty chunks covering every term exactly once, edges
    on stage edges, at most one per rank of a portable cluster."""
    chunks, chunk_len = cuda_ops.reduction_chunks(length)
    assert 1 <= chunks <= cuda_ops.MAX_CLUSTER
    assert chunk_len % cuda_ops.STAGE_DEPTH == 0
    if length == 0:
        assert (chunks, chunk_len) == (1, 0)
        return
    ranges = _chunks_of(length, chunks, chunk_len)
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(length))  # no gap, no overlap, in order
    assert all(hi > lo for lo, hi in ranges)
    # short chains: CHUNK_TERMS terms, or an 8-way split rounded up a stage
    assert chunks <= min(cuda_ops.MAX_CLUSTER, -(-length // cuda_ops.CHUNK_TERMS))
    assert chunk_len < max(
        cuda_ops.CHUNK_TERMS, -(-length // cuda_ops.MAX_CLUSTER)
    ) + cuda_ops.STAGE_DEPTH


@pytest.mark.parametrize("k,n", SHAPES)
def test_forward_chunking_depends_on_k_alone(k, n):
    """The forward's order rule: every M (every row tile) gets the same
    chunks of K, so a row's bits do not depend on the other rows."""
    plans = [cuda_ops.fwd_plan(m, n, k) for m in ROWS]
    assert {(p["chunks"], p["chunk_len"]) for p in plans} == {cuda_ops.reduction_chunks(k)}
    assert {p["row_tile"] for p in plans} == set(cuda_ops.ROW_TILES)
    for m, p in zip(ROWS, plans):
        assert p["chunks"] <= cuda_ops.MAX_CLUSTER
        assert p["col_tile"] == cuda_ops.FWD_COL_TILE[p["row_tile"]]
        assert p["grid"] == (-(-n // p["col_tile"]) * p["chunks"], -(-m // p["row_tile"]))
        assert p["grid"][0] % p["chunks"] == 0  # whole clusters
        assert p["grid"][1] <= 65535


@pytest.mark.parametrize(
    "rows,want",
    [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32), (37, 32), (64, 32), (65, 64),
     (128, 64), (1000, 64)],
)
def test_row_tile_is_sized_to_m(rows, want):
    """8 or 16 rows for a serving or executor slot, 32 for a microbatch (up
    to 64 rows), 64 for fused microbatches and the eval chunk."""
    assert cuda_ops.row_tile(rows) == want
    assert cuda_ops.fwd_plan(rows, 128, 784)["row_tile"] == want
    assert cuda_ops.bwd_plan(rows, 128, 784)["row_tile"] == want


def test_few_rows_fill_the_card():
    """The shapes that lost to a library call: 8 rows of 2048 -> 2048 get
    at least 64 blocks, 8 rows of 784 -> 128 at least 13; the backward's dx
    at 32 x 784 -> 2048 splits N over a full cluster."""
    assert cuda_ops.fwd_plan(8, 2048, 2048)["blocks"] >= 64
    assert cuda_ops.fwd_plan(8, 128, 784)["blocks"] >= 13
    bwd = cuda_ops.bwd_plan(32, 2048, 784)
    assert bwd["chunks"] == cuda_ops.MAX_CLUSTER and bwd["dx_blocks"] >= 100


@pytest.mark.parametrize("m", [1, 8, 16, 32, 37, 128])
@pytest.mark.parametrize("k,n", SHAPES)
def test_backward_plan_covers_dx_and_dw(m, k, n):
    """dx's chunks of N partition N; dW's tiles cover N x K (at least one
    K-tile, for db) and, when M is split over a cluster, its chunks cover M;
    the grid is whole clusters of at most 8 blocks. The wide family (128 x
    128 tiles, at M >= 128 and N, K >= 512 with N * K >= 768 * 512) chooses
    its own chunks of N."""
    p = cuda_ops.bwd_plan(m, n, k)
    chunks = p["chunks"]
    if cuda_ops.bwd_is_wide(m, n, k):
        tile = cuda_ops.BWD_WIDE_TILE
        assert p["row_tile"] == tile and p["dw_chunk_len"] == 0
        terms = [t for lo, hi in _chunks_of(n, chunks, p["chunk_len"]) for t in range(lo, hi)]
        assert terms == list(range(n)) and p["chunk_len"] % cuda_ops.STAGE_DEPTH == 0
    else:
        tile = cuda_ops.BWD_TILE
        assert (chunks, p["chunk_len"]) == cuda_ops.reduction_chunks(n)
    assert chunks <= cuda_ops.MAX_CLUSTER
    assert p["col_tile"] == tile
    assert p["dx_blocks"] == -(-m // p["row_tile"]) * -(-k // tile) * chunks
    assert p["dw_tiles"] == -(-n // tile) * max(1, -(-k // tile))
    dw_len = p["dw_chunk_len"]
    if dw_len:
        assert chunks > 1 and p["dw_tiles"] < cuda_ops.SM_COUNT
        assert dw_len % cuda_ops.STAGE_DEPTH == 0 and chunks * dw_len >= m
        rows = [r for lo, hi in _chunks_of(m, chunks, dw_len) for r in range(lo, hi)]
        assert rows == list(range(m))
        dw_blocks = p["dw_tiles"] * chunks
    else:
        dw_blocks = -(-p["dw_tiles"] // chunks) * chunks
    assert p["blocks"] == p["grid"][0] == p["dx_blocks"] + dw_blocks
    assert p["blocks"] % chunks == 0


def test_backward_splits_m_only_where_dw_tiles_are_few():
    """The flagship's layers at 128 rows split M (4 dW tiles would walk all
    of M alone); mlp-deep's 1024 tiles and a single stage of rows do not."""
    assert cuda_ops.bwd_plan(128, 126, 127)["dw_chunk_len"] == 32
    assert cuda_ops.bwd_plan(128, 2048, 2048)["dw_chunk_len"] == 0
    assert cuda_ops.bwd_plan(16, 128, 784)["dw_chunk_len"] == 0


def _source(name):
    return (_build.CSRC / name).read_text()


def test_plan_constants_match_the_sources():
    """The stage depth, cluster limit, tiles and the tile pairs each entry
    point dispatches are the ones the plans use."""
    staging = _source("staging.cuh")
    assert int(re.search(r"constexpr int BK = (\d+);", staging).group(1)) == cuda_ops.STAGE_DEPTH
    assert int(re.search(r"constexpr int MAX_CLUSTER = (\d+);", staging).group(1)) == cuda_ops.MAX_CLUSTER
    assert int(re.search(r"constexpr int PANEL = (\d+);", staging).group(1)) == cuda_ops.BWD_TILE
    fwd_pairs = re.findall(r"row_tile == (\d+) && col_tile == (\d+)", _source("linear_act_fwd.cu"))
    assert {int(r): int(c) for r, c in fwd_pairs} == cuda_ops.FWD_COL_TILE
    bwd_rows = re.findall(r"if \(row_tile == (\d+)\)", _source("linear_act_bwd.cu"))
    assert tuple(int(r) for r in bwd_rows) == cuda_ops.ROW_TILES


@pytest.mark.parametrize(
    "kernel,plan", [("linear_act_fwd", cuda_ops.fwd_plan), ("linear_act_bwd", cuda_ops.bwd_plan)]
)
def test_plan_ints_follow_the_c_signature(kernel, plan):
    """The wrapper passes the plan's ints in the order the C entry point
    names them, right after apply_relu."""
    params = re.search(rf'extern "C" int {kernel}\(([^)]*)\)', _source(f"{kernel}.cu")).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    after = names[names.index("apply_relu") + 1 : -1]
    p = plan(8, 127, 784)
    assert after == [k for k in ("row_tile", "col_tile", "chunks", "chunk_len", "dw_chunk_len") if k in p]
    assert cuda_ops.plan_ints(p) == tuple(p[k] for k in after)
