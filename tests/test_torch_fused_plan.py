"""The partition of the port's fused train kernel (shallowspeed_tpu_torch/
cuda_ops.py: ``fused_plan``, ``group_tiles``, ``dw_tile_grid``,
``reduction_split``; csrc/fused_train.cu).

The wrapper computes the plan from the shapes and passes its ints to the C
entry point, which checks them against the operand table; the kernel walks
the same tiles. So the rules the kernel relies on are held here, on the
CPU: every head group belongs to exactly one cluster's item, the blocks of a
cluster split every phase's output without gap or overlap, the dW tiles
cover every parameter once, a reduction's chunks and warp ranges cover it
once and in order, the plan depends on the shapes alone, a batch crosses 2
grid-wide barriers (3 with a clip), and the plan's constants and argument
order match the source.
"""

import inspect
import re

import pytest
import torch

from shallowspeed_tpu_torch import _build, cuda_ops

FLAGSHIP = (784, 128, 127, 126, 125, 124, 123, 10)
MODELS = [FLAGSHIP, (29, 23, 17, 10), (20, 16, 12, 10), (5, 3), (784, 16, 16, 16, 16, 16, 16, 10),
          (1000, 256, 10), (784, 2048, 10)]
# (rows, group_rows): the flagship's 4 groups of 32, one group of all rows,
# groups smaller than a row tile, groups larger than one, ragged counts
BATCHES = [(128, 32), (128, 128), (24, 8), (32, 8), (7, 7), (128, 1), (96, 48), (100, 20),
           (512, 512), (40, 40)]
LENGTHS = [1, 3, 4, 10, 16, 31, 32, 33, 123, 127, 128, 784, 800, 801, 1000, 2048, 4097]


def _src():
    return (_build.CSRC / "fused_train.cu").read_text()


@pytest.mark.parametrize("rows,group", BATCHES)
def test_every_head_group_is_owned_by_one_cluster(rows, group):
    """The items are consecutive whole groups that cover the batch once: up
    to a row tile of small groups, else one group an item."""
    plan = cuda_ops.fused_plan(FLAGSHIP, rows, group)
    items = plan["items"]
    assert len(items) == plan["n_items"]
    assert items[0][0] == 0 and items[-1][1] == rows
    owner = {}
    for i, (i0, i1) in enumerate(items):
        assert i0 % group == 0 and (i1 - i0) % group == 0 and i1 > i0
        assert i1 - i0 <= max(group, cuda_ops.FUSED_ROW_TILE)
        for g in range(i0 // group, i1 // group):
            assert g not in owner
            owner[g] = i
    assert sorted(owner) == list(range(rows // group))
    assert plan["item_rows"] % group == 0
    assert all(i1 - i0 == plan["item_rows"] for i0, i1 in items[:-1])


@pytest.mark.parametrize("rows,group", BATCHES)
@pytest.mark.parametrize("sizes", MODELS[:4])
def test_cluster_tiles_partition_every_phase(sizes, rows, group):
    """For every item and every width a group-pass phase writes (each
    layer's N in the forward, each K but the input's in the dX chain), the
    ranks' tiles cover the item's rows x columns exactly once, every tile
    on a rank of the cluster."""
    plan = cuda_ops.fused_plan(sizes, rows, group)
    for i0, i1 in plan["items"]:
        for n in set(sizes[1:]):
            tiles = cuda_ops.group_tiles(i0, i1, n, plan["cluster"])
            assert set(tiles) == set(range(plan["cluster"]))
            seen = set()
            for mine in tiles.values():
                for r0, c0 in mine:
                    assert (r0 - i0) % cuda_ops.FUSED_ROW_TILE == 0
                    for r in range(r0, min(i1, r0 + cuda_ops.FUSED_ROW_TILE)):
                        for c in range(c0, min(n, c0 + cuda_ops.FUSED_COL_TILE)):
                            assert (r, c) not in seen
                            seen.add((r, c))
            assert seen == {(r, c) for r in range(i0, i1) for c in range(n)}


@pytest.mark.parametrize("sizes", MODELS)
def test_dw_tiles_cover_every_parameter_once(sizes):
    """The weight-gradient pass's tiles, walked as the kernel walks them
    (global tile index -> layer, tile along N, tile along K; each thread 2 x
    4 elements), hold every element of every dW once, and the tiles with
    K-tile 0 every element of every db once."""
    plan = cuda_ops.fused_plan(sizes, 128, 32)
    dn, dk = cuda_ops.FUSED_DW_N, cuda_ops.FUSED_DW_K
    seen_w = [dict() for _ in range(len(sizes) - 1)]
    seen_b = [set() for _ in range(len(sizes) - 1)]
    for tile in range(plan["dw_tiles"]):
        layer, rest = 0, tile
        while rest >= plan["dw_grid"][layer][0] * plan["dw_grid"][layer][1]:
            rest -= plan["dw_grid"][layer][0] * plan["dw_grid"][layer][1]
            layer += 1
        K, N = sizes[layer], sizes[layer + 1]
        nt, kt = divmod(rest, plan["dw_grid"][layer][1])
        for tid in range(32 * cuda_ops.FUSED_WARPS):
            tn, tk = divmod(tid, 16)
            for i in range(2):
                for j in range(4):
                    n, k = nt * dn + 2 * tn + i, kt * dk + 4 * tk + j
                    if n < N and k < K:
                        seen_w[layer][n, k] = seen_w[layer].get((n, k), 0) + 1
            if kt == 0 and tid < dn and nt * dn + tid < N:
                assert nt * dn + tid not in seen_b[layer]
                seen_b[layer].add(nt * dn + tid)
    for layer in range(len(sizes) - 1):
        K, N = sizes[layer], sizes[layer + 1]
        assert len(seen_w[layer]) == N * K and set(seen_w[layer].values()) == {1}
        assert seen_b[layer] == set(range(N))
    assert plan["dw_grid"] == [cuda_ops.dw_tile_grid(n, k) for k, n in zip(sizes, sizes[1:])]


@pytest.mark.parametrize("length", LENGTHS)
def test_reduction_split_covers_each_term_once_in_order(length):
    """A reduction's chunks and their warp ranges cover every term once;
    each warp's terms run in order; ranges are whole float4s, chunks fit the
    staging tile, and the warps that get a term are the leading ones."""
    chunk_len, warp_len = cuda_ops.reduction_split(length)
    warps = cuda_ops.FUSED_WARPS
    assert chunk_len <= cuda_ops.FUSED_KC and chunk_len == warps * warp_len
    assert warp_len % 4 == 0 and chunk_len >= min(length, cuda_ops.FUSED_KC)
    per_warp = [[] for _ in range(warps)]
    for k0 in range(0, length, chunk_len):
        for w in range(warps):
            lo = k0 + w * warp_len
            per_warp[w] += [k for k in range(lo, lo + warp_len) if k < length]
    assert sorted(k for terms in per_warp for k in terms) == list(range(length))
    assert all(terms == sorted(terms) for terms in per_warp)
    live = -(-min(length, chunk_len) // warp_len)
    assert all(per_warp[w] for w in range(live)) and not any(per_warp[live:])


@pytest.mark.parametrize("sizes", MODELS)
def test_plan_depends_on_shapes_alone(sizes):
    """The plan takes no batch count or epoch count, and the wrapper's ints
    for a stage are the plan's: a step, an epoch and a run launch the same
    partition."""
    assert list(inspect.signature(cuda_ops.fused_plan).parameters) == [
        "widths", "rows", "group_rows", "clip"]
    stage = [{"W": torch.zeros(n, k), "b": torch.zeros(1, n)} for k, n in zip(sizes, sizes[1:])]
    relu = [True] * (len(sizes) - 2) + [False]
    for rows, group in ((128, 32), (24, 8)):
        for clip in (None, 0.5):
            _, total, ints = cuda_ops._fused_train_table(
                stage, [], [], "sgd", rows, group, relu, clip, 0.0)
            plan = cuda_ops.fused_plan(sizes, rows, group, clip is not None)
            assert ints == tuple(plan[k] for k in cuda_ops.FUSED_PLAN_INTS)
            assert total == cuda_ops.fused_train_layout(sizes, rows)[2]


@pytest.mark.parametrize("sizes", MODELS)
def test_two_grid_barriers_a_batch_three_with_a_clip(sizes):
    """The plan's barrier counts, and the source: three grid.sync() calls in
    the kernel, the first after the group pass, one only under the clip,
    and the last before the next batch; 2L - 1 cluster barriers an item (one
    after each forward layer, the head and each dX layer but the last)."""
    L = len(sizes) - 1
    assert cuda_ops.fused_plan(sizes, 128, 32)["grid_barriers"] == 2
    assert cuda_ops.fused_plan(sizes, 128, 32, clip=True)["grid_barriers"] == 3
    assert cuda_ops.fused_plan(sizes, 128, 32)["cluster_barriers"] == (2 * L - 1 if L > 1 else 1)
    body = _src().split("fused_train_kernel(")[1].split("struct DeviceInfo")[0]
    syncs = [m.start() for m in re.finditer(r"grid\.sync\(\);", body)]
    assert len(syncs) == 3
    clip_block = body[body.index("if (has_clip) {"):]
    assert clip_block.index("grid.sync();") < clip_block.index("clip_scale(")
    assert body.count("cluster.sync();") == 3  # forward, head, dX chain


def test_plan_constants_and_ints_follow_the_source():
    """The partition's constants are the source's, and the wrapper passes
    the plan's ints in the order the C entry point names them, right after
    n_epochs."""
    src = _src()
    for name, value in (("ROW_TILE", cuda_ops.FUSED_ROW_TILE), ("COL_TILE", cuda_ops.FUSED_COL_TILE),
                        ("KC", cuda_ops.FUSED_KC), ("DW_N", cuda_ops.FUSED_DW_N),
                        ("DW_K", cuda_ops.FUSED_DW_K), ("MAX_CLUSTER", cuda_ops.FUSED_CLUSTER)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    params = re.search(r'extern "C" int fused_train\(([^)]*)\)', src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    after = names[names.index("n_epochs") + 1:-1]
    assert tuple(after) == cuda_ops.FUSED_PLAN_INTS
    assert cuda_ops.SIGNATURES["fused_train"] == (6, 2 + len(cuda_ops.FUSED_PLAN_INTS))
