"""Utilities: the layout-independent weight hash, per-layer digests and the
replica-sync check — the counterpart of ``shallowspeed_tpu/utils.py``.

The hash is the reference's correctness check (SHA1 of per-parameter
SHA1s), computed over the *logical* per-layer (W, b) blocks in global layer
order, so a sequential run, a DP=4 run and a DP=2 x PP=4 run of the same
model give the SAME hash — and the same hash as the JAX package gives for
the same float32 bytes. Everything here is host numpy over the logical
tree that ``TrainingSession.params()`` returns, but the multi-process
replica check, which gathers each process's row hashes over the process
mesh (``parallel/multihost.py``), and ``p0print``.
"""

from hashlib import sha1

import numpy as np


def iter_param_blocks(params_list):
    """Yield ``(global_layer, key, float32_array)`` for every logical (W, b)
    block of a logical params tree, in global layer order, W before b: the
    one block definition behind ``model_hash`` and ``layer_digests``.

    ``params_list``: per stage a list of ``{"W", "b"}`` arrays (host numpy).
    """
    gl = 0
    for stage in params_list:
        for layer in stage:
            for key in ("W", "b"):
                yield gl, key, np.ascontiguousarray(layer[key], np.float32)
            gl += 1


def model_hash(params_list) -> str:
    """SHA1 over the concatenated hex SHA1s of the ``iter_param_blocks``
    blocks' bytes (the reference's definition; the value of a fixed tree is
    pinned by the tests against the JAX package's)."""
    acc = ""
    for _gl, _key, arr in iter_param_blocks(params_list):
        acc += sha1(arr.tobytes()).hexdigest()
    return sha1(acc.encode("utf-8")).hexdigest()


def block_checksum(arr) -> int:
    """The digest checksum of one block: the uint32 wrap-around sum of its
    float32 bytes read as uint32 words."""
    a = np.ascontiguousarray(arr, np.float32)
    return int(a.view(np.uint32).sum(dtype=np.uint64) % (1 << 32))


def layer_digests(params_list):
    """Per-global-layer digests of a logical params tree: a list of
    ``{"layer", "crc_w", "crc_b", "pnorm_w", "pnorm_b"}`` dicts over the
    ``iter_param_blocks`` blocks (the JAX package's host-side reference of
    its digest stream)."""
    out = {}
    for gl, key, arr in iter_param_blocks(params_list):
        d = out.setdefault(gl, {"layer": gl})
        suffix = "w" if key == "W" else "b"
        d[f"crc_{suffix}"] = block_checksum(arr)
        d[f"pnorm_{suffix}"] = float(np.sqrt(np.sum(arr.astype(np.float64) ** 2)))
    return [out[gl] for gl in sorted(out)]


def assert_dp_replicas_in_sync(stacked, spec) -> None:
    """The replica-sync check of the lockstep executor's layout, which holds
    by construction: the executor keeps ONE stacked copy of the params for
    every dp replica (``parallel/executor.py``: the replicas' gradients meet
    in ``dp_sum`` and one optimizer step updates that copy), so there are no
    per-replica copies that could drift apart. What is checked is that
    invariant itself — every stacked leaf has one slot per pipeline stage and
    no replica axis. The multi-process runtime keeps a copy per process and
    compares their hashes (``assert_dp_replicas_in_sync_global``). Raises
    ``ValueError`` when a leaf is not of that layout."""
    for key in ("W", "b"):
        for l, leaf in enumerate(stacked[key]):
            if leaf.shape[0] != spec.n_stages:
                raise ValueError(
                    f"stacked {key}[{l}] has shape {tuple(leaf.shape)}: not one "
                    f"copy of {spec.n_stages} stage slots — the lockstep "
                    "layout's replica sync no longer holds by construction"
                )


def _leaves(tree, path=()):
    """``(path, leaf)`` of a nest of dicts (keys sorted), lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _stacks(tree):
    """Every stacked ``{W, b}`` dict inside a nest of dicts."""
    if isinstance(tree, dict):
        if set(tree) == {"W", "b"}:
            yield tree
            return
        for k in sorted(tree):
            yield from _stacks(tree[k])


def assert_dp_replicas_in_sync_global(tree, spec, mesh, sharded=False) -> None:
    """The multi-process replica-sync check (the JAX package's
    ``utils.assert_dp_replicas_in_sync_global``, and the reference's gather
    of the replicas' hashes over the dp communicator). ``tree``: this
    process's share of state every dp replica must hold alike — the stacked
    params, or an optimizer state of their layout (zero 0) — as nests whose
    tensors lead with this process's stacked rows (at tp > 1 its tp
    ranks' bands of them), and 0-d scalars (Adam's step). Each process
    SHA1s each of its leaves' rows; the hashes are gathered with
    ``all_gather_object`` over the mesh, and only the copies that hold the
    same logical shard are compared, as the JAX check compares the devices
    holding the same shard index: the same ``(leaf, stacked row, tp
    band)`` on different dp replicas (a scalar is one shard every process
    holds). A ZeRO shard — ``sharded=True`` (a zero >= 1 optimizer state)
    or the ZeRO-3 params at rest (``{"P": ...}``) — is one dp rank's
    columns, held by no other process: its 2-D leaves are compared with
    nothing, only its scalars. A mismatch raises ``ValueError`` on every
    process. On one process (a ``VirtualMesh``, or a process mesh of world
    1) it is ``assert_dp_replicas_in_sync`` on each stacked ``{W, b}`` of
    ``tree``."""
    from shallowspeed_tpu_torch.parallel.mesh import ProcessMesh

    if not isinstance(mesh, ProcessMesh) or mesh.world == 1:
        for stacked in _stacks(tree):
            assert_dp_replicas_in_sync(stacked, spec)
        return
    sharded = sharded or (isinstance(tree, dict) and set(tree) == {"P"})
    V = spec.n_stages // mesh.pp
    first, n_rows = mesh.local_stages.start * V, len(mesh.local_stages) * V
    band = mesh.local_tp.start
    mine = {}
    for li, (path, leaf) in enumerate(_leaves(tree)):
        host = np.ascontiguousarray(leaf.detach().cpu().numpy())
        if host.ndim == 0:
            mine[(li, None)] = sha1(host.tobytes()).hexdigest()
            continue
        if sharded:
            continue
        if host.shape[0] != n_rows:
            raise ValueError(
                f"leaf {path} has {host.shape[0]} rows: not this process's "
                f"{n_rows} stacked rows of the process mesh"
            )
        for r in range(n_rows):
            mine[(li, first + r, band)] = sha1(host[r].tobytes()).hexdigest()
    seen = {}
    for theirs in mesh.comm.all_gather_object(mine):
        for key, h in theirs.items():
            seen.setdefault(key, set()).add(h)
    mismatches = sorted(
        (key[:2] if mesh.tp == 1 else key for key, hashes in seen.items() if len(hashes) > 1),
        key=lambda k: (k[0], -1 if k[1] is None else k[1]) + tuple(k[2:]),
    )
    if mismatches:
        raise ValueError(
            f"cross-process replica desync at (leaf, shard-index): {mismatches}"
        )


def p0print(*args, **kwargs):
    """Print from process 0 only (the reference's ``rprint``): rank 0 of
    the process group, or the one process when none is up."""
    from shallowspeed_tpu_torch.parallel import multihost

    if multihost.process_index() == 0:
        print(*args, **kwargs)
