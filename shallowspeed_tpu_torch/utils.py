"""Utilities: the layout-independent weight hash, per-layer digests and the
replica-sync check — the counterpart of ``shallowspeed_tpu/utils.py``.

The hash is the reference's correctness check (SHA1 of per-parameter
SHA1s), computed over the *logical* per-layer (W, b) blocks in global layer
order, so a sequential run, a DP=4 run and a DP=2 x PP=4 run of the same
model give the SAME hash — and the same hash as the JAX package gives for
the same float32 bytes. Everything here is host numpy over the logical
tree that ``TrainingSession.params()`` returns.
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
    no replica axis. A runtime that keeps a copy per replica (one process per
    rank, ROADMAP.md §A item 7) compares their hashes instead. Raises
    ``ValueError`` when a leaf is not of that layout."""
    for key in ("W", "b"):
        for l, leaf in enumerate(stacked[key]):
            if leaf.shape[0] != spec.n_stages:
                raise ValueError(
                    f"stacked {key}[{l}] has shape {tuple(leaf.shape)}: not one "
                    f"copy of {spec.n_stages} stage slots — the lockstep "
                    "layout's replica sync no longer holds by construction"
                )


def p0print(*args, **kwargs):
    """Print from process 0 only: the port runs one process, so a print."""
    print(*args, **kwargs)
