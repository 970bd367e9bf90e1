"""Checkpoint read path: the counterpart of ``shallowspeed_tpu/checkpoint.py``.

Checkpoints store the *logical* per-layer (W, b) blocks in global layer
order, so a snapshot that the JAX trainer wrote (``train.py --checkpoint``,
``TrainingSession.save``, the step checkpoints) loads here on any layout
and serves in the port. Format: one ``.npz`` with ``w{i}``/``b{i}`` per
global layer, optional optimizer-state arrays, and a JSON metadata blob;
format v2 adds a sha256 content checksum that the reader verifies, so a
torn or bit-flipped file raises ``CheckpointError`` instead of serving
garbage.

Only reading is ported in this slice; writing, rotation and the async
writer come with the training slice.
"""

import hashlib
import json
import zipfile
from pathlib import Path

import numpy as np

from shallowspeed_tpu_torch.model import ModelSpec, make_model_spec

SUPPORTED_VERSIONS = (1, 2)


class CheckpointError(RuntimeError):
    """A checkpoint file that cannot be trusted: unreadable, truncated,
    wrong format, or failing its content checksum. Carries the ``path``
    and a human ``cause`` so the error names what to look at."""

    def __init__(self, path, cause):
        self.path = str(path)
        self.cause = cause
        super().__init__(f"checkpoint {self.path}: {cause}")


def _opt_prefix(key):
    """Array-name prefix for an optimizer-state part: the unnamed part keeps
    ``ow{i}``/``ob{i}``, named parts (Adam's m/v) are ``o_{key}_w{i}``."""
    return ("ow", "ob") if key == "" else (f"o_{key}_w", f"o_{key}_b")


def content_checksum(arrays):
    """sha256 over every non-meta array's name, dtype, shape and bytes, in
    name-sorted order — the format-v2 torn/corrupt-file detector."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == "meta":
            continue
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _partition(flat, spec: ModelSpec):
    """Flat global layer list -> per-stage ragged list for ``spec``."""
    out, k = [], 0
    for sspec in spec.stages:
        layers = []
        for _ in range(sspec.n_linears):
            w, b = flat[k]
            layers.append({"W": w, "b": b})
            k += 1
        out.append(layers)
    return out


def _read_arrays(path):
    """Open ``path`` and return ``(meta, arrays)``, every failure mode
    translated into a ``CheckpointError`` naming the path and the suspected
    cause. Verifies the v2 content checksum when the metadata has one."""
    path = Path(path)
    try:
        size = path.stat().st_size
    except OSError as e:
        raise CheckpointError(path, f"cannot stat file ({e})") from e
    if size == 0:
        raise CheckpointError(
            path, "file is empty (zero bytes — torn write or placeholder)"
        )
    try:
        with np.load(path) as z:
            arrays = {name: z[name] for name in z.files}
    except zipfile.BadZipFile as e:
        raise CheckpointError(
            path,
            f"truncated or corrupt .npz archive ({e}) — the write likely "
            "died mid-stream",
        ) from e
    except (OSError, EOFError) as e:
        raise CheckpointError(path, f"unreadable ({e})") from e
    except ValueError as e:
        raise CheckpointError(
            path, f"not a .npz checkpoint (wrong format: {e})"
        ) from e
    if "meta" not in arrays:
        raise CheckpointError(
            path, "no metadata blob — not a shallowspeed checkpoint"
        )
    try:
        meta = json.loads(bytes(arrays["meta"]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointError(
            path, f"metadata blob is not valid JSON ({e}) — corrupt file"
        ) from e
    if meta.get("format_version") not in SUPPORTED_VERSIONS:
        raise CheckpointError(
            path,
            f"unsupported format version {meta.get('format_version')!r} "
            f"(this reader understands {SUPPORTED_VERSIONS})",
        )
    saved_sum = meta.get("checksum")
    if saved_sum is not None:
        actual = content_checksum(arrays)
        if actual != saved_sum:
            raise CheckpointError(
                path,
                f"content checksum mismatch (stored {saved_sum[:12]}…, "
                f"recomputed {actual[:12]}…) — torn or corrupted write",
            )
    return meta, arrays


def verify_checkpoint(path, require_finite=False, with_arrays=False):
    """Read + parse + checksum: the metadata of a trustworthy checkpoint, or
    ``CheckpointError``. ``require_finite`` also rejects snapshots holding
    NaN/Inf; ``with_arrays`` returns ``(meta, arrays)``."""
    meta, arrays = _read_arrays(path)
    if require_finite:
        finite = meta.get("all_finite")
        if finite is None:  # v1 file: flag absent, check the arrays
            finite = all(
                np.isfinite(a).all()
                for name, a in arrays.items()
                if name != "meta" and np.issubdtype(a.dtype, np.floating)
            )
        if not finite:
            raise CheckpointError(
                path, "contains non-finite values (snapshot of a blown-up run)"
            )
    if with_arrays:
        return meta, arrays
    return meta


def load_checkpoint(path, n_stages: int, global_batch_size=None, with_opt_state=False):
    """Load a checkpoint and re-partition it for an ``n_stages`` layout.

    Returns ``(params_list, spec, meta)`` — ``params_list`` per-stage ragged
    host numpy (``convert.params_from_numpy`` makes modules of it) — or,
    with ``with_opt_state=True``, ``(params_list, spec, meta, opt_state)``.
    ``global_batch_size`` defaults to the saved value."""
    meta, z = _read_arrays(path)
    return assemble_checkpoint(
        path, meta, z, n_stages,
        global_batch_size=global_batch_size, with_opt_state=with_opt_state,
    )


def assemble_checkpoint(
    path, meta, z, n_stages: int, global_batch_size=None, with_opt_state=False
):
    """``load_checkpoint``'s second half on ALREADY-VERIFIED ``(meta,
    arrays)``: re-partition without re-reading the file. ``path`` only
    names errors."""
    try:
        n_layers = len(meta["sizes"]) - 1
        flat = [(z[f"w{i}"], z[f"b{i}"]) for i in range(n_layers)]
        # opt_parts supersedes has_opt_state; round-1 files have only the
        # latter (and only the unnamed part)
        part_keys = meta.get("opt_parts")
        if part_keys is None:
            part_keys = [""] if meta.get("has_opt_state") else []
        flat_parts = {}
        for key in part_keys:
            pw, pb = _opt_prefix(key)
            flat_parts[key] = [(z[f"{pw}{i}"], z[f"{pb}{i}"]) for i in range(n_layers)]
    except KeyError as e:
        raise CheckpointError(
            path, f"missing array {e} — truncated or foreign file"
        ) from e
    if global_batch_size is None:
        global_batch_size = meta["global_batch_size"]
    # pre-zoo snapshots carry no "act": every one of them is a relu MLP
    spec = make_model_spec(
        meta["sizes"], n_stages, global_batch_size,
        act=meta.get("act", "relu"),
    )
    params_list = _partition(flat, spec)
    for sspec, layers in zip(spec.stages, params_list):
        for l, layer in enumerate(layers):
            want = (sspec.local_sizes[l + 1], sspec.local_sizes[l])
            if layer["W"].shape != want:
                raise ValueError(
                    f"checkpoint layer shape {layer['W'].shape} != spec {want}"
                )
    if not with_opt_state:
        return params_list, spec, meta
    opt_state = None
    if flat_parts or meta.get("opt_scalars"):
        opt_state = {
            "parts": {k: _partition(v, spec) for k, v in flat_parts.items()},
            "scalars": dict(meta.get("opt_scalars", {})),
        }
    return params_list, spec, meta, opt_state
