"""Checkpoints: the counterpart of ``shallowspeed_tpu/checkpoint.py``, in
its format, so either package reads what the other writes.

Checkpoints store the *logical* per-layer (W, b) blocks in global layer
order, so a snapshot written on any layout — the JAX trainer's or this
port's, sequential or a dp x pp mesh — loads on any other. Format: one
``.npz`` with ``w{i}``/``b{i}`` per global layer, optional optimizer-state
arrays (``ow{i}``/``ob{i}`` for momentum's mirror, ``o_{key}_w{i}`` /
``o_{key}_b{i}`` for Adam's m and v) in the same logical order, and a JSON
metadata blob (sizes, activation, global batch size, epoch, optimizer
config, Adam's step count). Format v2 adds the step cursor
(``step_in_epoch``/``global_step``: a snapshot taken mid-epoch resumes at
its exact step), a sha256 content ``checksum`` that the reader verifies, so
a torn or bit-flipped file raises ``CheckpointError`` instead of training
on garbage, and an ``all_finite`` flag that resume discovery reads to skip
a snapshot of a blown-up run.

The write path is staged, and the synchronous save and the ASYNC writer
(``AsyncCheckpointWriter``) share it:

    build (host arrays + metadata)
      -> verify (checksum + finiteness, stamped into the metadata INSIDE
         the file)
      -> mkstemp write -> fsync(file) -> atomic rename -> fsync(dir)
      -> rotation

in that order, so a kill at ANY instant leaves only fully-verifying
snapshots rename-visible: a torn temp never matches ``STEP_CHECKPOINT_RE``,
and rotation — the only destructive stage — runs after the new snapshot is
durable. Step-checkpoint directories (``step-<global_step>.npz``, rotating
retention) plus ``find_latest_good`` — newest-first discovery that
VERIFIES each candidate and falls back past corrupt ones — are what
``resume="auto"`` runs on. The async writer is one background thread
behind a BOUNDED queue: ``submit`` blocks when it is full (a snapshot is
never dropped), ``drain`` blocks until everything in flight is durable,
and a writer-side failure re-raises on the submitting thread at the next
``submit``/``drain``. The writer does host numpy work only. Save-anchored
fault injections (``die@save=N``, ``slow@save=N:ms=``, ``corrupt@save=N``,
``faults.py``) land at pinned stages of this sequence.
"""

import hashlib
import json
import os
import queue as queue_mod
import re
import tempfile
import threading
import time
import zipfile
from pathlib import Path

import numpy as np

from shallowspeed_tpu_torch import faults as F
from shallowspeed_tpu_torch import retry
from shallowspeed_tpu_torch.model import ModelSpec, make_model_spec

FORMAT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

STEP_CHECKPOINT_RE = re.compile(r"^step-(\d+)\.npz$")


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


def _flatten_logical(params_list):
    """Per-stage ragged params (host numpy) -> flat global layer list."""
    out = []
    for stage in params_list:
        for layer in stage:
            out.append(
                (
                    np.asarray(layer["W"], np.float32),
                    np.asarray(layer["b"], np.float32).reshape(1, -1),
                )
            )
    return out


def build_snapshot(
    params_list,
    spec: ModelSpec,
    epoch: int,
    extra=None,
    opt_state=None,
    step_in_epoch=None,
    global_step=None,
):
    """Stage 1 of the write discipline: flatten the logical state into the
    ``(arrays, meta)`` pair a snapshot file holds — WITHOUT verification
    (no checksum, no finiteness scan). Host numpy in: the session copies
    the live state off the device first, and under the async writer this
    stage runs on the writer thread over that copy."""
    flat = _flatten_logical(params_list)
    if len(flat) != len(spec.sizes) - 1:
        raise ValueError(
            f"param count {len(flat)} does not match spec sizes {spec.sizes}"
        )
    parts = (opt_state or {}).get("parts", {})
    scalars = (opt_state or {}).get("scalars", {})
    meta = {
        "format_version": FORMAT_VERSION,
        "sizes": list(spec.sizes),
        "act": spec.act,
        "global_batch_size": spec.global_batch_size,
        "epoch": int(epoch),
        "step_in_epoch": None if step_in_epoch is None else int(step_in_epoch),
        "global_step": None if global_step is None else int(global_step),
        "has_opt_state": "" in parts,  # legacy momentum flag (round-1 readers)
        "opt_parts": sorted(parts),
        "opt_scalars": {k: float(v) for k, v in scalars.items()},
        "extra": extra or {},
    }
    arrays = {}
    for i, (w, b) in enumerate(flat):
        arrays[f"w{i}"] = w
        arrays[f"b{i}"] = b
    for key, ragged in parts.items():
        pw, pb = _opt_prefix(key)
        flat_opt = _flatten_logical(ragged)
        if len(flat_opt) != len(flat):
            raise ValueError(
                f"optimizer-state part {key!r} layer count {len(flat_opt)} != "
                f"param count {len(flat)}"
            )
        for i, (ow, ob) in enumerate(flat_opt):
            if ow.shape != flat[i][0].shape or ob.shape != flat[i][1].shape:
                raise ValueError(
                    f"optimizer-state part {key!r} layer {i} shape "
                    f"{ow.shape}/{ob.shape} does not mirror the params "
                    f"{flat[i][0].shape}/{flat[i][1].shape}"
                )
            arrays[f"{pw}{i}"] = ow
            arrays[f"{pb}{i}"] = ob
    return arrays, meta


def stamp_verification(arrays, meta):
    """Stage 2: sha256 content checksum + finiteness scan over the EXACT
    arrays that will be written, stamped into the metadata (which lands
    inside the same atomic file). Returns the ``all_finite`` flag. Off the
    step path under the async writer; its cost is the ``verify_s`` of
    ``run_save_stages``'s completion dict."""
    meta["checksum"] = content_checksum(arrays)
    meta["all_finite"] = bool(
        all(np.isfinite(a).all() for a in arrays.values())
    )
    return meta["all_finite"]


def write_snapshot(path, arrays, meta, fsync=True, pre_rename_hook=None):
    """Stage 3: the durable atomic write — mkstemp INSIDE the retried body
    (each attempt owns, and on any failure removes, its own temp file, so
    a mid-stream exception never leaks a ``*.npz.tmp`` beside the target),
    ``np.savez``, ``fsync`` of the file, atomic ``os.replace``, then
    ``fsync`` of the directory so the rename itself is durable — in that
    order, which is what makes a kill at any instant leave either the old
    directory state or the new fully-written file, never a torn
    rename-visible snapshot. Transient ``OSError`` retries under the
    shared bounded backoff. ``pre_rename_hook`` (fault injection only)
    runs after the temp file is durable and BEFORE the rename — the
    chaos harness's deterministic kill point inside the window. Returns
    bytes written."""
    path = Path(path)
    payload = dict(arrays)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)

    def write_once():
        return atomic_write(
            path, lambda f: np.savez(f, **payload),
            suffix=".npz.tmp", fsync=fsync, pre_rename_hook=pre_rename_hook,
        )

    return retry.retry_call(write_once, attempts=3, retry_on=(OSError,))


def atomic_write(path, write_cb, suffix=".tmp", fsync=True,
                 pre_rename_hook=None):
    """The durable atomic write: mkstemp in
    the target directory, ``write_cb(file)``, ``fsync(file)``, atomic
    ``os.replace``, ``fsync(dir)`` — with the temp file removed on ANY
    failure, so a mid-stream exception never leaks a temp beside the
    target. ``pre_rename_hook(tmp)`` (fault injection only) runs after
    the temp is durable and before the rename — the deterministic kill
    point inside the window. Returns bytes written."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write_cb(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if pre_rename_hook is not None:
            pre_rename_hook(tmp)
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(path.parent)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return os.path.getsize(path)


def _fsync_dir(dirpath):
    """fsync a directory so a just-renamed entry survives power loss —
    best-effort on filesystems/platforms that refuse O_RDONLY dir fds."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(
    path,
    params_list,
    spec: ModelSpec,
    epoch: int,
    extra=None,
    opt_state=None,
    step_in_epoch=None,
    global_step=None,
):
    """Atomically write params (+ metadata) to ``path`` (.npz).

    ``opt_state``: optional logical optimizer state, as
    ``{"parts": {key: ragged_list}, "scalars": {key: float}}`` where each
    ragged_list has the SAME structure as ``params_list`` (state parts
    mirror the params — momentum velocity, Adam moments) — stored in the
    same logical layer order, so it is exactly as layout-independent as the
    weights; scalars (Adam's step count) go into the metadata blob.

    ``step_in_epoch`` / ``global_step``: the v2 resumable cursor — with
    them set, ``epoch`` means "the epoch IN PROGRESS" and resume restarts
    at exactly this optimizer step; without them (the legacy epoch-boundary
    save), ``epoch`` means "last COMPLETED epoch" and resume restarts at
    ``epoch + 1``. A mid-stream failure never leaves a temp file behind,
    and transient ``OSError`` on the write path is retried with bounded
    backoff (retry.retry_call) before surfacing.

    Returns ``(bytes_written, all_finite)`` — the finiteness flag that was
    stamped into the metadata, so callers can gate retention on it without
    re-scanning the arrays (a non-finite snapshot must never rotate the
    last healthy one away).
    """
    arrays, meta = build_snapshot(
        params_list, spec, epoch, extra=extra, opt_state=opt_state,
        step_in_epoch=step_in_epoch, global_step=global_step,
    )
    finite = stamp_verification(arrays, meta)
    nbytes = write_snapshot(path, arrays, meta)
    return nbytes, finite


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


# ---------------------------------------------------------------------------
# step-checkpoint directories: rotation + crash-recovery discovery
# ---------------------------------------------------------------------------


def step_checkpoint_path(ckpt_dir, global_step):
    """Canonical name of the snapshot at ``global_step``: zero-padded so
    lexical order == step order (``step-00000042.npz``)."""
    return Path(ckpt_dir) / f"step-{int(global_step):08d}.npz"


def list_step_checkpoints(ckpt_dir):
    """``[(global_step, path), ...]`` ascending by step; [] for a missing
    directory (a fresh run's ``--resume auto`` finds nothing, starts clean)."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    out = []
    for p in d.iterdir():
        m = STEP_CHECKPOINT_RE.match(p.name)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def rotate_step_checkpoints(ckpt_dir, keep, trusted=()):
    """Delete all but ``keep`` step snapshots; returns the removed paths.
    Retention is the corrupt-newest safety margin: fallback needs older
    snapshots to still exist.

    Ranking is usability-first, then step: a snapshot that fully verifies
    (checksum intact, all values finite — exactly ``find_latest_good``'s
    resume criteria) always outranks one that does not, regardless of step
    number. A blown-up or bit-rotted run leaves high-step unusable
    snapshots behind (a blow-up's own saves skip rotation — see
    ``save_step_checkpoint``); ranked purely by step they would crowd the
    healthy snapshots out of the keep window and rotation would delete the
    only ``resume='auto'`` targets — permanently unrecoverable. Instead
    the stale unusable pile is what rotation reclaims. Verification reads
    each candidate once per rotation; a caller that just wrote (and
    checksummed) snapshots in-process can list them in ``trusted`` to skip
    re-reading them (``TrainingSession`` passes the paths it wrote finite
    this run)."""
    if keep < 1:
        raise ValueError("keep must be >= 1")
    snaps = list_step_checkpoints(ckpt_dir)
    if len(snaps) <= keep:
        return []
    trusted = {Path(p).resolve() for p in trusted}

    def rank(item):
        step, path = item
        if path.resolve() in trusted:
            return (True, step)
        try:
            verify_checkpoint(path, require_finite=True)
        except CheckpointError:
            return (False, step)
        return (True, step)

    victims = [p for _, p in sorted(snaps, key=rank)[:-keep]]
    for p in victims:
        try:
            p.unlink()
        except OSError:
            pass  # retention is best-effort; a stale extra snapshot is harmless
    return victims


def find_newer_good(ckpt_dir, than_step=None, require_finite=True,
                    with_arrays=False):
    """Checkpoint-dir WATCHER discovery: the newest verifying step snapshot
    STRICTLY newer than ``than_step`` (``None`` accepts any step). Returns
    ``(step, path, meta, skipped)`` — ``skipped`` lists ``(path, cause)``
    for every newer candidate that failed verification — or
    ``(None, None, None, skipped)`` when nothing newer verifies. This is
    ``find_latest_good`` with a freshness floor, for a watcher (a serving
    hot reload) that polls a directory a concurrent training run keeps
    writing, without ever re-loading the snapshot it already serves.

    ``with_arrays=True`` returns ``(step, path, meta, arrays, skipped)``:
    the verified arrays themselves, so the reload that follows is the SAME
    read discovery verified — one read, no discovery->load TOCTOU window
    (exactly the property the watcher needs, since it polls a directory a
    concurrent trainer keeps writing and rotating)."""
    skipped = []
    for step, p in reversed(list_step_checkpoints(ckpt_dir)):
        if than_step is not None and step <= than_step:
            break  # list is step-ascending: nothing older can be newer
        try:
            got = verify_checkpoint(
                p, require_finite=require_finite, with_arrays=with_arrays
            )
        except CheckpointError as e:
            skipped.append((p, e.cause))
            continue
        if with_arrays:
            meta, arrays = got
            return step, p, meta, arrays, skipped
        return step, p, got, skipped
    if with_arrays:
        return None, None, None, None, skipped
    return None, None, None, skipped


def find_latest_good(ckpt_dir, require_finite=True, with_arrays=False):
    """Crash-recovery discovery: walk the step snapshots NEWEST FIRST,
    verify each (read + checksum + optional finiteness), and return
    ``(path, meta, skipped)`` for the first one that verifies — ``skipped``
    lists ``(path, cause)`` for every newer snapshot that failed (the
    evidence the recovery record carries). Returns ``(None, None, skipped)``
    when nothing in the directory verifies (or it is empty/missing).

    ``with_arrays=True`` returns ``(path, meta, arrays, skipped)`` — the
    verified read itself, for the single-verified-read resume/reload path
    (``assemble_checkpoint`` / ``TrainingSession.load_weights``): the
    caller loads exactly the bytes discovery checksummed, so nothing can
    rot or rotate away between the verify and the load."""
    skipped = []
    for _, p in reversed(list_step_checkpoints(ckpt_dir)):
        try:
            got = verify_checkpoint(
                p, require_finite=require_finite, with_arrays=with_arrays
            )
        except CheckpointError as e:
            skipped.append((p, e.cause))
            continue
        if with_arrays:
            meta, arrays = got
            return p, meta, arrays, skipped
        return p, got, skipped
    if with_arrays:
        return None, None, None, skipped
    return None, None, skipped


def find_step_at_or_before(ckpt_dir, step, require_finite=True):
    """Bisect-replay discovery (the JAX package's ``divergence --bisect``
    uses it): the NEWEST verifying step snapshot with ``global_step <= step``.
    Returns ``(found_step, path, meta, skipped)`` — ``skipped`` lists
    ``(path, cause)`` for every candidate in range that failed
    verification — or ``(None, None, None, skipped)`` when nothing at or
    before ``step`` verifies. The digest at step N covers the params
    AFTER step N's update (= the ``step-(N+1)`` snapshot's contents), so
    the replayer restores at-or-before the last AGREEING step and trains
    forward to the first divergent one."""
    skipped = []
    for s, p in reversed(list_step_checkpoints(ckpt_dir)):
        if s > step:
            continue
        try:
            meta = verify_checkpoint(p, require_finite=require_finite)
        except CheckpointError as e:
            skipped.append((p, e.cause))
            continue
        return s, p, meta, skipped
    return None, None, None, skipped


# ---------------------------------------------------------------------------
# the async checkpoint writer
# ---------------------------------------------------------------------------


class AsyncCheckpointWriter:
    """One background thread that runs stages 2-4 of the write discipline
    (verify -> write-fsync-rename -> rotate) off the training step path.

    The step path keeps only stage 1 (a host copy of the live state)
    plus the enqueue; everything that made the synchronous save expensive — the
    sha256 over every array, the finiteness scan, the zip write, the
    fsyncs — happens here, overlapped with the next dispatches. The
    crash-consistency contract is IDENTICAL to the synchronous path
    because the stages and their order are identical (shared helpers):
    a kill at any instant leaves only fully-verifying snapshots
    rename-visible, and rotation runs strictly after the new snapshot
    is durable.

    Concurrency contract:

    - ``submit`` BLOCKS while ``max_in_flight`` jobs are queued or being
      written — bounded backpressure; a snapshot is never dropped to
      keep the step loop fast (dropping would silently widen the replay
      window past the configured cadence);
    - jobs are processed strictly in submit order by ONE thread, so
      snapshots rename into place in step order and rotation never
      races a write;
    - ``drain`` blocks until the queue is empty and the in-flight job
      is durable; a writer-side exception is captured and re-raised
      (wrapped in ``CheckpointError`` when it isn't one) on the NEXT
      ``submit``/``drain`` call — the failure surfaces on the thread
      that owns the training loop, never into a daemon-thread
      traceback;
    - ``on_complete(result)`` (when given) runs ON THE WRITER THREAD
      after each successful save with a dict of path/bytes/finite and
      the per-stage timings — the session uses it to update its
      trusted-snapshot set.

    Fault injection (``faults.FaultPlan``, ``@save=N`` anchors): each
    job carries its save sequence number; ``due_at_save`` faults fire at
    pinned stages — ``corrupt`` flips the in-flight buffer after the
    checksum is stamped (the written file renames but never verifies),
    ``slow`` sleeps and ``die`` kills after the temp file is durable and
    BEFORE the rename (the torn-temp window: the kill leaves a
    ``*.npz.tmp`` that discovery cannot see).
    """

    def __init__(self, max_in_flight=2, faults=None, on_complete=None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._queue = queue_mod.Queue(maxsize=int(max_in_flight))
        self._faults = faults
        self._on_complete = on_complete
        # the one cross-thread mutable: failures append on the writer
        # thread and swap-drain on the submitting thread. The lock makes
        # the discipline explicit instead of leaning on CPython list-op
        # atomicity.
        self._errors_lock = threading.Lock()
        self._errors = []  # EVERY writer-side failure, in job order
        # completed trusted paths, writer-thread-confined: merged into
        # each job's (submit-time) trusted tuple so rotation never
        # re-verifies a snapshot that was still in flight when the next
        # one was submitted
        self._recent_trusted = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="ckpt-writer", daemon=True
        )
        self._thread.start()

    @property
    def queue_depth(self):
        """Jobs queued but not yet picked up by the writer (the
        backpressure signal)."""
        return self._queue.qsize()

    def _raise_pending(self):
        """Surface writer-side failures on the submitting thread. EVERY
        failed job is kept (a disk-full burst fails several in a row, and
        swallowing the tail would let the caller believe those snapshots
        are durable); the first raises, carrying the rest by name."""
        with self._errors_lock:
            if not self._errors:
                return
            errs, self._errors = self._errors, []
        first = errs[0]
        if len(errs) > 1:
            rest = "; ".join(
                f"{type(e).__name__}: {e}"[:120] for e in errs[1:]
            )
            raise CheckpointError(
                "async-writer",
                f"{len(errs)} saves failed — first: "
                f"{type(first).__name__}: {first}; also: {rest}",
            ) from first
        raise first

    def submit(self, path, arrays, meta, save_seq, rotate_dir=None,
               rotate_keep=None, trusted=(), on_complete=None, build=None):
        """Enqueue one snapshot (stage-1 output) for background
        verify+write+rotate; blocks while the in-flight window is full.
        ``save_seq`` is the session's save sequence number — the fault
        anchor. ``rotate_dir``/``rotate_keep`` arm post-rename rotation
        (skipped automatically for non-finite snapshots, like the sync
        path); ``trusted`` is passed through to the rotation ranking —
        pass an IMMUTABLE snapshot (a tuple), never a live set another
        thread keeps mutating.
        ``on_complete`` rides WITH the job (falling back to the writer's
        default), so a callback can never be applied to the wrong
        in-flight snapshot.

        ``build`` (instead of ``arrays``/``meta``): a zero-argument
        callable returning ``(arrays, meta)``, run ON THE WRITER THREAD
        before the save stages — the deferred logical-unstacking hook.
        The step path then carries only the raw host copy of the live
        state (which must stay on-path for consistency); the host-side
        reshaping of params/opt-state into the layout-independent
        snapshot form happens off-path, and its wall is reported as
        ``unstack_s`` in the completion dict. The callable must capture
        IMMUTABLE copies only (the training loop keeps mutating session
        state while the writer drains)."""
        self._raise_pending()
        if self._closed:
            raise ValueError("writer is closed")
        if (build is None) == (arrays is None):
            raise ValueError("submit takes arrays+meta or build, not both")
        self._queue.put(
            {
                "path": Path(path),
                "arrays": arrays,
                "meta": meta,
                "build": build,
                "save_seq": int(save_seq),
                "rotate_dir": rotate_dir,
                "rotate_keep": rotate_keep,
                "trusted": trusted,
                "on_complete": on_complete,
                "enqueue_t": time.perf_counter(),
            }
        )

    def drain(self):
        """Block until every submitted snapshot is durable (or the writer
        failed — the failure re-raises here). Safe to call repeatedly;
        the session's ``close`` and the training CLI's exit both run it,
        so a clean exit never leaves a snapshot in flight."""
        self._queue.join()
        self._raise_pending()

    def close(self):
        """Drain, then stop the writer thread. Idempotent."""
        if self._closed:
            self._queue.join()
            self._raise_pending()
            return
        self._queue.join()
        self._closed = True
        self._queue.put(None)  # wake the thread past the blocking get
        self._thread.join(timeout=30)
        self._raise_pending()

    # -- the writer thread ---------------------------------------------------

    def _run(self):
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._process(job)
            except BaseException as e:  # noqa: BLE001 — surfaced on drain
                with self._errors_lock:
                    self._errors.append(e)
            finally:
                self._queue.task_done()

    def _process(self, job):
        t0 = time.perf_counter()
        arrays, meta = job["arrays"], job["meta"]
        unstack_s = 0.0
        if job.get("build") is not None:
            # deferred logical unstacking (off the step path): the raw
            # device->host snapshot becomes the layout-independent
            # arrays+meta here, overlapped with training dispatches
            tb = time.perf_counter()
            arrays, meta = job["build"]()
            unstack_s = time.perf_counter() - tb
        result = run_save_stages(
            job["path"], arrays, meta,
            faults=self._faults, save_seq=job["save_seq"],
            rotate_dir=job["rotate_dir"], rotate_keep=job["rotate_keep"],
            # the job's submit-time tuple may predate an in-flight save
            # that has since completed; the writer-confined recent list
            # closes that gap so rotation never re-verifies it
            trusted=(*job["trusted"], *self._recent_trusted),
        )
        if result["trusted"]:
            self._recent_trusted.append(str(job["path"]))
        result["queued_s"] = t0 - job["enqueue_t"]
        result["unstack_s"] = unstack_s
        callback = job.get("on_complete") or self._on_complete
        if callback is not None:
            callback(result)


def run_save_stages(path, arrays, meta, faults=None, save_seq=0,
                    rotate_dir=None, rotate_keep=None, trusted=()):
    """Stages 2-4 of one save, with the save-anchored fault injections
    landed at their pinned points — shared VERBATIM by the async writer
    thread and the synchronous ``save_step_checkpoint`` path, so the two
    paths can never drift in stage order or crash windows:

    1. verify: checksum + finiteness stamped into the metadata;
    2. ``corrupt@save=N`` fires HERE — after the stamp, so the written
       file renames into place but can never verify (the bit-rot shape
       discovery must fall back past);
    3. mkstemp write + fsync; then ``slow@save=N`` sleeps and
       ``die@save=N`` kills — temp durable, rename NOT yet visible (the
       torn-temp window: the kill leaves nothing discovery can see);
    4. atomic rename + dir fsync;
    5. rotation (finite snapshots only — the non-finite pile must never
       rotate the last healthy snapshot away).

    Returns the completion dict (path/bytes/all_finite + per-stage
    timings)."""
    pending = faults.due_at_save(save_seq) if faults else ()
    t0 = time.perf_counter()
    finite = stamp_verification(arrays, meta)
    verify_s = time.perf_counter() - t0
    corrupted = False
    for f in pending:
        if f.kind == "corrupt" and not f.fired:
            f.fired = True
            corrupted = True
            F.corrupt_buffer(arrays)

    def window_hook(tmp):
        for f in pending:
            if f.fired:
                continue
            if f.kind == "slow":
                f.fired = True
                time.sleep(f.ms / 1000.0)
            elif f.kind == "die":
                faults.fire_die(f)  # sigkill never returns; exc raises

    t1 = time.perf_counter()
    nbytes = write_snapshot(path, arrays, meta, pre_rename_hook=window_hook)
    write_s = time.perf_counter() - t1
    # a corrupt-injected snapshot renamed into place but can never verify:
    # it must count as UNUSABLE everywhere the finite flag gates — rotation
    # must not run off it (it would rank as usable and could delete the
    # last good snapshot, the exact fallback the injection exists to
    # prove), and the caller must not add it to the trusted set
    usable = finite and not corrupted
    rotated = []
    if rotate_dir is not None and usable:
        # the snapshot JUST written (finite, checksummed in-process) joins
        # the trusted set for THIS rotation — without it every rotating
        # save would re-read and re-checksum the file it just produced,
        # exactly the redundant verify-read the trusted ranking exists to
        # skip. ``trusted`` itself must be an immutable snapshot taken by
        # the caller (tuple), never a live set another thread mutates:
        # rotation iterates it with syscalls in between.
        rotated = rotate_step_checkpoints(
            rotate_dir, rotate_keep,
            trusted=(*tuple(trusted), str(path)),
        )
    return {
        "path": Path(path),
        "meta": meta,
        "bytes": int(nbytes),
        "all_finite": finite,
        "trusted": usable,
        "verify_s": verify_s,
        "write_s": write_s,
        "queued_s": 0.0,
        "rotated": [str(p) for p in rotated],
    }
