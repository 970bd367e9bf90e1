"""AOT program cache: cold starts load what a build resolved instead of
rebuilding it.

The port of ``shallowspeed_tpu/aot_cache.py``. The port compiles no XLA
program, so what a cold start rebuilds is different: the ``nvcc`` build
of each ``csrc/*.cu`` library the program launches (``_build.py``), the
lowering of its tick tables and their static analysis
(``analysis.analyze_program``), and the warm-up. The warm-up (and any CUDA
graph) does not survive the process; the rest does, and is the payload.
One entry holds one program's resolved form:

- ``tables``: the lowered program (the tick tables of a mesh program, the
  tables an MPMD stage program is planned from; None on the sequential
  layout, which has none);
- ``verdict``: the tables' ``static_analysis`` verdict, where the program
  has one;
- ``libraries``: on ``cuda``, the bytes of every kernel library the
  program launches, keyed by the stem of ``_build.library_path``, which
  already hashes the source, the shared headers and the flags. A hit
  writes the missing ones into ``build/`` (atomically), so ``_build.load``
  dlopens them and runs no ``nvcc``.

The session (``api.TrainingSession(aot_cache_dir=)``) resolves each
program through the cache before its first dispatch and keeps the JAX
contracts, in order:

- **never dispatch an unaudited program**: every program resolved through
  the cache, from a hit or from a build, runs its audit probe on clones
  (``program_audit``) against its contract before it first dispatches. A
  hit whose census breaks the contract is recorded ``audit_mismatch`` and
  ``fallback``, and the program is lowered again and its entry rewritten;
- **never crash on a bad entry**: a missing, torn, corrupt or stale entry
  is recorded (``miss``/``corrupt``/``stale``) and the program is built
  from source and stored again; ``load`` and ``store`` never raise on a
  fault of the cache;
- **own on-disk format, own write discipline**: one file per entry
  (``<key>.aotx``: magic, a ``>I`` header length, a JSON header with the
  payload's sha256, then the pickled payload), written through the
  checkpoint module's ``atomic_write``;
- **degrade to no-op, with a recorded reason**: a payload that cannot be
  pickled records ``disabled`` once, after which the cache does nothing.

Cache key = sha256 over (program label, layout tuple, backend fingerprint,
program CONTENT hash), as the JAX module's. The content hash is over
``program_text``: the label, the kernel backend, a deterministic dump of
the lowered tables and the library stems, so a change of source, header,
flag or schedule changes the key. The fingerprint (torch, its CUDA
runtime, the format version, the platform, the card's name and compute
capability, the ``nvcc`` version) is checked inside the file as well, so
an upgrade reads ``stale``, never a load.
"""

import dataclasses
import functools
import hashlib
import json
import pickle
import struct
import time
from pathlib import Path

import numpy as np

from shallowspeed_tpu_torch.checkpoint import atomic_write
from shallowspeed_tpu_torch.observability import NullMetrics

MAGIC = b"SSAOT1\n"
CACHE_FORMAT_VERSION = 1
_HEADER_LEN = struct.Struct(">I")


@functools.cache
def nvcc_version():
    """The ``nvcc --version`` release line, probed once a process; None
    where there is no ``nvcc`` (or it does not answer)."""
    import subprocess

    from shallowspeed_tpu_torch import _build

    try:
        out = subprocess.run(
            [_build.nvcc(), "--version"], capture_output=True, text=True, timeout=60,
        ).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    release = [ln for ln in lines if "release" in ln]
    return (release or lines or [None])[-1]


def backend_fingerprint(device=None):
    """What a cache entry is only valid under: torch and its CUDA runtime,
    the format version, the platform, the card's name and compute
    capability (None on the CPU) and the ``nvcc`` version. A mismatch is
    ``stale``, never an attempted load."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    fp = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "format": CACHE_FORMAT_VERSION,
        "platform": device.type,
        "device_name": None,
        "capability": None,
        "nvcc": nvcc_version(),
    }
    if device.type == "cuda":
        fp["device_name"] = torch.cuda.get_device_name(device)
        fp["capability"] = list(torch.cuda.get_device_capability(device))
    return fp


def content_hash(lowered_text):
    """sha256 of the program's text — the 'what program is this' half of
    the cache key."""
    return hashlib.sha256(lowered_text.encode()).hexdigest()


def cache_key(program, layout, fingerprint, program_hash):
    """One stable hex key per (program label, layout tuple, backend
    fingerprint, program content hash) — the filename stem."""
    blob = json.dumps(
        {
            "program": program,
            "layout": list(layout),
            "fingerprint": fingerprint,
            "content": program_hash,
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()


def dump_tables(tables):
    """A JSON-able, deterministic form of lowered tables: a ``TickProgram``
    (every field, arrays as nested lists), a sequence of them, or None."""
    if tables is None or isinstance(tables, (bool, int, float, str)):
        return tables
    if isinstance(tables, np.ndarray):
        return {"shape": list(tables.shape), "dtype": str(tables.dtype), "data": tables.tolist()}
    if isinstance(tables, np.generic):
        return tables.item()
    if dataclasses.is_dataclass(tables):
        return {
            "type": type(tables).__name__,
            **{f.name: dump_tables(getattr(tables, f.name)) for f in dataclasses.fields(tables)},
        }
    if isinstance(tables, (list, tuple)):
        return [dump_tables(t) for t in tables]
    raise TypeError(f"cannot dump {type(tables).__name__} as program tables")


def program_text(program, kernel_backend, tables, libraries):
    """The canonical text a program's content hash is taken over: its
    label, the kernel backend, the dump of its lowered tables and the
    stems of the kernel libraries it launches."""
    return json.dumps(
        {
            "program": program,
            "kernel_backend": kernel_backend,
            "tables": dump_tables(tables),
            "libraries": sorted(libraries),
        },
        sort_keys=True,
    )


class AotCache:
    """The on-disk program store (module docstring).

    ``load``/``store`` never raise on a fault of the cache: every outcome
    is recorded (an ``aot_cache`` metrics record and the ``counts`` dict)
    and a failed load returns None, after which the caller builds from
    source. A payload that cannot be pickled turns the cache into a
    recorded no-op (``disabled_reason``)."""

    def __init__(self, cache_dir, metrics=None, device=None):
        self.dir = Path(cache_dir)
        self._metrics = metrics if metrics is not None else NullMetrics()
        self._device = device
        self._fingerprint = None  # lazy: probes nvcc and the card
        self.counts = {
            "hit": 0, "miss": 0, "store": 0, "stale": 0, "corrupt": 0,
            "audit_mismatch": 0, "fallback": 0, "disabled": 0,
        }
        self.disabled_reason = None

    # -- plumbing ------------------------------------------------------------

    def fingerprint(self):
        if self._fingerprint is None:
            self._fingerprint = backend_fingerprint(self._device)
        return self._fingerprint

    def key_for(self, program, layout, program_text):
        return cache_key(program, layout, self.fingerprint(), content_hash(program_text))

    def entry_path(self, key):
        return self.dir / f"{key}.aotx"

    def record(self, event, program, key=None, wall_s=None, reason=None, **fields):
        self.counts[event] = self.counts.get(event, 0) + 1
        rec = dict(program=program, **fields)
        if key is not None:
            rec["key"] = key
        if wall_s is not None:
            rec["wall_s"] = wall_s
        if reason is not None:
            rec["reason"] = reason
        self._metrics.aot_cache(event, **rec)

    def _disable(self, reason):
        if self.disabled_reason is None:
            self.disabled_reason = str(reason)[:200]
            self.record("disabled", program="*", reason=self.disabled_reason)

    @property
    def supported(self):
        """False once the cache degraded to a recorded no-op."""
        return self.disabled_reason is None

    # -- the store -----------------------------------------------------------

    def store(self, key, payload, program="program"):
        """Pickle ``payload`` under ``key`` (mkstemp -> fsync -> atomic
        rename). Returns the entry path, or None (recorded) when the
        payload cannot be pickled or the write failed."""
        if self.disabled_reason is not None:
            return None
        t0 = time.perf_counter()
        try:
            blob = pickle.dumps(payload, protocol=4)
        except Exception as e:  # noqa: BLE001 — an unpicklable payload disables the cache, recorded
            self._disable(f"{type(e).__name__}: {e}")
            return None
        header = json.dumps(
            {
                "v": CACHE_FORMAT_VERSION,
                "key": key,
                "program": program,
                "fingerprint": self.fingerprint(),
                "sha256": hashlib.sha256(blob).hexdigest(),
                "created": time.strftime("%Y-%m-%d %H:%M:%S"),
            }
        ).encode()
        path = self.entry_path(key)

        def write_entry(f):
            f.write(MAGIC)
            f.write(_HEADER_LEN.pack(len(header)))
            f.write(header)
            f.write(blob)

        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            atomic_write(path, write_entry, suffix=".aotx.tmp")
        except OSError as e:
            self.record("fallback", program=program, key=key, reason=f"store failed: {e}"[:200])
            return None
        self.record(
            "store", program=program, key=key,
            wall_s=time.perf_counter() - t0, bytes=len(blob),
        )
        return path

    def load(self, key, program="program"):
        """The payload under ``key``, or None — with the outcome recorded as
        ``hit``, ``miss`` (no entry), ``stale`` (fingerprint or format
        mismatch) or ``corrupt`` (bad magic, a torn file, a checksum
        mismatch, an unpickle failure). The caller still owes the audit
        probe before first dispatch."""
        if self.disabled_reason is not None:
            return None
        path = self.entry_path(key)
        t0 = time.perf_counter()
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            self.record("miss", program=program, key=key)
            return None
        except OSError as e:
            self.record("corrupt", program=program, key=key, reason=f"unreadable: {e}"[:200])
            return None
        try:
            if not raw.startswith(MAGIC):
                raise ValueError("bad magic — not an aot cache entry")
            off = len(MAGIC)
            (hlen,) = _HEADER_LEN.unpack(raw[off : off + _HEADER_LEN.size])
            off += _HEADER_LEN.size
            header = json.loads(raw[off : off + hlen].decode())
            blob = raw[off + hlen :]
            if hashlib.sha256(blob).hexdigest() != header.get("sha256"):
                raise ValueError("payload sha256 mismatch — torn or bit-rotted")
        except Exception as e:  # noqa: BLE001 — any parse failure is corrupt
            self.record(
                "corrupt", program=program, key=key, reason=f"{type(e).__name__}: {e}"[:200],
            )
            return None
        if header.get("v") != CACHE_FORMAT_VERSION or header.get("fingerprint") != self.fingerprint():
            self.record(
                "stale", program=program, key=key,
                reason="backend fingerprint / format version mismatch",
            )
            return None
        try:
            payload = pickle.loads(blob)
        except Exception as e:  # noqa: BLE001 — any load failure is corrupt
            self.record(
                "corrupt", program=program, key=key,
                reason=f"unpickle failed: {type(e).__name__}: {e}"[:200],
            )
            return None
        self.record("hit", program=program, key=key, wall_s=time.perf_counter() - t0)
        return payload

    def stats(self):
        """The counts snapshot (+ hit rate over hit/miss lookups)."""
        looked = self.counts["hit"] + self.counts["miss"]
        return {
            **self.counts,
            "lookups": looked,
            "hit_rate": (self.counts["hit"] / looked) if looked else None,
            "disabled_reason": self.disabled_reason,
        }
