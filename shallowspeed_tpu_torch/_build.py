"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``build/shallowspeed_tpu_torch/<name>-<sha>.so`` beside the
package, where ``<sha>`` hashes the source, the shared headers
``csrc/*.cuh`` and the flags: an edited source builds anew, an unchanged one
is loaded from disk. Nothing is built at
import time; ``load(name)`` builds on first use, and ``build_all()``
starts one ``nvcc`` per source at once, so the build time of several
kernels is that of the slowest. ``BUILDS`` counts the real ``nvcc`` builds
of this process per source (the counterpart of the JAX package's
``jit_compiles`` counter: a cache-warm start builds nothing), and
``BUILD_WALL_S`` holds each one's wall, start to exit. ``install_library``
writes a library's bytes (an AOT cache entry's, ``aot_cache.py``) to its
``library_path`` atomically, so ``load`` dlopens it and runs no ``nvcc``.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper; the ``a`` keeps
wgmma and setmaxnreg available), ``-O3``, no fast-math (the kernels owe the
reference IEEE fp32), and ``-Xptxas -v``, whose register and spill report
``build_all`` returns.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "shallowspeed_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LIBS = {}  # (name, defines) -> ctypes.CDLL, loaded once per process
BUILDS = {}  # name -> real nvcc builds in this process
BUILD_WALL_S = {}  # name -> the last build's wall, nvcc start to exit


def reset_builds():
    """Zero the per-process build counts and walls."""
    BUILDS.clear()
    BUILD_WALL_S.clear()


def nvcc():
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    PATH, or ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path(DEFAULT_NVCC))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source on first use"
    )


def _flags(defines):
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name, defines=()):
    """Where the built library of ``csrc/<name>.cu`` lives; the key also
    hashes the headers beside it (``csrc/*.cuh``), which a source may
    include, and the macros ``defines`` it is built with."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(compiler, name, out, defines):
    """Start nvcc for ``name``, its output into a temporary file (so a
    chatty build never blocks on a full pipe); -> (Popen, tmp, out, log)."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def build_all(names, timeout=600, defines=()):
    """Build every named kernel that is not built yet, all ``nvcc``
    processes at once, with the macros ``defines``; returns ``{name: nvcc
    output}`` for those built, and notes each build's wall (start to
    exit) in ``BUILD_WALL_S``."""
    todo = {n: library_path(n, defines) for n in names}
    todo = {n: out for n, out in todo.items() if not out.exists()}
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    logs = {}
    failed = []
    try:
        t0 = time.perf_counter()
        for name, out in todo.items():
            started[name] = _start(compiler, name, out, defines)
        running = set(started)
        while running:
            for name in sorted(running):
                if started[name][0].poll() is not None:
                    BUILD_WALL_S[name] = time.perf_counter() - t0
                    running.discard(name)
            if running:
                if time.perf_counter() - t0 > timeout:
                    raise RuntimeError(f"nvcc did not finish {sorted(running)} within {timeout} s")
                time.sleep(0.005)
        for name, (proc, tmp, out, log) in started.items():
            log.seek(0)
            logs[name] = log.read().decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
                continue
            BUILDS[name] = BUILDS.get(name, 0) + 1
            os.replace(tmp, out)  # atomic: a reader never sees a torn .so
    finally:
        for proc, tmp, _, log in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def install_library(stem, data):
    """Write a built library's bytes to ``BUILD_DIR/<stem>.so`` atomically
    (the checkpoint writer's mkstemp -> fsync -> rename), unless that file
    exists. ``stem`` is ``library_path(name).stem``, which hashes the
    source, headers and flags, so the bytes can only land where a build of
    the same source would. Returns True when it wrote the file."""
    from shallowspeed_tpu_torch.checkpoint import atomic_write

    out = BUILD_DIR / f"{stem}.so"
    if out.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    atomic_write(out, lambda f: f.write(data), suffix=".so.tmp")
    return True


def load(name, defines=()):
    """The ctypes library of ``csrc/<name>.cu``, built on first use (with the
    macros ``defines``: a profiling build beside the plain one)."""
    lib = _LIBS.get((name, defines))
    if lib is None:
        build_all([name], defines=defines)
        lib = ctypes.CDLL(str(library_path(name, defines)))
        _LIBS[name, defines] = lib
    return lib
