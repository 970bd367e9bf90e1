"""The multi-process runtime: the port's counterpart of
``shallowspeed_tpu/parallel/multihost.py``.

The reference trains over several MPI processes (``mpirun -n N``): dp
replicas all-reduce their gradients, pipeline stages pass activations, and
a SHA1 check proves the replicas hold the same weights. The JAX package
does that with ``jax.distributed.initialize`` and a mesh over every
process's devices, driven by the same executor. Here
``torch.distributed`` forms the process group, ``make_process_mesh`` lays
the executor's ``(dp, pp[, tp])`` ranks over the processes
(``parallel/mesh.ProcessMesh``: the JAX order, tp innermost, each process
owning ``dp*pp*tp / world`` consecutive ranks and only their stages' rows
of the stacked params, at tp > 1 only their tp ranks' bands), and the
lockstep executor runs each process's own ranks, with every data mover
whose ends sit in two processes a real collective through
``ProcessComm``: relays ``send``/``recv`` (a tick's in one
``batch_isend_irecv``), the dp sum ``all_reduce``, ZeRO-1's and bucketed
ZeRO-2's sum ``reduce_scatter_tensor`` and their gather
``all_gather_into_tensor``, ZeRO-2's and ZeRO-3's per-tick
``reduce_scatter_tensor`` and ZeRO-3's per-tick parameter
``all_gather_into_tensor`` over the dp group, the Megatron sums an
``all_reduce`` over the tp group, the loss and the inference head's
predictions a ``broadcast`` from the head stage's process, the global
norm an ``all_reduce`` of per-process squares, the digest grids an
``all_reduce`` of zero grids each process filled at its rows, and the
fused run's eval an ``all_reduce`` of the correct predictions' count.

Backends: ``"nccl"`` (the default on ``cuda``) puts one rank on one GPU
and is refused, in plain words, when processes would share a card;
``"gloo"`` (the default on the CPU) runs anywhere, and on a shared card
every payload is staged through a pinned host buffer, explicitly and
counted (``ProcessComm.stats``), since gloo's CUDA paths are partial. The
NCCL path is written but has run on no machine with two cards.

Typical launch (the same script in every process)::

    from shallowspeed_tpu_torch.parallel import multihost
    multihost.initialize("localhost:29500", num_processes=2, process_id=rank,
                         backend="gloo", device="cpu")
    mesh = multihost.make_process_mesh(2, 2, device="cpu")
    stacked, flags = executor.init_stacked(spec, mesh)   # this process's rows
    x = multihost.shard_batch_for_process(X, mesh, ("dp",))
    step = executor.make_pipeline_step(mesh, spec, prog, mb, opt)

Refused on a process mesh (ROADMAP item 7b), each with a ``ValueError``
before any collective: the MPMD runtime, and ``TrainingSession`` and the
CLIs. The JAX executor's own refusals hold there as on one process
(``kernel_backend="pallas"`` at zero 3 and at tp > 1).
"""

import dataclasses
import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from shallowspeed_tpu_torch import resolve_device, retry
from shallowspeed_tpu_torch.parallel.mesh import ProcessMesh

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300.0  # every collective's and the join's bound
_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_sleep = time.sleep  # the join retry's sleep (patchable)
_GROUPS = {}  # torch.distributed ranks -> process group, made once each
_TIMEOUT = [DEFAULT_TIMEOUT_S]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group (0 when none is up)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The process group's size (1 when none is up)."""
    return dist.get_world_size() if is_initialized() else 1


def shutdown():
    """Leave the process group (a no-op when none is up)."""
    if is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()


def check_backend(backend, device, num_processes, n_gpus):
    """The backend for ``num_processes`` processes on ``device`` with
    ``n_gpus`` visible cards: ``backend``, or the default (``"nccl"`` on
    ``cuda``, ``"gloo"`` on the CPU). NCCL puts one rank on one GPU, so it
    is refused on the CPU and when the processes outnumber the cards."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' needs CUDA devices; use backend='gloo' on the CPU")
        if num_processes > n_gpus:
            raise ValueError(
                f"backend='nccl' puts one process on one GPU, but {num_processes} "
                f"processes would share {n_gpus} visible GPU(s); pass "
                "backend='gloo' to share a card"
            )
    return backend


def _reset_half_initialized_state():
    """Tear a half-made process group down after a failed join, so a retry
    starts clean (``destroy_process_group`` when one is registered)."""
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except (RuntimeError, ValueError) as e:
        log.debug("destroy_process_group() failed (%s: %s)", type(e).__name__, e)
    _GROUPS.clear()


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device=None, timeout_s=DEFAULT_TIMEOUT_S):
    """Join the process group (the JAX function's semantics). A no-op when
    a group is already up. With no coordinator, the environment's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` form it
    (``init_method="env://"``); with none of them set it is a logged
    single-process no-op. An explicit ``coordinator_address``
    (``host:port``, or a URL) with ``num_processes`` and ``process_id``
    joins over ``tcp://``, retried with the shared backoff (4 attempts,
    base 0.5 s, at most 10 s) on ``RuntimeError``/``ConnectionError``/
    ``OSError``, a half-made group torn down before each retry; a
    coordinator that never answers raises. ``device`` (None = ``"cuda"``,
    through ``resolve_device``) picks the default backend
    (``check_backend``); ``timeout_s`` bounds the join and every
    collective."""
    if is_initialized():
        return
    if coordinator_address is None:
        if not all(os.environ.get(k) for k in _ENV_KEYS):
            log.info(
                "torch.distributed.init_process_group skipped (no coordinator "
                "and no %s in the environment); running single-process",
                "/".join(_ENV_KEYS),
            )
            return
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        addr = str(coordinator_address)
        init_method = addr if "://" in addr else f"tcp://{addr}"
        world, rank = int(num_processes), int(process_id)
    dev = resolve_device(device)
    backend = check_backend(
        backend, dev, world, torch.cuda.device_count() if dev.type == "cuda" else 0
    )
    _TIMEOUT[0] = float(timeout_s)
    kwargs = dict(
        backend=backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    if coordinator_address is None:
        dist.init_process_group(**kwargs)
        return

    def _join_once():
        try:
            dist.init_process_group(**kwargs)
        except BaseException:
            _reset_half_initialized_state()
            raise

    retry.retry_call(
        _join_once, attempts=4, base=0.5, max_delay=10.0,
        retry_on=(RuntimeError, ConnectionError, OSError),
        sleep=lambda d: _sleep(d),
    )


def _group(ranks):
    """The process group of ``ranks`` (None for one process), made once;
    every process of the group's world makes the same groups in the same
    order (``new_group`` is collective)."""
    ranks = tuple(ranks)
    if len(ranks) < 2:
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(
            list(ranks), timeout=datetime.timedelta(seconds=_TIMEOUT[0])
        )
    return _GROUPS[ranks]


def make_process_mesh(dp, pp, tp=1, device=None, processes=None):
    """The ``(dp, pp[, tp])`` process mesh over ``processes`` (``torch.distributed``
    ranks; None = every process), with its groups and transport attached.
    Every process of the group calls it with the same arguments (the groups
    are made collectively); a process outside ``processes`` gets None.
    Without a process group it is the world-1 mesh, which owns every rank
    and runs the executor's in-memory movers only (bitwise the
    ``VirtualMesh``)."""
    world = process_count()
    procs = tuple(range(world)) if processes is None else tuple(int(p) for p in processes)
    me = process_index()
    layout = ProcessMesh(dp, pp, len(procs), procs.index(me) if me in procs else 0,
                         device, tp=tp, processes=procs)
    groups = {
        (kind, g): _group(procs[q] for q in g) for kind, g in layout.groups()
    }
    if me not in procs:
        return None
    backend = dist.get_backend() if is_initialized() else "gloo"
    comm = ProcessComm(layout, groups, backend)
    return dataclasses.replace(layout, comm=comm)


class ProcessComm:
    """The collectives of one process on a ``ProcessMesh``: over its dp
    group (the processes holding its stages and tp ranks), its pp group
    (holding its dp rows and tp ranks), its tp group (holding its dp rows
    and stages) and the whole mesh; a group of one process moves nothing. On a
    ``cuda`` device under gloo every payload goes through a pinned host
    buffer and back (``staging``). ``stats``: staged bytes and copies, the
    staging copies' and the collectives' host seconds, collectives issued,
    point-to-point sends and receives."""

    def __init__(self, layout, groups, backend):
        self.layout = layout
        self.backend = backend
        self.device = layout.device
        self.groups = {
            "mesh": groups.get(("mesh", tuple(range(layout.world)))),
            "dp": groups.get(("dp", layout.dp_peers())),
            "pp": groups.get(("pp", layout.pp_peers())),
            "tp": groups.get(("tp", layout.tp_peers())),
        }
        self.staging = self.device.type == "cuda" and backend == "gloo"
        self.reset_stats()

    def reset_stats(self):
        self.stats = dict(staged_bytes=0, staged_copies=0, staging_s=0.0,
                          collectives=0, collective_s=0.0, sends=0, recvs=0)

    def size(self, axis):
        """The number of processes on ``axis`` (``"dp"``, ``"pp"``,
        ``"tp"``, ``"mesh"``)."""
        g = self.groups[axis]
        return 1 if g is None else dist.get_world_size(g)

    def _timeout(self):
        return datetime.timedelta(seconds=_TIMEOUT[0])

    def _out(self, t):
        """A payload as the transport takes it: contiguous, and on a shared
        card copied into a pinned host buffer."""
        if not self.staging:
            return t.contiguous()
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self._staged(host, t0)
        return host

    def _buffer(self, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, pin_memory=self.staging,
                           device="cpu" if self.staging else self.device)

    def _in(self, host):
        """A received payload back on the device (the staging read-back)."""
        if not self.staging:
            return host
        t0 = time.perf_counter()
        t = host.to(self.device)
        self._staged(host, t0)
        return t

    def _staged(self, host, t0):
        self.stats["staged_bytes"] += host.numel() * host.element_size()
        self.stats["staged_copies"] += 1
        self.stats["staging_s"] += time.perf_counter() - t0

    def _run(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.stats["collectives"] += 1
        self.stats["collective_s"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t, axis):
        """The sum of ``t`` over ``axis``'s processes (a new tensor or ``t``
        itself, summed in place)."""
        g = self.groups[axis]
        if g is None:
            return t
        h = self._out(t)
        self._run(lambda: dist.all_reduce(h, group=g))
        return self._in(h)

    def reduce_scatter(self, t, axis="dp"):
        """``t``: ``(G, ...)``, block ``i`` for the ``i``-th process of
        ``axis``; returns this process's block of the sum over the
        processes."""
        g = self.groups[axis]
        if g is None:
            return t[0]
        h = self._out(t).reshape(-1)
        out = self._buffer((h.numel() // t.shape[0],), t.dtype)
        self._run(lambda: dist.reduce_scatter_tensor(out, h, group=g))
        return self._in(out).view(t.shape[1:])

    def all_gather(self, t, axis="dp"):
        """``(G,) + t.shape``: every process's ``t`` on ``axis``, in
        process order."""
        g = self.groups[axis]
        if g is None:
            return t.unsqueeze(0)
        h = self._out(t).reshape(-1)
        out = self._buffer((self.size(axis) * h.numel(),), t.dtype)
        self._run(lambda: dist.all_gather_into_tensor(out, h, group=g))
        return self._in(out).view((self.size(axis),) + tuple(t.shape))

    def broadcast(self, t, src, axis="pp"):
        """Process ``src``'s (a mesh process index) ``t`` on every process of
        ``axis``; the others pass a tensor of the same shape."""
        g = self.groups[axis]
        if g is None:
            return t
        h = self._out(t)
        root = self.layout.processes[src]
        self._run(lambda: dist.broadcast(h, src=root, group=g))
        return self._in(h)

    def exchange(self, sends, recvs):
        """One tick's point-to-point traffic in one ``batch_isend_irecv``:
        ``sends`` ``[(process, tag, tensor)]``, ``recvs`` ``[(process, tag,
        shape)]`` (mesh process indices; every process builds both lists
        from the same tick tables, so tags pair up). Returns the received
        tensors, in ``recvs`` order, on the device."""
        procs = self.layout.processes
        ops, bufs = [], []
        for q, tag, t in sends:
            ops.append(dist.P2POp(dist.isend, self._out(t), procs[q], tag=tag))
        for q, tag, shape in recvs:
            buf = self._buffer(shape)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, procs[q], tag=tag))
        if ops:
            def run():
                for req in dist.batch_isend_irecv(ops):
                    req.wait(self._timeout())
            self._run(run)
        self.stats["sends"] += len(sends)
        self.stats["recvs"] += len(recvs)
        return [self._in(b) for b in bufs]

    def all_gather_object(self, obj, axis="mesh"):
        """Every process's ``obj`` on ``axis``, in process order."""
        g = self.groups[axis]
        if g is None:
            return [obj]
        out = [None] * self.size(axis)
        self._run(lambda: dist.all_gather_object(out, obj, group=g))
        return out


# ---------------------------------------------------------------------------
# This process's share of the data and the params
# ---------------------------------------------------------------------------


def _spec_axes(spec):
    """A partition spec (``("dp",)``, ``"dp"``, ``()``/None, or the JAX
    package's ``PartitionSpec``, a tuple) as a tuple of axis names."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def batch_rows(n_rows, mesh, spec):
    """The global row range of this process's part of an ``n_rows`` array
    laid out by ``spec``: its dp rows' contiguous blocks for ``P('dp')``
    (``n_rows / dp`` a replica), every row for ``P()``."""
    axes = _spec_axes(spec)
    if not axes or axes[0] is None:
        return range(n_rows)
    if axes[0] != "dp" or any(a is not None for a in axes[1:]):
        raise ValueError(f"partition spec {spec!r}: only ('dp',) and () are laid out")
    if n_rows % mesh.dp:
        raise ValueError(f"{n_rows} rows do not split over dp={mesh.dp}")
    per = n_rows // mesh.dp
    d = mesh.local_dp
    return range(d.start * per, d.stop * per)


def shard_batch_for_process(x, mesh, spec):
    """This process's rows of the global batch ``x`` (host numpy or a
    tensor) laid out by ``spec`` (``("dp",)``: its dp rows; ``()``: all of
    it, replicated), placed on the mesh's device: the counterpart of
    ``jax.make_array_from_process_local_data``, which takes the rows this
    returns."""
    rows = batch_rows(int(x.shape[0]), mesh, spec)
    part = x[rows.start:rows.stop]
    if isinstance(part, torch.Tensor):
        return part.to(mesh.device)
    return torch.from_numpy(np.ascontiguousarray(part)).to(mesh.device)


def stage_rows(mesh, num_chunks=1):
    """The stacked rows this process holds: ``num_chunks`` (V) rows a
    local stage, device-major as ``interleave_order`` lays them."""
    s = mesh.local_stages
    return range(s.start * num_chunks, s.stop * num_chunks)


def gather_stacked(stacked, mesh, num_chunks=1, spec=None):
    """The full stacked ``{W, b}`` tree (host numpy) on every process,
    rebuilt from every process's share (one ``all_gather_object``; the
    executor's ``stacked_from_shares``): its rows and, at tp > 1, its tp
    ranks' bands, or ZeRO-3's params at rest (``{"P": ...}``, its shard),
    which needs the model's ``spec``. What ``model_hash`` reads."""
    from shallowspeed_tpu_torch.parallel.executor import stacked_from_shares

    mine = {k: [a.detach().cpu().numpy() for a in v] if k != "P" else v.detach().cpu().numpy()
            for k, v in stacked.items()}
    shares = mesh.comm.all_gather_object(mine) if mesh.comm is not None else [mine]
    return stacked_from_shares(shares, mesh, num_chunks, spec)
