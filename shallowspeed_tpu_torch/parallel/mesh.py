"""The virtual ``(dp, pp[, tp])`` mesh: the port's counterpart of
``shallowspeed_tpu/parallel/mesh.py``.

The JAX package lays its ``('dp', 'pp')`` axes, and at ``tp > 1`` a third
``'tp'`` axis, over real devices with a ``jax.sharding.Mesh``. The port's
lockstep executor keeps every virtual rank ``(d, s, t)`` of the grid on ONE
``torch.device``: rows are model replicas, columns are pipeline stages and
the innermost axis the Megatron tensor-parallel ranks of one stage, exactly
as the JAX mesh names them, and the executor's relay, dp sum and tp sums
move data between ranks' buffers on that device. At ``tp == 1`` the mesh is
the two-axis grid (``shape`` names no ``tp`` axis), as in the JAX package.
The MPMD runtime (``parallel/mpmd.py``) keeps this shape and the one
device, issuing each pipeline stage on its own CUDA stream.

``ProcessMesh`` is the same ``(dp, pp)`` grid laid over several processes,
the layout of the multi-process runtime (``parallel/multihost.py``, which
attaches the process groups): ranks in the JAX package's order (devices
sorted by ``(process_index, id)``, flat rank ``d*pp + s``), each process
owning ``dp*pp / world`` consecutive ranks, so a process owns one block of
stages of one dp row, or whole dp rows. It holds only those stages' rows
of the stacked params, and the executor runs only its own ranks; a data
mover whose ends sit in two processes becomes a ``torch.distributed``
collective. This module keeps the layout only (host arithmetic).
"""

import dataclasses

import torch

from shallowspeed_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """``dp`` replicas x ``pp`` stages x ``tp`` tensor-parallel ranks, all
    on ``device`` (None = ``"cuda"``, through ``resolve_device``: a missing
    GPU raises, pass ``"cpu"`` for the plain path)."""

    dp: int
    pp: int
    device: torch.device | str | None = None
    tp: int = 1

    def __post_init__(self):
        if isinstance(self.tp, int) and self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        for name in ("dp", "pp", "tp"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self):
        """``{"dp": dp, "pp": pp}``, plus ``"tp"`` when ``tp > 1``, as
        ``jax.sharding.Mesh.shape`` names the JAX package's mesh."""
        if self.tp > 1:
            return {"dp": self.dp, "pp": self.pp, "tp": self.tp}
        return {"dp": self.dp, "pp": self.pp}


def mesh_tp(mesh) -> int:
    """The mesh's tensor-parallel degree: the size of its ``tp`` axis, 1
    when the axis is absent. The one accessor the executor, the planners
    and the session use (``mesh.mesh_tp``)."""
    return int(dict(mesh.shape).get("tp", 1))


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A ``(dp, pp)`` mesh laid over ``world`` processes; this process is
    ``process`` (its index among the mesh's processes). ``processes``: the
    ``torch.distributed`` ranks of the mesh's processes in process-index
    order (None = ``0 .. world-1``). ``comm``: the process groups and the
    transport (``multihost.make_process_mesh`` attaches them; None for a
    layout that only computes rows). ``device``: as ``VirtualMesh``'s.

    Process ``q`` owns flat ranks ``[q*n, (q+1)*n)``, ``n = dp*pp/world``
    (``flat = d*pp + s``): with ``n <= pp`` (``pp % n == 0``) a block of
    ``n`` stages of one dp row, else whole dp rows (``n % pp == 0``).
    Anything else, and ``tp > 1``, is refused."""

    dp: int
    pp: int
    world: int
    process: int
    device: torch.device | str | None = None
    tp: int = 1
    processes: tuple | None = None
    comm: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        for name in ("dp", "pp", "world"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if self.tp != 1:
            raise ValueError(
                f"tp={self.tp} on a process mesh: the multi-process runtime "
                "runs dp x pp only (the Megatron sums across processes are "
                "ROADMAP item 7b); run tp > 1 on a VirtualMesh"
            )
        if not 0 <= self.process < self.world:
            raise ValueError(f"process {self.process} is not in 0..{self.world - 1}")
        ranks = self.dp * self.pp
        if ranks % self.world:
            raise ValueError(
                f"{ranks} ranks (dp={self.dp} x pp={self.pp}) do not split over "
                f"{self.world} processes"
            )
        n = ranks // self.world
        if not (self.pp % n == 0 if n <= self.pp else n % self.pp == 0):
            raise ValueError(
                f"{n} ranks a process over pp={self.pp}: a process must own a "
                "block of stages of one dp row (n divides pp) or whole dp rows "
                "(pp divides n)"
            )
        procs = tuple(range(self.world)) if self.processes is None else tuple(self.processes)
        if len(procs) != self.world or list(procs) != sorted(set(procs)):
            raise ValueError(f"processes {procs} are not {self.world} ascending distinct ranks")
        object.__setattr__(self, "processes", procs)
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self):
        return {"dp": self.dp, "pp": self.pp}

    @property
    def ranks_per_process(self):
        return self.dp * self.pp // self.world

    def block(self, q=None):
        """``(dp rows, stages)`` of process ``q`` (this one by default):
        two ranges."""
        q = self.process if q is None else q
        n = self.ranks_per_process
        if n <= self.pp:
            d, b = divmod(q, self.pp // n)
            return range(d, d + 1), range(b * n, (b + 1) * n)
        dl = n // self.pp
        return range(q * dl, (q + 1) * dl), range(self.pp)

    @property
    def local_dp(self):
        """This process's dp rows (a range)."""
        return self.block()[0]

    @property
    def local_stages(self):
        """This process's pipeline stages (a range)."""
        return self.block()[1]

    def owner(self, d, s):
        """The process index that owns rank ``(d, s)``."""
        return (d * self.pp + s) // self.ranks_per_process

    def dp_peers(self, q=None):
        """``q``'s dp group: the process indices holding its stages, in dp
        order."""
        stages = self.block(q)[1]
        return tuple(p for p in range(self.world) if self.block(p)[1] == stages)

    def pp_peers(self, q=None):
        """``q``'s pp group: the process indices holding its dp rows, in
        stage order (``q`` alone when it owns every stage)."""
        rows = self.block(q)[0]
        return tuple(p for p in range(self.world) if self.block(p)[0] == rows)

    def groups(self):
        """Every process group the runtime talks over, in one order every
        process computes alike: ``("mesh", all)``, then each dp group and
        each pp group of two or more processes."""
        out = [("mesh", tuple(range(self.world)))]
        for kind, peers in (("dp", self.dp_peers), ("pp", self.pp_peers)):
            for g in sorted({peers(q) for q in range(self.world)}):
                if len(g) > 1:
                    out.append((kind, g))
        return out

