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

``ProcessMesh`` is the same ``(dp, pp[, tp])`` grid laid over several
processes, the layout of the multi-process runtime (``parallel/
multihost.py``, which attaches the process groups): ranks in the JAX
package's order (devices sorted by ``(process_index, id)``, flat rank
``(d*pp + s)*tp + t``, tp innermost), each process owning
``dp*pp*tp / world`` consecutive ranks, so a process owns a block of tp
ranks of one ``(d, s)`` position, or whole tp groups of one block of
stages of one dp row, or whole dp rows. It holds only those stages' rows
of the stacked params and, at tp > 1, only its tp ranks' bands of them;
the executor runs only its own ranks, and a data mover whose ends sit in
two processes becomes a ``torch.distributed`` collective. This module
keeps the layout only (host arithmetic).
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
    """A ``(dp, pp[, tp])`` mesh laid over ``world`` processes; this process
    is ``process`` (its index among the mesh's processes). ``processes``:
    the ``torch.distributed`` ranks of the mesh's processes in
    process-index order (None = ``0 .. world-1``). ``comm``: the process
    groups and the transport (``multihost.make_process_mesh`` attaches
    them; None for a layout that only computes rows). ``device``: as
    ``VirtualMesh``'s.

    Process ``q`` owns flat ranks ``[q*n, (q+1)*n)``, ``n =
    dp*pp*tp/world`` (``flat = (d*pp + s)*tp + t``, the JAX device order):
    with ``n <= tp`` (``tp % n == 0``) a block of ``n`` tp ranks of one
    ``(d, s)``, so tp crosses processes; else whole tp groups (``n % tp ==
    0``) of ``m = n/tp`` positions, which with ``m <= pp`` (``pp % m ==
    0``) are a block of ``m`` stages of one dp row, else whole dp rows
    (``m % pp == 0``). Anything else is refused. At tp = 1 this is the
    ``(dp, pp)`` layout: ``n`` stages of one row or whole rows."""

    dp: int
    pp: int
    world: int
    process: int
    device: torch.device | str | None = None
    tp: int = 1
    processes: tuple | None = None
    comm: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        for name in ("dp", "pp", "tp", "world"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not 0 <= self.process < self.world:
            raise ValueError(f"process {self.process} is not in 0..{self.world - 1}")
        ranks = self.dp * self.pp * self.tp
        if ranks % self.world:
            axes = f"dp={self.dp} x pp={self.pp}" + (f" x tp={self.tp}" if self.tp > 1 else "")
            raise ValueError(
                f"{ranks} ranks ({axes}) do not split over {self.world} processes"
            )
        n = ranks // self.world
        if self.tp % n and n % self.tp:
            raise ValueError(
                f"{n} ranks a process over tp={self.tp}: a process must own a "
                "block of tp ranks of one (dp, pp) position (n divides tp) or "
                "whole tp groups (tp divides n)"
            )
        m = n // self.tp
        if self.tp % n and not (self.pp % m == 0 if m <= self.pp else m % self.pp == 0):
            raise ValueError(
                f"{m} (dp, pp) positions a process over pp={self.pp}: a process "
                "must own a block of stages of one dp row (n divides pp) or "
                "whole dp rows (pp divides n)"
            )
        procs = tuple(range(self.world)) if self.processes is None else tuple(self.processes)
        if len(procs) != self.world or list(procs) != sorted(set(procs)):
            raise ValueError(f"processes {procs} are not {self.world} ascending distinct ranks")
        object.__setattr__(self, "processes", procs)
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self):
        """As ``VirtualMesh.shape``: a ``tp`` axis only when ``tp > 1``."""
        if self.tp > 1:
            return {"dp": self.dp, "pp": self.pp, "tp": self.tp}
        return {"dp": self.dp, "pp": self.pp}

    @property
    def ranks_per_process(self):
        return self.dp * self.pp * self.tp // self.world

    def ranks(self, q=None):
        """``(dp rows, stages, tp ranks)`` of process ``q`` (this one by
        default): three ranges."""
        q = self.process if q is None else q
        n = self.ranks_per_process
        if self.tp % n == 0:
            k = self.tp // n  # processes a (d, s) position
            d, s = divmod(q // k, self.pp)
            t = (q % k) * n
            return range(d, d + 1), range(s, s + 1), range(t, t + n)
        m = n // self.tp
        if m <= self.pp:
            d, b = divmod(q, self.pp // m)
            return range(d, d + 1), range(b * m, (b + 1) * m), range(self.tp)
        dl = m // self.pp
        return range(q * dl, (q + 1) * dl), range(self.pp), range(self.tp)

    def block(self, q=None):
        """``(dp rows, stages)`` of process ``q`` (this one by default):
        two ranges."""
        return self.ranks(q)[:2]

    @property
    def local_dp(self):
        """This process's dp rows (a range)."""
        return self.ranks()[0]

    @property
    def local_stages(self):
        """This process's pipeline stages (a range)."""
        return self.ranks()[1]

    @property
    def local_tp(self):
        """This process's tp ranks (a range; ``range(1)`` at tp = 1)."""
        return self.ranks()[2]

    def device_rows_of(self, q=None):
        """Process ``q``'s rows (this one's by default) of the ZeRO layouts'
        ``(pp*tp, ...)`` device rows (pp-major, tp-minor): a range, since a
        process owns either one stage's block of tp ranks or whole tp
        groups."""
        _, s, t = self.ranks(q)
        a = s.start * self.tp + t.start
        return range(a, a + len(s) * len(t))

    @property
    def device_rows(self):
        """This process's rows of the ZeRO layouts' device rows."""
        return self.device_rows_of()

    def owner(self, d, s, t=0):
        """The process index that owns rank ``(d, s, t)``."""
        return ((d * self.pp + s) * self.tp + t) // self.ranks_per_process

    def _peers(self, q, same):
        """The process indices whose ranges agree with ``q``'s at the
        ``same`` positions of ``ranks`` (0 dp, 1 pp, 2 tp), in process
        order."""
        mine = self.ranks(q)
        return tuple(p for p in range(self.world)
                     if all(self.ranks(p)[i] == mine[i] for i in same))

    def dp_peers(self, q=None):
        """``q``'s dp group: the process indices holding its stages and tp
        ranks, in dp order."""
        return self._peers(q, (1, 2))

    def pp_peers(self, q=None):
        """``q``'s pp group: the process indices holding its dp rows and tp
        ranks, in stage order (``q`` alone when it owns every stage)."""
        return self._peers(q, (0, 2))

    def tp_peers(self, q=None):
        """``q``'s tp group: the process indices holding its dp rows and
        stages, in tp order (``q`` alone when it owns every tp rank)."""
        return self._peers(q, (0, 1))

    def groups(self):
        """Every process group the runtime talks over, in one order every
        process computes alike: ``("mesh", all)``, then each dp group, each
        pp group and each tp group of two or more processes."""
        out = [("mesh", tuple(range(self.world)))]
        for kind, peers in (("dp", self.dp_peers), ("pp", self.pp_peers),
                            ("tp", self.tp_peers)):
            for g in sorted({peers(q) for q in range(self.world)}):
                if len(g) > 1:
                    out.append((kind, g))
        return out
