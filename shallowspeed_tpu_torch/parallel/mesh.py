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
The multi-card runtime (one process per rank over ``torch.distributed``)
replaces the data movers and keeps this shape.
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
