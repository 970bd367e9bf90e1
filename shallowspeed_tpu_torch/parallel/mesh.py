"""The virtual ``(dp, pp)`` mesh: the port's counterpart of
``shallowspeed_tpu/parallel/mesh.py``.

The JAX package lays its ``('dp', 'pp')`` axes over real devices with a
``jax.sharding.Mesh``. The port's lockstep executor keeps every virtual
rank ``(d, s)`` of the grid on ONE ``torch.device``: rows are model
replicas, columns are pipeline stages, exactly as the JAX mesh names them,
and the executor's relay and dp sum move data between ranks' buffers on
that device. The multi-card runtime (one process per rank over
``torch.distributed``) replaces the two data movers and keeps this shape.
"""

import dataclasses

import torch

from shallowspeed_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """``dp`` replicas x ``pp`` stages, all on ``device`` (None = ``"cuda"``,
    through ``resolve_device``: a missing GPU raises, pass ``"cpu"`` for the
    plain path)."""

    dp: int
    pp: int
    device: torch.device | str | None = None

    def __post_init__(self):
        for name in ("dp", "pp"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self):
        """``{"dp": dp, "pp": pp}``, as ``jax.sharding.Mesh.shape`` names it."""
        return {"dp": self.dp, "pp": self.pp}
