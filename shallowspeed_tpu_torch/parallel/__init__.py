"""The pipeline execution layer of the port.

- ``lowering``  the JAX package's schedule -> clock-tick compiler, copied:
                numpy tables indexed [tick, stage];
- ``mesh``      the virtual ``(dp, pp)`` mesh and the one device it lives on;
- ``executor``  the lockstep tick interpreter over zero-padded stacked stage
                parameters: every virtual rank runs its table cell, payloads
                move between neighbouring ranks' mailboxes, and the dp
                gradient sum runs in a fixed order before the optimizer;
                ZeRO stages 1-3 shard the state, gradients and params;
- ``mpmd``      the MPMD runtime: the same stage functions issued per stage
                from the tick tables, one CUDA stream a stage, relays
                ordered by events (bitwise the lockstep weights);
- ``gradsync``  the bucketed gradient sync: the JAX package's bucket plans
                and comms contract (one device runs the anchor sum).
"""

from shallowspeed_tpu_torch.parallel.lowering import TickProgram, lower_schedule
from shallowspeed_tpu_torch.parallel.mesh import VirtualMesh

__all__ = ["TickProgram", "VirtualMesh", "lower_schedule"]
