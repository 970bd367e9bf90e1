"""The pipeline execution layer of the port.

- ``lowering``  the JAX package's schedule -> clock-tick compiler, copied:
                numpy tables indexed [tick, stage];
- ``mesh``      the virtual ``(dp, pp[, tp])`` mesh and the one device it
                lives on, and ``ProcessMesh``, the same grid laid over
                processes;
- ``executor``  the lockstep tick interpreter over zero-padded stacked stage
                parameters: every virtual rank runs its table cell, payloads
                move between neighbouring ranks' mailboxes, and the dp
                gradient sum runs in a fixed order before the optimizer;
                ZeRO stages 1-3 shard the state, gradients and params;
- ``mpmd``      the MPMD runtime: the same stage functions issued per stage
                from the tick tables, one CUDA stream a stage, relays
                ordered by events (bitwise the lockstep weights);
- ``gradsync``  the bucketed gradient sync: the JAX package's bucket plans
                and comms contract, and on a process mesh its emitters (one
                collective a bucket; one device runs the anchor sum);
- ``multihost`` the multi-process runtime: ``torch.distributed`` groups, the
                process mesh's collectives, each process's share of the
                batch and the params.
"""

from shallowspeed_tpu_torch.parallel import multihost
from shallowspeed_tpu_torch.parallel.lowering import TickProgram, lower_schedule
from shallowspeed_tpu_torch.parallel.mesh import ProcessMesh, VirtualMesh

__all__ = ["ProcessMesh", "TickProgram", "VirtualMesh", "lower_schedule", "multihost"]
