"""Inference serving for the port: the counterpart of
``shallowspeed_tpu/serving`` for one process on one card.

- ``slots``          the shared dispatch geometry: fixed ``slot_rows``-row
                     slots + the ladder of slot counts per dispatch;
- ``engine``         ``ServingEngine``: deadline-tagged FIFO queue,
                     continuous batching into the session's slot forwards
                     (the CUDA forward kernel on the sequential layout),
                     per-request accounting and the JAX engine's records
                     (``request``/``serving``/``serving_health``/``reload``,
                     ``trace`` span chains, ``rollup``/``alert`` live
                     telemetry), and the graceful-degradation layer
                     (dispatch recovery with a bounded retry budget,
                     deadline shedding, health-gated responses, a
                     consecutive-failure breaker, hot weight reload, chaos
                     faults at ``@dispatch=N`` anchors);
- ``loadgen``        seeded Poisson arrivals, open-loop (coordinated-
                     omission-corrected) and closed-loop drive loops, each with
                     the graceful-drain ``should_stop`` hook — the drive loops
                     duck-type over an engine OR a fleet;
- ``router``         fleet routing as pure logic: replica health state
                     (heartbeat-fed), the bounded fleet queue,
                     least-queue-depth / power-of-two-choices placement, the
                     quorum rule;
- ``fleet``          ``ServingFleet``: N engine replicas as spawned worker
                     processes (on a card they share it, each with its own
                     CUDA context) behind the router — heartbeats, failover
                     requeue-at-head, ``scale_up``/``scale_down``/
                     ``watch_reload``, ``fleet``/``fleet_health`` records and
                     per-replica ``.r{id}`` JSONL shards;
- ``replay``         the seeded diurnal trace (Lewis-Shedler thinning);
- ``autoscaler``     ``AutoscalePolicy``: the closed-loop scaling policy over
                     the fleet's alert edges and ``status()`` snapshots;
- ``bench_serving``  the offered-load sweep (p50/p99, goodput, queue depth,
                     padding waste, the saturation knee), the seeded chaos
                     soak and the fleet chaos soak, one versioned JSON record
                     each;
- ``bench_replay``   the capacity scoreboard: one diurnal trace replayed on
                     a static, an autoscaled and a chaos fleet, scored
                     against the offline oracle;
- ``__main__``       the serve entry point
                     (``python -m shallowspeed_tpu_torch.serving``) on every
                     layout, in one process or as a fleet (``--fleet N``):
                     checkpoint -> engine(s) -> seeded load, with ``--verify``
                     bitwise parity, ``--faults`` chaos and SIGTERM/SIGINT
                     graceful drain.
"""

from shallowspeed_tpu_torch.serving.engine import Request, ServingEngine
from shallowspeed_tpu_torch.serving.fleet import (
    FleetError,
    ServingFleet,
    fleet_workers_supported,
)
from shallowspeed_tpu_torch.serving.router import FleetRequest, Router
from shallowspeed_tpu_torch.serving.slots import (
    DEFAULT_SLOT_LADDER,
    DEFAULT_SLOT_ROWS,
    pack_slots,
    rung_for,
    slots_needed,
    unpack_slots,
)

__all__ = [
    "DEFAULT_SLOT_LADDER",
    "DEFAULT_SLOT_ROWS",
    "FleetError",
    "FleetRequest",
    "Request",
    "Router",
    "ServingEngine",
    "ServingFleet",
    "fleet_workers_supported",
    "pack_slots",
    "rung_for",
    "slots_needed",
    "unpack_slots",
]
