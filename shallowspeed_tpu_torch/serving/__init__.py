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
                     the graceful-drain ``should_stop`` hook;
- ``bench_serving``  the offered-load sweep (p50/p99, goodput, queue depth,
                     padding waste, the saturation knee) and the seeded
                     chaos soak, one versioned JSON record each;
- ``__main__``       the serve entry point
                     (``python -m shallowspeed_tpu_torch.serving``) on every
                     layout: checkpoint -> engine -> seeded load, with
                     ``--verify`` bitwise parity, ``--faults`` chaos and
                     SIGTERM/SIGINT graceful drain.

The fleet slice (ROADMAP.md §A item 5) adds what the JAX package serves
across processes: ``router``, ``fleet`` (``ServingFleet``, replica worker
processes), ``replay``, ``autoscaler``, ``bench_replay``, the serve CLI's
``--fleet*`` flags and ``bench_serving``'s fleet chaos soak.
"""

from shallowspeed_tpu_torch.serving.engine import Request, ServingEngine
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
    "Request",
    "ServingEngine",
    "pack_slots",
    "rung_for",
    "slots_needed",
    "unpack_slots",
]
