"""Training and serving telemetry for the port: the counterpart of
``shallowspeed_tpu/observability`` (same JSONL schema, v13, so the JAX
package's report, watch and divergence CLIs read the port's files).

- ``metrics``      ``NullMetrics`` (the zero-cost default), the in-memory
                   ``MetricsRecorder`` and the JSONL sink ``JsonlMetrics``
                   (copied);
- ``spans``        wall-clock spans under ``torch.profiler.record_function``
                   (and an NVTX range on a CUDA session); the program
                   trace, an in-memory record of the port's own spans and
                   counters on the profiler's clock while ``recording()``
                   is open (a flag test while it is not); and ``capture``,
                   a ``torch.profiler`` trace into a directory;
- ``trace_stats``  the Kineto trace analyzer: the device events' busy
                   union (``dispatch_busy``) and op breakdown
                   (``summarize``);
- ``costmodel``    model FLOPs, padded pipeline FLOPs, the card's fp32 peak
                   and MFU; ``PIPELINE_OP_COSTS``;
- ``flight``, ``health``, ``rollup``, ``slo``, ``stats`` (copied): the
                   per-step flight ring, the numerics health monitor with
                   its record/warn/halt policy, the streaming rollups and
                   alert rules behind ``LiveTelemetry``, and the shared
                   percentile;
- ``report``, ``watch``, ``divergence`` (copied CLIs, ``python -m
                   shallowspeed_tpu_torch.observability.<name>``);
- ``tracing``      (copied) the request span chains the serving engine
                   emits, their assembly, clock alignment and per-phase
                   latency attribution behind the report's Tracing section;
- ``program_audit`` the program audit: the census of the executor's data
                   movers held to the layout's comms contract, the
                   allocator's memory peak beside the ZeRO forecast, and
                   the serving rungs' dispatch safety (``xla_audit``
                   records; ``audit=True`` / ``--audit`` enforce it).

The AOT program cache (``shallowspeed_tpu_torch/aot_cache.py``) records
its outcomes through ``metrics.aot_cache`` (schema v8), which the report's
Reliability section renders.
"""

from shallowspeed_tpu_torch.observability.flight import FlightRecorder
from shallowspeed_tpu_torch.observability.health import (
    HealthError,
    HealthMonitor,
)
from shallowspeed_tpu_torch.observability.metrics import (
    SCHEMA_VERSION,
    JsonlMetrics,
    MetricsRecorder,
    NullMetrics,
    read_jsonl,
    replica_shard_path,
)
from shallowspeed_tpu_torch.observability.rollup import (
    QuantileSketch,
    RollupBuilder,
    merge_rollup_records,
)
from shallowspeed_tpu_torch.observability.slo import (
    AlertSink,
    BurnRateRule,
    EventRule,
    LiveTelemetry,
    SloEvaluator,
    ThresholdRule,
)
from shallowspeed_tpu_torch.observability.spans import Span, capture, span
from shallowspeed_tpu_torch.observability.stats import ThroughputWindow, percentile

__all__ = [
    "SCHEMA_VERSION",
    "AlertSink",
    "BurnRateRule",
    "EventRule",
    "FlightRecorder",
    "HealthError",
    "HealthMonitor",
    "JsonlMetrics",
    "LiveTelemetry",
    "MetricsRecorder",
    "NullMetrics",
    "QuantileSketch",
    "RollupBuilder",
    "SloEvaluator",
    "Span",
    "ThresholdRule",
    "ThroughputWindow",
    "capture",
    "merge_rollup_records",
    "percentile",
    "read_jsonl",
    "replica_shard_path",
    "span",
]
