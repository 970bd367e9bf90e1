"""Step-level flight recorder: a bounded ring of per-step training samples.

Copied from ``shallowspeed_tpu/observability/flight.py`` (pure Python);
``tests/test_torch_observability.py`` holds the copy's output to the
JAX module's on the same inputs.

The fused epoch programs (trainer.make_train_epoch / executor.
make_pipeline_epoch with ``with_step_stats=True``) return per-step scalars —
loss, pre-clip global gradient norm, post-update global parameter norm — as
ORDINARY scan outputs: data flow out of the one jitted program, never host
callbacks inside it, so instrumentation cannot break the single-program-per-
epoch property the whole framework is built on. The host reads those arrays
back once per epoch and feeds them here.

The ring is bounded (``capacity`` samples, oldest evicted first) so a
million-step run holds a constant-size in-memory record: the recorder is the
"what just happened" buffer the numerics health monitor and a post-mortem
read, while the JSONL stream (``MetricsRecorder.step`` records, schema v2)
is the unbounded on-disk history.

Each sample is one plain dict — JSON-able as-is and exactly the field set
the ``step`` record kind carries::

    {"step": global_step, "epoch": e, "loss": ...,
     "grad_norm": ...|None, "param_norm": ...|None}
"""

from collections import deque


class FlightRecorder:
    """Bounded ring buffer of per-step flight samples."""

    def __init__(self, capacity=4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        self.total_steps = 0  # lifetime count (>= len(self) once evicting)

    def record_epoch(
        self, epoch, losses, grad_norms=None, param_norms=None, first_step=None
    ):
        """Append one epoch's per-step arrays; returns the new samples.

        ``losses`` is required (one entry per optimizer step, in step
        order); ``grad_norms``/``param_norms`` are optional parallel arrays
        (None when the layout cannot thread them — e.g. the Pallas kernel
        paths, where gradients never leave VMEM). ``first_step`` defaults to
        the recorder's lifetime step count, so back-to-back epochs number
        their steps globally and monotonically.
        """
        if first_step is None:
            first_step = self.total_steps
        samples = []
        for i, loss in enumerate(losses):
            samples.append(
                {
                    "step": int(first_step + i),
                    "epoch": int(epoch),
                    "loss": float(loss),
                    "grad_norm": (
                        None if grad_norms is None else float(grad_norms[i])
                    ),
                    "param_norm": (
                        None if param_norms is None else float(param_norms[i])
                    ),
                }
            )
        self._ring.extend(samples)
        self.total_steps += len(samples)
        return samples

    def last(self, n=None):
        """The most recent ``n`` samples (all retained samples if None)."""
        if n is None:
            return list(self._ring)
        if n <= 0:
            return []
        return list(self._ring)[-n:]

    def snapshot(self):
        """JSON-able copy of the retained window (oldest first)."""
        return [dict(s) for s in self._ring]

    def __len__(self):
        return len(self._ring)
