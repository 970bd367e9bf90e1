"""Shared summary statistics, copied from ``shallowspeed_tpu/observability/stats.py``:
the ONE percentile definition and the ONE serving-window definition.

``percentile`` is ``np.percentile`` on float64 with its default (linear
interpolation) method over the non-``None`` samples; an empty set gives
``None``, never 0.0 — an unmeasured percentile must not read as a fast one.
``ThroughputWindow`` bounds the first-enqueue -> last-complete window that
``achieved_rps``/``goodput_rps`` divide by.
"""

import numpy as np


def percentile(values, q):
    """``np.percentile(values, q)`` (float64, linear interpolation) over the
    non-``None`` samples; ``None`` when no sample survives the filter."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


class ThroughputWindow:
    """First-enqueue -> last-complete serving window."""

    __slots__ = ("first_enqueue_t", "last_complete_t")

    def __init__(self):
        self.first_enqueue_t = None
        self.last_complete_t = None

    def reset(self):
        self.first_enqueue_t = None
        self.last_complete_t = None

    def note_enqueue(self, t):
        """Earliest noted enqueue wins."""
        if self.first_enqueue_t is None or t < self.first_enqueue_t:
            self.first_enqueue_t = t

    def note_complete(self, t):
        """Latest noted completion wins."""
        if self.last_complete_t is None or t > self.last_complete_t:
            self.last_complete_t = t

    @property
    def window_s(self):
        """Window length in seconds; ``None`` until both ends exist."""
        if self.first_enqueue_t is None or self.last_complete_t is None:
            return None
        return float(self.last_complete_t - self.first_enqueue_t)
