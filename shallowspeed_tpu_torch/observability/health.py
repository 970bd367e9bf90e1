"""Numerics health monitor: NaN/Inf, loss divergence, grad-norm spikes.

Copied from ``shallowspeed_tpu/observability/health.py`` (pure Python);
``tests/test_torch_observability.py`` holds the copy's output to the
JAX module's on the same inputs.

Consumes the fused per-step aux the flight recorder threads out of the epoch
programs (loss, pre-clip grad norm, post-update param norm) and checks it ON
HOST, after each epoch's single readback — the checks live entirely outside
the jitted program, so an instrumented run executes the exact same XLA
computation as a bare one.

Checks (each produces a *finding* dict naming the step it fired on):

- ``non_finite``       any NaN/Inf in loss, grad norm or param norm — the
                       unambiguous blowup signal;
- ``loss_divergence``  rolling-window least-squares regression over recent
                       step losses: fires when the window's slope is
                       positive AND the current loss has grown past
                       ``divergence_factor`` x the window minimum (the
                       slope test alone would fire on benign noise, the
                       level test alone on a one-step blip);
- ``grad_spike``       current grad norm >= ``spike_factor`` x the rolling
                       median (median, not mean: one spike must not drag
                       the baseline up and mask the next one).

Policy (``record`` / ``warn`` / ``halt``) decides what a finding DOES:

- ``record``  emit a schema-v2 ``health`` record per finding, keep going;
- ``warn``    record + print a warning to stderr;
- ``halt``    record (and flush, so the evidence is on disk), then raise
              ``HealthError`` naming the first finding — the training loop
              stops with the blown-up step identified instead of burning
              the rest of the run on NaN arithmetic.

Wiring: ``TrainingSession(health="halt")`` / ``train.py --health halt``
(a ``HealthMonitor`` instance is accepted wherever the policy string is,
for non-default windows/factors).
"""

import math
import sys
from collections import deque

POLICIES = ("record", "warn", "halt")


class HealthError(RuntimeError):
    """Raised under policy='halt' when a health check fires.

    ``finding`` is the first finding dict (check/epoch/step/value/detail);
    the epoch's parameter update has already been applied when this raises —
    the monitor observes the fused program's outputs, it cannot unwind them.
    """

    def __init__(self, finding):
        self.finding = finding
        where = f"epoch {finding.get('epoch')}"
        if finding.get("step") is not None:
            where += f", step {finding['step']}"
        super().__init__(
            f"numerics health halt: {finding.get('check')} at {where} "
            f"({finding.get('detail')})"
        )


def _is_finite(v):
    return v is not None and math.isfinite(v)


def _slope(values):
    """Least-squares slope of values over 0..n-1 (the rolling regression)."""
    n = len(values)
    if n < 2:
        return 0.0
    xm = (n - 1) / 2.0
    ym = sum(values) / n
    num = sum((i - xm) * (v - ym) for i, v in enumerate(values))
    den = sum((i - xm) ** 2 for i in range(n))
    return num / den


class HealthMonitor:
    """Stateful rolling-window checker; one instance per training run."""

    def __init__(
        self,
        policy="record",
        window=32,
        min_history=8,
        divergence_factor=3.0,
        spike_factor=10.0,
    ):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        if min_history < 2 or window < min_history:
            raise ValueError("need window >= min_history >= 2")
        self.policy = policy
        self.window = int(window)
        self.min_history = int(min_history)
        self.divergence_factor = float(divergence_factor)
        self.spike_factor = float(spike_factor)
        self._losses = deque(maxlen=self.window)
        self._gnorms = deque(maxlen=self.window)
        self.findings = []  # everything ever found, in firing order

    # -- checks -------------------------------------------------------------

    def check_step(self, epoch, loss, step=None, grad_norm=None, param_norm=None):
        """Check one step's scalars; returns this step's findings (and
        appends them to ``self.findings``). Rolling windows only ever ingest
        finite values — a NaN step must not poison the baseline the NEXT
        step is judged against."""
        found = []

        def finding(check, value, detail):
            f = {
                "check": check,
                "epoch": int(epoch),
                "step": None if step is None else int(step),
                "value": None if value is None else float(value),
                "detail": detail,
            }
            found.append(f)
            return f

        for field, v in (
            ("loss", loss), ("grad_norm", grad_norm), ("param_norm", param_norm)
        ):
            if v is not None and not math.isfinite(v):
                finding(
                    "non_finite", v, f"{field} is {float(v)!r}"
                )["field"] = field

        if _is_finite(loss):
            if len(self._losses) >= self.min_history:
                wmin = min(self._losses)
                slope = _slope(list(self._losses) + [float(loss)])
                if wmin > 0 and loss >= self.divergence_factor * wmin and slope > 0:
                    f = finding(
                        "loss_divergence",
                        loss,
                        f"loss {float(loss):.6g} >= {self.divergence_factor}x "
                        f"window min {wmin:.6g} with rising slope",
                    )
                    f["slope"] = float(slope)
                    f["window_min"] = float(wmin)
            self._losses.append(float(loss))

        if _is_finite(grad_norm):
            if len(self._gnorms) >= self.min_history:
                med = sorted(self._gnorms)[len(self._gnorms) // 2]
                if med > 0 and grad_norm >= self.spike_factor * med:
                    f = finding(
                        "grad_spike",
                        grad_norm,
                        f"grad norm {float(grad_norm):.6g} >= "
                        f"{self.spike_factor}x rolling median {med:.6g}",
                    )
                    f["window_median"] = float(med)
            self._gnorms.append(float(grad_norm))

        self.findings.extend(found)
        return found

    def check_epoch(
        self, epoch, losses, grad_norms=None, param_norms=None, first_step=None
    ):
        """Check one epoch's per-step arrays (the flight-recorder aux);
        ``first_step=None`` means step identity is unknown (epoch-granular
        callers, e.g. the kernel paths) and findings carry ``step: null``."""
        found = []
        for i, loss in enumerate(losses):
            found.extend(
                self.check_step(
                    epoch,
                    loss,
                    step=None if first_step is None else first_step + i,
                    grad_norm=None if grad_norms is None else grad_norms[i],
                    param_norm=None if param_norms is None else param_norms[i],
                )
            )
        return found

    def check_run(self, start_epoch, losses, grad_norms=None):
        """Check a fused multi-epoch run's per-EPOCH scalars (one loss — and
        optionally one mean grad norm — per epoch; the fused run returns in
        one dispatch, so step granularity does not exist there)."""
        found = []
        for i, loss in enumerate(losses):
            found.extend(
                self.check_step(
                    start_epoch + i,
                    loss,
                    step=None,
                    grad_norm=None if grad_norms is None else grad_norms[i],
                )
            )
        return found

    # -- policy -------------------------------------------------------------

    def dispatch(self, findings, metrics=None):
        """Apply the policy to a batch of findings: emit one ``health``
        record per finding (action-stamped), warn/halt per policy. Under
        ``halt`` every finding is recorded AND flushed before the raise, so
        the JSONL evidence trail survives the abort."""
        if metrics is not None:
            for f in findings:
                metrics.health(
                    f["check"],
                    action=self.policy,
                    **{k: v for k, v in f.items() if k != "check"},
                )
        if not findings:
            return
        if self.policy == "warn":
            for f in findings:
                where = f"epoch {f['epoch']}" + (
                    f", step {f['step']}" if f.get("step") is not None else ""
                )
                print(
                    f"health warning: {f['check']} at {where}: {f['detail']}",
                    file=sys.stderr,
                )
        elif self.policy == "halt":
            if metrics is not None:
                metrics.flush()
            raise HealthError(findings[0])


def make_monitor(health):
    """Normalize the ``health=`` argument surface: None -> None, a policy
    string -> a default-window HealthMonitor, a HealthMonitor -> itself."""
    if health is None or isinstance(health, HealthMonitor):
        return health
    return HealthMonitor(policy=health)
