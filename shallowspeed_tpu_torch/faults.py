"""Deterministic fault injection: kill, poison and corrupt ON PURPOSE — the
port's copy of ``shallowspeed_tpu/faults.py``.

The recovery contract ("crash at any step, resume, and the final weight hash
is identical") is only worth claiming if something actually crashes real
runs. This module is that something: a small set of injection points that
tests and ``chip_smoke.py`` activate either through the API
(``TrainingSession(faults=...)``) or the environment
(``SHALLOWSPEED_FAULTS``, so a *subprocess* ``python -m
shallowspeed_tpu_torch.train`` can be killed without patching it). The
grammar, the plan and the corruption helpers are the JAX package's, line for
line; ``poison_nan`` and ``poison_bitflip`` act on torch tensors IN PLACE.

Spec grammar — comma-separated injections, each anchored to a TRAINING
step (``kind@step=N[:mode=...]``), a SERVING dispatch
(``kind@dispatch=N[:mode=...][:ms=...]``), or a checkpoint SAVE
(``kind@save=N[:mode=...][:ms=...]``)::

    SHALLOWSPEED_FAULTS="die@step=7:mode=sigkill"     # hard kill at step 7
    SHALLOWSPEED_FAULTS="die@step=7"                  # raise InjectedFault
    SHALLOWSPEED_FAULTS="nan@step=3"                  # NaN into the gradients
    SHALLOWSPEED_FAULTS="flip@step=3"                 # single-bit param flip
    SHALLOWSPEED_FAULTS="die@step=9,nan@step=3"       # compose
    SHALLOWSPEED_FAULTS="die@save=2:mode=sigkill"     # kill INSIDE save 2's
                                                      #   write-verify-rename
                                                      #   window
    SHALLOWSPEED_FAULTS="slow@save=1:ms=200"          # stall the writer in
                                                      #   the same window
    SHALLOWSPEED_FAULTS="corrupt@save=3"              # flip bytes in the
                                                      #   in-flight buffer

Steps are GLOBAL optimizer-step indices (epoch * batches_per_epoch +
step_in_epoch — the same cursor the step checkpoints store). Saves are
``save_step_checkpoint``'s save sequence numbers (the Nth snapshot this
process attempts) — the anchor the checkpoint writer consults, so a kill
lands at a DETERMINISTIC point inside the write/verify/rename window. The
dispatch anchor (``error``/``slow``/``nan``/``die@dispatch=N``) parses
here as in the JAX package; the port's serving engine does not fire it yet
(ROADMAP.md §A item 5), and a training entry point never waits on it.

Injection points, all fired by the host between dispatches:

- ``die``   fire when the run reaches step N, BEFORE its update:
            ``mode=exc`` (default) raises ``InjectedFault``;
            ``mode=sigkill`` sends SIGKILL to the current process — the
            real preemption shape, nothing flushes, no atexit runs.
- ``nan``   set one parameter element to NaN right before step N, so
            step N's loss and gradients come out NaN.
- ``flip``  XOR the LOWEST mantissa bit of that same element right before
            step N: a silent single-bit corruption that stays finite.
- ``slow``  (save) sleep ``ms`` inside save N's write window (after the
            temp write, before the rename).
- ``corrupt`` (save) flip bytes in the IN-FLIGHT snapshot buffer AFTER its
            checksum was stamped — the written file renames into place but
            can never verify, the bit-rot shape ``find_latest_good`` must
            skip past. Save-anchored ``die`` fires INSIDE the writer's
            window: after the temp file is written and fsynced, BEFORE the
            atomic rename, so only the older snapshots stay discoverable.

``nan`` and ``flip`` act on flat element 0 of global layer 0's W, the JAX
package's anchor, on both layouts: element ``[0, 0]`` of the first stage's
first W on the sequential tree, ``stacked["W"][0][0, 0, 0]`` on the
executor's stacked one (slot 0 is stage 0's layer 0). They write into the
live tensor, so the next step reads the poisoned value whichever path
runs it — the microbatch loop, the executor or the fused train kernel,
which reads and updates the params in place.

Checkpoint corruption of files AT REST stays a function, not a step
trigger: ``corrupt_checkpoint_bytes(path)`` flips bytes inside an existing
checkpoint so its content checksum can no longer verify — deterministic
given ``seed``.
"""

import os
import signal

import numpy as np
import torch

from shallowspeed_tpu_torch.optimizer import tree_leaves

ENV_VAR = "SHALLOWSPEED_FAULTS"
KINDS = ("die", "nan", "flip")  # step-triggered (training) kinds
SERVING_KINDS = ("die", "nan", "slow", "error")  # dispatch-triggered kinds
SAVE_KINDS = ("die", "slow", "corrupt")  # save-triggered (writer) kinds
DIE_MODES = ("exc", "sigkill")


class InjectedFault(RuntimeError):
    """Raised by a ``die`` injection with ``mode=exc`` (the soft kill) and
    by a serving ``error`` injection inside the dispatch wrapper."""


class Fault:
    """One parsed injection: ``kind`` at global ``step`` (+ ``mode``), at
    attempted-dispatch ``dispatch`` (serving; + ``ms`` for ``slow``), or
    at checkpoint-save sequence ``save`` (the writer anchor). Exactly one
    of ``step``/``dispatch``/``save`` is set; ``trigger`` names which."""

    __slots__ = ("kind", "step", "dispatch", "save", "mode", "ms", "fired")

    def __init__(self, kind, step=None, mode=None, dispatch=None, ms=None,
                 save=None):
        anchors = [a for a in (step, dispatch, save) if a is not None]
        if len(anchors) != 1:
            raise ValueError(
                "a fault anchors to exactly one of step/dispatch/save"
            )
        if step is not None:
            if kind not in KINDS:
                raise ValueError(
                    f"unknown step-fault kind {kind!r} (have {KINDS})"
                )
            if step < 0:
                raise ValueError(f"fault step must be >= 0, got {step}")
        elif dispatch is not None:
            if kind not in SERVING_KINDS:
                raise ValueError(
                    f"unknown dispatch-fault kind {kind!r} (have "
                    f"{SERVING_KINDS})"
                )
            if dispatch < 0:
                raise ValueError(
                    f"fault dispatch must be >= 0, got {dispatch}"
                )
        else:
            if kind not in SAVE_KINDS:
                raise ValueError(
                    f"unknown save-fault kind {kind!r} (have {SAVE_KINDS})"
                )
            if save < 0:
                raise ValueError(f"fault save must be >= 0, got {save}")
        if kind == "die":
            mode = mode or "exc"
            if mode not in DIE_MODES:
                raise ValueError(
                    f"die mode must be one of {DIE_MODES}, got {mode!r}"
                )
        elif mode is not None:
            raise ValueError(f"fault kind {kind!r} takes no mode")
        if kind == "slow":
            if ms is None:
                raise ValueError("slow faults need ms=<milliseconds>")
            ms = float(ms)
            if ms < 0:
                raise ValueError(f"slow ms must be >= 0, got {ms}")
        elif ms is not None:
            raise ValueError(f"fault kind {kind!r} takes no ms")
        self.kind = kind
        self.step = None if step is None else int(step)
        self.dispatch = None if dispatch is None else int(dispatch)
        self.save = None if save is None else int(save)
        self.mode = mode
        self.ms = ms
        self.fired = False

    @property
    def trigger(self):
        if self.step is not None:
            return "step"
        return "dispatch" if self.dispatch is not None else "save"

    def __repr__(self):
        at = f"{self.trigger}={getattr(self, self.trigger)}"
        mode = f":mode={self.mode}" if self.kind == "die" else ""
        ms = f":ms={self.ms:g}" if self.kind == "slow" else ""
        return f"{self.kind}@{at}{mode}{ms}"


class FaultPlan:
    """The active injections of one run; consulted at step boundaries."""

    def __init__(self, faults=()):
        self.faults = list(faults)

    @classmethod
    def parse(cls, spec):
        """Parse the spec grammar (see module docstring). ``None``/empty ->
        an empty plan; malformed specs raise ValueError naming the part."""
        faults = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                kind, _, rest = part.partition("@")
                fields = dict(
                    kv.split("=", 1) for kv in rest.split(":") if kv
                )
                step = fields.pop("step", None)
                dispatch = fields.pop("dispatch", None)
                save = fields.pop("save", None)
                if sum(a is not None for a in (step, dispatch, save)) != 1:
                    raise ValueError(
                        "need exactly one of step=/dispatch=/save="
                    )
                faults.append(
                    Fault(
                        kind.strip(),
                        step=None if step is None else int(step),
                        dispatch=None if dispatch is None else int(dispatch),
                        save=None if save is None else int(save),
                        mode=fields.pop("mode", None),
                        ms=fields.pop("ms", None),
                    )
                )
                if fields:
                    raise ValueError(f"unknown fields {sorted(fields)}")
            except (KeyError, ValueError) as e:
                raise ValueError(f"bad fault spec {part!r}: {e}") from None
        return cls(faults)

    def __bool__(self):
        return bool(self.faults)

    @property
    def pending(self):
        """STEP-triggered injections that have not fired yet — non-empty
        means the run still needs step boundaries (``train_steps``) for
        them to land. Dispatch-triggered (serving) faults are excluded:
        they belong to a serving dispatch loop, so a training
        entry point must not refuse a run over them."""
        return [f for f in self.faults if not f.fired and f.step is not None]

    @property
    def pending_dispatch(self):
        """Dispatch-triggered injections that have not fired yet."""
        return [
            f for f in self.faults if not f.fired and f.dispatch is not None
        ]

    @property
    def pending_save(self):
        """Save-triggered (checkpoint-writer) injections not fired yet."""
        return [
            f for f in self.faults if not f.fired and f.save is not None
        ]

    def due_at_save(self, n):
        """Un-fired save faults scheduled AT OR BEFORE save sequence ``n``,
        in spec order — the checkpoint writer (sync path or the async
        background thread) fires each exactly once. The <= anchor mirrors
        ``due_at_dispatch``: a fault whose exact save never ran (e.g. the
        run died first and resumed with a shorter grid) still fires on
        the next save instead of silently never."""
        return [f for f in self.pending_save if f.save <= n]

    def first_in(self, lo, hi):
        """Earliest un-fired STEP fault with ``lo <= step < hi``, or None —
        the step loop truncates its dispatch chunks at this boundary so
        every injection lands exactly on its step."""
        pending = [f for f in self.pending if lo <= f.step < hi]
        return min(pending, key=lambda f: f.step) if pending else None

    def due_at_dispatch(self, n):
        """Un-fired dispatch faults scheduled AT OR BEFORE attempted
        dispatch ``n``, in spec order — a serving dispatch loop fires each
        exactly once. The <= (not ==) anchor is the serving mirror of the
        step loop's fire-loop: a fault whose exact dispatch was consumed
        by a same-dispatch ``die`` (or by a dispatch that only shed
        expired requests) fires on the next attempt instead of silently
        never."""
        return [f for f in self.pending_dispatch if f.dispatch <= n]

    def fire_die(self, fault):
        """Execute a ``die`` fault: SIGKILL the process (nothing flushes —
        the honest preemption) or raise InjectedFault."""
        fault.fired = True
        if fault.mode == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault(f"injected fault: {fault!r}")


def from_env(environ=None):
    """The plan configured in ``SHALLOWSPEED_FAULTS`` (empty when unset)."""
    return FaultPlan.parse((environ or os.environ).get(ENV_VAR, ""))


def make_plan(faults):
    """Normalize the ``faults=`` argument surface: None -> the env plan,
    a spec string -> parsed, a FaultPlan -> itself."""
    if faults is None:
        return from_env()
    if isinstance(faults, FaultPlan):
        return faults
    return FaultPlan.parse(faults)


def _anchor(params):
    """The first tensor leaf of a params tree in the JAX package's leaf
    order (lists in order, dict keys sorted: ``"W"`` before ``"b"``) — global
    layer 0's W on the sequential tree and on the stacked one."""
    leaves = [t for t in tree_leaves(params) if isinstance(t, torch.Tensor)]
    leaves = [t for t in leaves if t.dim() >= 1 and t.numel() > 0]
    if not leaves:
        raise ValueError("no tensor leaf to poison in params")
    return leaves[0]


def poison_nan(params):
    """The ``nan`` injection body: set flat element 0 of the first weight
    leaf of ``params`` (a params tree of tensors, either layout) to NaN, IN
    PLACE, and return ``params``. The next step's forward reads it, so that
    step's loss and every gradient behind it are NaN."""
    leaf = _anchor(params)
    with torch.no_grad():
        leaf.view(-1)[0] = float("nan")
    return params


def poison_bitflip(params):
    """The ``flip`` injection body: XOR the lowest mantissa bit of flat
    element 0 of the first weight leaf of ``params`` (the anchor of
    ``poison_nan``), IN PLACE, and return ``params``. A 1-ulp flip stays
    finite."""
    leaf = _anchor(params)
    if leaf.dtype != torch.float32:
        raise ValueError(f"bit flip needs a float32 leaf, got {leaf.dtype}")
    with torch.no_grad():
        leaf.view(-1)[:1].view(torch.int32).bitwise_xor_(1)
    return params


def corrupt_buffer(arrays, nbytes=4, seed=0):
    """The ``corrupt@save=N`` injection body: flip ``nbytes`` bytes in the
    first (name-sorted) array of an IN-FLIGHT snapshot buffer — in place,
    AFTER the content checksum was stamped into the metadata, so the file
    the writer renames into place can never verify. The on-disk mirror of
    ``corrupt_checkpoint_bytes``, applied one stage earlier: it produces a
    rename-visible file that ``find_latest_good`` must skip, which is
    exactly the fallback path the chaos harness needs to exercise without
    racing the writer. Deterministic given ``seed``; returns the flipped
    byte offsets (within the chosen array) for test assertions."""
    names = sorted(n for n in arrays if n != "meta")
    if not names:
        raise ValueError("no array to corrupt in the in-flight buffer")
    target = arrays[names[0]]
    # explicit writable copy: a snapshot's arrays may be read-only views,
    # and the corruption must land in the buffer the writer will
    # serialize, not raise out of the injection
    flat = np.array(target, copy=True).view(np.uint8).reshape(-1)
    if flat.size == 0:
        raise ValueError(f"array {names[0]!r} is empty — nothing to corrupt")
    rng = np.random.RandomState(seed)
    offsets = sorted(
        int(o)
        for o in rng.choice(flat.size, size=min(nbytes, flat.size),
                            replace=False)
    )
    for off in offsets:
        flat[off] ^= 0xFF
    arrays[names[0]] = flat.view(target.dtype).reshape(target.shape)
    return offsets


def corrupt_checkpoint_bytes(path, nbytes=16, seed=0):
    """Deterministically flip ``nbytes`` bytes in the middle of ``path`` —
    past the zip local-file header so the file still LOOKS like a .npz and
    only the content checksum (or the array parse) can catch it. Returns
    the byte offsets touched (for test assertions)."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty — nothing to corrupt")
    rng = np.random.RandomState(seed)
    # keep clear of the first 64 bytes (zip magic) when the file allows it
    lo = min(64, size - 1)
    offsets = sorted(
        int(o) for o in rng.choice(range(lo, size), size=min(nbytes, size - lo),
                                   replace=False)
    )
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    return offsets
