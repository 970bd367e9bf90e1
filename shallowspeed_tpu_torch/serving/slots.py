"""Slot geometry for inference dispatch: the fixed microbatch grid + ladder.

A copy of ``shallowspeed_tpu/serving/slots.py`` (pure Python), kept here so
the port imports nothing of the JAX package. The text below is the
original's; in the port "compiled program" reads "kernel launch shape":
a fixed slot shape is what keeps each slot's rows bitwise-stable, because
the CUDA kernel sums every output element in one fixed order.

Serving packs variable-size requests into the pipeline executor's microbatch
slots — the same on-the-fly packing torchgpipe applies to training
microbatches (arXiv 2004.09910). Two constants fix the whole geometry:

- ``slot_rows``   the GLOBAL row count of one microbatch slot (divisible by
                  dp; each replica computes ``slot_rows / dp`` rows of it).
                  Every inference dispatch is a whole number of slots, and
                  every request occupies a whole number of slots — requests
                  never share a slot, so a request's per-slot inputs are
                  identical whether it rides alone or packed with others;
- ``slot ladder`` the allowed slot counts per dispatch (default 1, 2, 4, 8,
                  16). A dispatch's slot count is rounded UP to the next
                  rung, so the number of distinct compiled inference
                  programs is bounded by ``len(ladder)`` — the fix for the
                  unbounded one-program-per-row-count predict cache.

Why fixed slots instead of one variable-size padded batch: XLA tiles a
matmul by its SHAPE, so the same row computed inside a (8, d) and a (64, d)
batch differs at ULP level (measured on the CPU backend). With a fixed slot
shape, every slot is the same compiled compute regardless of which rung
program or slot position it rides in — measured bitwise-identical — which is
what lets the serving engine promise responses bitwise-equal to a direct
``predict()`` of the same rows.

Layout: the executor shards the global batch row-contiguously over ``dp``
and then reshapes each replica's block into ``(num_slots, slot_rows/dp)``
microbatches, so logical slot ``m`` is NOT ``rows[m*S:(m+1)*S]`` of the
global array — it is ``slot_rows/dp`` consecutive rows from EACH replica's
block. ``pack_slots``/``unpack_slots`` are the one definition of that
mapping (api.predict and the tests share it).
"""

import numpy as np

# slot counts per dispatch — geometric so low load pays small dispatches and
# the compile count stays bounded at len(ladder) programs per layout
DEFAULT_SLOT_LADDER = (1, 2, 4, 8, 16)

# target global rows per slot before rounding up to a dp multiple
DEFAULT_SLOT_ROWS = 8


def default_slot_rows(dp, target=DEFAULT_SLOT_ROWS):
    """The default slot height: ``target`` rounded up to a dp multiple."""
    return -(-int(target) // int(dp)) * int(dp)


def validate_ladder(ladder):
    """-> the ladder as a strictly-increasing tuple of positive ints."""
    ladder = tuple(int(r) for r in ladder)
    if not ladder or any(r < 1 for r in ladder):
        raise ValueError(f"slot ladder must be positive ints, got {ladder!r}")
    if any(b <= a for a, b in zip(ladder, ladder[1:])):
        raise ValueError(f"slot ladder must be strictly increasing: {ladder!r}")
    return ladder


def slots_needed(n_rows, slot_rows):
    """Slots a request of ``n_rows`` rows occupies (requests never share a
    slot — the bitwise-parity contract needs per-request slot contents)."""
    if n_rows < 1:
        raise ValueError("a request needs at least one row")
    return -(-int(n_rows) // int(slot_rows))


def rung_for(n_slots, ladder):
    """The smallest ladder rung >= ``n_slots`` (callers chunk by the top
    rung first, so ``n_slots`` never exceeds it)."""
    for r in ladder:
        if r >= n_slots:
            return r
    raise ValueError(
        f"{n_slots} slots exceed the ladder's top rung {ladder[-1]} — "
        "chunk the dispatch first"
    )


def pack_slots(slots, dp):
    """Logical slots -> the executor's global row layout.

    ``slots``: (M, slot_rows, d) array of logical slot contents. Returns
    (M * slot_rows, d): replica r's contiguous block holds rows
    ``[r*S/dp : (r+1)*S/dp)`` of every slot, in slot order — exactly what
    ``x.reshape(M, slot_rows/dp, d)`` per replica undoes on device.
    """
    slots = np.asarray(slots)
    M, S, d = slots.shape
    if S % dp:
        raise ValueError(f"slot_rows {S} not divisible by dp {dp}")
    return (
        slots.reshape(M, dp, S // dp, d)
        .transpose(1, 0, 2, 3)
        .reshape(M * S, d)
    )


def unpack_slots(arr, num_slots, dp):
    """Inverse of ``pack_slots`` for the dispatch's outputs: the executor's
    global row layout -> (num_slots * slot_rows, d) in logical slot order."""
    arr = np.asarray(arr)
    rows, d = arr.shape
    S = rows // num_slots
    return (
        arr.reshape(dp, num_slots, S // dp, d)
        .transpose(1, 0, 2, 3)
        .reshape(rows, d)
    )
