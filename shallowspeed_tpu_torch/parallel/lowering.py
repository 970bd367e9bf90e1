"""Schedule -> clock-tick lowering: the MPMD-to-SPMD compiler.

The port's copy of ``shallowspeed_tpu/parallel/lowering.py`` (numpy only;
the cost weights of ``observability/costmodel.PIPELINE_OP_COSTS`` are kept
here). ``tests/test_torch_lowering.py`` holds every table equal to the JAX
package's; the port's executor (``parallel/executor.py``) interprets them
with buffer moves on one device instead of ``ppermute`` across chips.

The reference executes pipeline schedules MPMD: each rank interprets ITS
instruction stream, synchronizing implicitly through blocking MPI Send/Recv
(pipe.py:330-466). Under jit/shard_map every device must run the SAME traced
program, so this module compiles the per-stage instruction streams into a
static *clock-tick program*: numpy tables, indexed [tick, stage], saying what
each stage computes, which mailbox slot it reads, whether it emits a payload,
and where arriving payloads are stored. The executor then runs one jitted
tick function under ``lax.scan``; ``jax.lax.ppermute`` moves payloads between
neighbor stages each tick (pipeline bubbles become masked no-op ticks —
exactly the blank cells of the reference's pebble graph, README.md:41).

The lowering is schedule-agnostic: any Schedule whose streams obey the
contract (one compute per step-group, sends attached to the producing
compute, recvs attached to the consuming compute) lowers automatically —
naive, GPipe, PipeDream-Flush and Inference all go through this one path.

Timing model (matches the executor's tick loop):
- a payload sent at tick t is delivered into the receiver's mailbox at the
  end of tick t and is consumable from tick t+1;
- each stage executes at most ONE compute item (forward or backward of one
  microbatch) per tick;
- a send always occurs in the same tick as the compute that produced it.

The simulator is also a verifier: it detects deadlocks, unmatched
sends/recvs, mailbox overflows and missing/duplicate microbatch work, so a
buggy schedule fails at lowering time with a readable error instead of
hanging a TPU collective.
"""

import dataclasses
from collections import deque

import numpy as np

from shallowspeed_tpu_torch import schedules as S

# op codes in the tick tables. In a SPLIT program (backward_split) OP_BWD
# cells are the relay-critical B-input half — same tick the combined
# backward would occupy, same message structure — and OP_BWD_W cells are
# the deferred B-weight halves packed into former bubble ticks. In a
# RECOMPUTE program OP_FWD cells stash only the stage INPUT and
# OP_RECOMPUTE cells re-run the stage forward right before the backward,
# writing the residual stash the backward then consumes (torchgpipe trade:
# the stash lifetime shrinks from fwd->bwd to recompute->bwd).
OP_NOOP, OP_FWD, OP_BWD, OP_BWD_W, OP_RECOMPUTE = 0, 1, 2, 3, 4

# per-op FLOP weights in units of one stage forward (the JAX package's
# ``observability/costmodel.PIPELINE_OP_COSTS``)
PIPELINE_OP_COSTS = {
    "fwd": 1.0, "bwd": 2.0, "bwd_in": 1.0, "bwd_w": 1.0, "recompute": 1.0,
}


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One compute event parsed from a device's instruction stream."""

    kind: int  # OP_FWD | OP_BWD | OP_BWD_W | OP_RECOMPUTE
    mubatch_id: int
    chunk: int = 0  # virtual-stage chunk on this device (0 unless interleaved)
    needs_fwd_msg: bool = False  # consumes activations from the prior stage
    needs_bwd_msg: bool = False  # consumes output-grad from the next stage
    sends_fwd: bool = False  # emits activations to the next stage
    sends_bwd: bool = False  # emits input-grad to the prior stage
    allreduce: bool = False  # this backward anchors the DP all-reduce


@dataclasses.dataclass(frozen=True)
class TickProgram:
    """Static SPMD program: everything the executor's scan body indexes.

    Tables are indexed [tick, device]. Without interleaving a device IS a
    stage (num_chunks == 1, ``chunk`` all zeros); with interleaving each
    device runs ``num_chunks`` virtual stages and ``chunk`` names the one
    active at each tick. ``load_in``/``is_head`` mark the ticks whose compute
    belongs to the global first/last model stage (replacing the
    device-position tests that stop working once stage identity varies per
    tick)."""

    num_ticks: int
    num_stages: int  # number of DEVICES on the pp axis
    num_micro_batches: int
    n_fwd_slots: int  # mailbox depths (trash slot = index n_slots)
    n_bwd_slots: int
    n_stash_slots: int  # activation-stash depth (trash = index n_stash_slots)
    is_training: bool
    op: np.ndarray  # (T, S) int32: OP_NOOP/FWD/BWD
    mb: np.ndarray  # (T, S) int32: microbatch id, trash = M
    read_fwd_slot: np.ndarray  # (T, S) int32: fwd-mail slot consumed, trash = K_f
    read_bwd_slot: np.ndarray  # (T, S) int32: bwd-mail slot consumed, trash = K_b
    in_fwd_slot: np.ndarray  # (T, S) int32: slot storing payload arriving from s-1
    in_bwd_slot: np.ndarray  # (T, S) int32: slot storing payload arriving from s+1
    send_fwd: np.ndarray  # (T, S) int32 0/1: emit fwd payload this tick
    send_bwd: np.ndarray  # (T, S) int32 0/1: emit bwd payload this tick
    stash_write: np.ndarray  # (T, S) int32: stash slot a forward fills (trash if none)
    stash_read: np.ndarray  # (T, S) int32: stash slot a backward consumes (trash)
    num_chunks: int = 1  # virtual stages per device (V)
    chunk: np.ndarray = None  # (T, S) int32: active virtual chunk (0 on noops)
    load_in: np.ndarray = None  # (T, S) int32 0/1: compute is global stage 0 fwd
    is_head: np.ndarray = None  # (T, S) int32 0/1: compute is the global last stage
    # split-backward extension (backward_split programs only): OP_BWD cells
    # are B-inputs, which PEEK the activation stash (masks/logits) without
    # freeing it and WRITE a grad-stash slot (the per-slot effective
    # output-grads); OP_BWD_W cells read+free both stashes. The activation
    # stash is therefore held from the forward to the B-WEIGHT tick, and
    # the grad stash from B-input to B-weight — both sized by the simulator
    # exactly like the activation stash, so the split schedule's extra
    # memory is a physical buffer shape, not prose.
    backward_split: bool = False
    n_gstash_slots: int = 0  # grad-stash depth (trash = index n_gstash_slots)
    stash_peek: np.ndarray = None  # (T, S) int32: stash slot a B-input consults
    gstash_write: np.ndarray = None  # (T, S) int32: grad-stash slot a B-input fills
    gstash_read: np.ndarray = None  # (T, S) int32: grad-stash slot a B-weight frees
    # activation-recompute extension (recompute programs only): OP_FWD cells
    # write the stage INPUT into an xin slot instead of residuals into the
    # activation stash; OP_RECOMPUTE cells read+free the xin slot, re-run
    # the forward and write the residual stash slot the backward consumes.
    # Global stage 0 skips the xin stash — its recompute reloads the
    # microbatch input directly (load_in marks those cells too).
    recompute: bool = False
    n_xin_slots: int = 0  # stage-input stash depth (trash = index n_xin_slots)
    xin_write: np.ndarray = None  # (T, S) int32: xin slot a forward fills
    xin_read: np.ndarray = None  # (T, S) int32: xin slot a recompute frees


class ScheduleLoweringError(ValueError):
    pass


def utilization(prog):
    """Active-cell fraction of a lowered program: computing (tick, device)
    cells / all cells. 1 - utilization is the bubble fraction of the pebble
    diagram (the blank cells of the reference's README.md:41 figure) — the
    schedule-quality number docs/lowering.md quotes (GPipe/1F1B 57% vs
    interleaved V=2 73% at P=4, M=4). Computed from the ACTUAL tick tables,
    so the documented bubble-shrink claims are testable artifacts, not prose.

    Note: cells are weighted equally. Across different ``num_chunks`` (V)
    an active cell is 1/(P·V) of the model, so equal per-cell WORK across
    compared layouts (same total model, same microbatches) is the caller's
    premise — true for the P-fixed comparisons the docs make. Equal
    weighting also cannot see the split-backward win (a combined backward
    cell is 2x a forward cell's FLOPs; splitting trades fewer heavy ticks
    for more uniform ones) — that is ``weighted_utilization``'s job.
    """
    active = int(np.sum(prog.op != OP_NOOP))
    return active / (prog.num_ticks * prog.num_stages)


def _op_weights(prog):
    """Per-op-code FLOP weights for this program, from the cost model's
    single source (``observability.costmodel.PIPELINE_OP_COSTS``): in a
    split program OP_BWD cells are B-inputs (dgrad only), in a combined
    program they are full backwards (dgrad + wgrad)."""
    C = PIPELINE_OP_COSTS
    bwd = C["bwd_in"] if prog.backward_split else C["bwd"]
    return np.array(
        [0.0, C["fwd"], bwd, C["bwd_w"], C["recompute"]], np.float64
    )


def weighted_makespan(prog):
    """FLOP-weighted makespan of the lowered program under the executor's
    lockstep tick model: every tick, each device runs its cell's op and the
    per-tick ``ppermute`` pair rejoins them, so a tick costs the MAXIMUM op
    weight across devices (a tick where one stage runs a combined backward
    while the rest forward costs a backward, not a forward). Weights come
    from ``costmodel.PIPELINE_OP_COSTS`` (fwd 1, combined bwd 2, split
    halves 1 each); the unit is one forward's work. All-noop ticks never
    occur in a lowered program (the greedy simulator always progresses), so
    their zero weight is unreachable."""
    w = _op_weights(prog)
    return float(w[np.asarray(prog.op)].max(axis=1).sum())


def weighted_utilization(prog):
    """FLOP-weighted active fraction: total cell work / (stages x weighted
    makespan). Unlike ``utilization`` this sees the split-backward win —
    splitting each 2-weight backward cell into two 1-weight halves shrinks
    the weighted makespan (backward-phase ticks stop costing double while
    the deferred halves fill former bubbles), so the weighted bubble
    fraction ``1 - weighted_utilization`` drops even where the equal-weight
    tick count grows. 1 - this is the number docs/lowering.md quotes for
    ``--backward-split``."""
    w = _op_weights(prog)
    span = weighted_makespan(prog)
    if span <= 0:
        return 1.0
    return float(w[np.asarray(prog.op)].sum() / (prog.num_stages * span))


def program_stats(prog, spec=None, mubatch_size=None, tp=1):
    """Static per-program telemetry: everything a metrics consumer needs to
    reason about a lowered schedule without replaying it — tick count, send
    volume, mailbox/stash footprints, per-device occupancy and the bubble
    fraction. Computed from the ACTUAL tick tables at lowering time (the
    executor's runtime per-tick behaviour is fully determined by them), so
    recording this once per program is the per-tick story with zero runtime
    cost. All values are plain Python scalars/lists — JSON-serializable as-is
    (the observability JSONL sink emits this dict verbatim).

    With ``spec`` + ``mubatch_size`` the dict additionally carries the
    PER-MODEL stash memory: ``stash_bytes_peak`` = slot count x slot
    activation bytes from the real spec's padded slot shapes (residual
    stash + the recompute xin stash + the split grad stash) — the number
    the report CLI's Memory section renders stashed-vs-recompute."""
    cells = prog.num_ticks * prog.num_stages
    util = utilization(prog)
    wutil = weighted_utilization(prog)
    # per-device occupancy: the fraction of ticks each pp device computes —
    # the per-row view of the pebble diagram (ramp devices idle longest)
    occupancy = [
        float(np.sum(prog.op[:, s] != OP_NOOP) / prog.num_ticks)
        for s in range(prog.num_stages)
    ]
    # per-op-kind cell counts: OP_BWD cells are B-inputs in a split
    # program, combined backwards otherwise (reported under the honest key)
    n_bwd = int(np.sum(prog.op == OP_BWD))
    stats = {
        "num_ticks": int(prog.num_ticks),
        "num_stages": int(prog.num_stages),
        "num_micro_batches": int(prog.num_micro_batches),
        "num_chunks": int(prog.num_chunks),
        "is_training": bool(prog.is_training),
        "backward_split": bool(prog.backward_split),
        "recompute": bool(prog.recompute),
        "active_cells": int(np.sum(prog.op != OP_NOOP)),
        "total_cells": int(cells),
        "cells_fwd": int(np.sum(prog.op == OP_FWD)),
        "cells_bwd": 0 if prog.backward_split else n_bwd,
        "cells_bwd_in": n_bwd if prog.backward_split else 0,
        "cells_bwd_w": int(np.sum(prog.op == OP_BWD_W)),
        "cells_recompute": int(np.sum(prog.op == OP_RECOMPUTE)),
        "sends_fwd": int(np.sum(prog.send_fwd)),
        "sends_bwd": int(np.sum(prog.send_bwd)),
        "fwd_mail_slots": int(prog.n_fwd_slots),
        "bwd_mail_slots": int(prog.n_bwd_slots),
        "stash_slots": int(prog.n_stash_slots),
        "grad_stash_slots": int(prog.n_gstash_slots),
        "xin_slots": int(prog.n_xin_slots),
        "stage_occupancy": occupancy,
        "utilization": float(util),
        "bubble_fraction": float(1.0 - util),
        "weighted_utilization": float(wutil),
        "weighted_bubble_fraction": float(1.0 - wutil),
    }
    if spec is not None and mubatch_size is not None:
        from shallowspeed_tpu_torch.parallel.executor import stash_slot_nbytes

        per = stash_slot_nbytes(spec, mubatch_size, tp=tp)
        stats["stash_bytes_per_slot"] = int(per["stash"])
        stats["xin_bytes_per_slot"] = int(per["xin"])
        stats["gstash_bytes_per_slot"] = int(per["gstash"])
        stats["stash_bytes_peak"] = int(
            prog.n_stash_slots * per["stash"]
            + prog.n_xin_slots * per["xin"]
            + prog.n_gstash_slots * per["gstash"]
        )
    return stats


def program_flops(prog, spec, mubatch_size, tp=1):
    """Analytical PADDED FLOPs for ONE execution of this tick program on one
    pp(x tp)-group: the hardware-work leg of the observability cost model
    (observability/costmodel.py; the logical model-FLOP leg is
    ``mlp_train_flops_per_sample``).

    Every computing cell runs the SPMD executor's full padded slot stack —
    a forward is ``2 * mb * sum(o_l * i_l)`` over the PADDED per-slot dims
    (executor.slot_shapes), a backward twice that (dgrad + wgrad) —
    regardless of the stage's logical widths; that uniformity is exactly
    what makes the program SPMD, and exactly why padded FLOPs exceed
    logical FLOPs. Computed from the ACTUAL tick tables (counts of
    OP_FWD/OP_BWD cells), so the padding-tax number is an artifact of the
    real lowered program, not a formula that can drift from it. Multiply by
    ``dp`` for the whole mesh (each replica runs the program on its shard).

    ``tp``: the tensor-parallel degree — slot dims are tp-rounded, the
    GROUP total is returned (the Megatron shards partition every matmul,
    so each of the pp x tp devices executes exactly 1/(pp*tp) of it;
    divide accordingly for a per-device bound, as ``expected_comms`` does).
    """
    from shallowspeed_tpu_torch.parallel.executor import slot_shapes

    padded_p = sum(o * i for o, i in slot_shapes(spec, tp))
    n_fwd = int(np.sum(prog.op == OP_FWD))
    n_bwd = int(np.sum(prog.op == OP_BWD))
    n_bwd_w = int(np.sum(prog.op == OP_BWD_W))
    # the recompute tax: every OP_RECOMPUTE cell re-runs a full stage
    # forward (2 units) — charged here so MFU and the cost-model
    # cross-check price recompute programs honestly
    n_rec = int(np.sum(prog.op == OP_RECOMPUTE))
    # split programs spread the backward's 4-unit work over an OP_BWD
    # (dgrad, 2) and an OP_BWD_W (wgrad, 2) cell: same total FLOPs
    bwd_unit = 2 if prog.backward_split else 4
    return (
        (2 * n_fwd + 2 * n_rec + bwd_unit * n_bwd + 2 * n_bwd_w)
        * mubatch_size
        * padded_p
    )


def program_comm_bytes(prog, spec, mubatch_size):
    """Analytical inter-stage traffic for ONE execution of this tick program
    — the pp-axis leg of the observability comms model
    (observability/program_audit.expected_comms).

    The executor relays with TWO uniform ``lax.ppermute``s (one per
    direction) EVERY tick, payload ``(mubatch_size, relay_width)`` f32 —
    masked no-op ticks ship zero payloads, but they are shipped (that
    uniformity is what makes the program SPMD), so the wire bytes each
    device moves per step are ``2 * num_ticks * payload``. The useful
    bytes (ticks whose send tables actually emit) ride alongside so the
    relay's own padding tax is a recorded number too. Computed from the
    ACTUAL tick tables, like ``program_stats``/``program_flops``.

    Returns plain scalars (JSON-able as-is): ``relay_payload_bytes`` (one
    direction, one tick), ``wire_bytes_per_device`` (2 x ticks x payload),
    ``useful_bytes_per_device`` (mean over devices of the send-table
    bytes), ``useful_sends`` (total send-table count), ``num_ticks``.

    This function covers the pp-axis relay only. The dp-axis gradient-sync
    leg — one anchor collective, or one collective PER BYTE-BUCKET when
    ``grad_bucket_bytes > 0`` — is modeled by
    ``parallel/gradsync.sync_comm_bytes`` (same per-bucket numbers the
    executor's emitters lower and the program audit verifies).
    """
    from shallowspeed_tpu_torch.parallel.executor import relay_width

    payload = 4 * mubatch_size * relay_width(spec)
    useful_sends = int(np.sum(prog.send_fwd) + np.sum(prog.send_bwd))
    return {
        "relay_payload_bytes": int(payload),
        "num_ticks": int(prog.num_ticks),
        "wire_bytes_per_device": int(2 * prog.num_ticks * payload),
        "useful_sends": useful_sends,
        "useful_bytes_per_device": useful_sends * payload / prog.num_stages,
    }


def parse_stage_stream(commands, stage_id, num_stages, training=True, num_chunks=1):
    """Flatten one device's instruction stream into WorkItems + validate.

    Recv/Load instructions bind to the NEXT compute; Send instructions bind
    to the PREVIOUS compute — the same dataflow the reference Worker's buffer
    semantics imply (pipe.py:355-406: recv fills the buffer the next
    forward/backward reads; send ships the buffer the last compute wrote).

    Endpoint rules are in terms of the GLOBAL model stage ``chunk * P +
    device``: only stage 0 loads inputs / cannot receive activations or send
    input-grads; only stage S-1 loads targets / cannot receive output-grads
    or send activations. With num_chunks == 1 these reduce to the
    device-position rules.
    """
    last_stage_g = num_chunks * num_stages - 1

    def stage_g(chunk):
        return chunk * num_stages + stage_id

    items = []
    pend_fwd_msg = pend_bwd_msg = False
    seen_zero = seen_opt = False
    has_combined = has_split = False
    bin_keys, bww_keys = set(), set()  # (chunk, mubatch) with a B-in / B-w
    rec_keys = set()  # (chunk, mubatch) with a RecomputeForward
    for cmd in commands:
        if isinstance(cmd, S.ZeroGrad):
            if items or seen_zero:
                raise ScheduleLoweringError("ZeroGrad must be the first instruction")
            seen_zero = True
        elif isinstance(cmd, S.OptimizerStep):
            if seen_opt:
                raise ScheduleLoweringError("duplicate OptimizerStep")
            seen_opt = True
        elif isinstance(cmd, S.RecvActivations):
            if num_chunks == 1 and stage_id == 0:
                raise ScheduleLoweringError("stage 0 cannot RecvActivations")
            if pend_fwd_msg:
                raise ScheduleLoweringError("two RecvActivations before a Forward")
            pend_fwd_msg = True
        elif isinstance(cmd, S.RecvOutputGrad):
            if num_chunks == 1 and stage_id == num_stages - 1:
                raise ScheduleLoweringError("last stage cannot RecvOutputGrad")
            if pend_bwd_msg:
                raise ScheduleLoweringError("two RecvOutputGrads before a Backward")
            pend_bwd_msg = True
        elif isinstance(cmd, S.LoadMuBatchInput):
            if stage_id != 0:
                raise ScheduleLoweringError("only stage 0 loads inputs")
        elif isinstance(cmd, S.LoadMuBatchTarget):
            if stage_id != num_stages - 1:
                raise ScheduleLoweringError("only the last stage loads targets")
        elif isinstance(cmd, S.Forward):
            if seen_opt:
                raise ScheduleLoweringError("compute after OptimizerStep")
            if pend_bwd_msg:
                raise ScheduleLoweringError("RecvOutputGrad not consumed by a Backward")
            if pend_fwd_msg and stage_g(cmd.chunk_id) == 0:
                raise ScheduleLoweringError("global stage 0 cannot RecvActivations")
            items.append(
                WorkItem(
                    OP_FWD, cmd.mubatch_id, chunk=cmd.chunk_id,
                    needs_fwd_msg=pend_fwd_msg,
                )
            )
            pend_fwd_msg = False
        elif isinstance(cmd, S.RecomputeForward):
            # re-materializes residuals from the stashed stage input: no
            # messages in or out, like the deferred B-weight half
            if seen_opt:
                raise ScheduleLoweringError("compute after OptimizerStep")
            if pend_fwd_msg or pend_bwd_msg:
                raise ScheduleLoweringError(
                    "a Recv cannot bind to a RecomputeForward (it consumes "
                    "no messages — only the stashed stage input)"
                )
            key = (cmd.chunk_id, cmd.mubatch_id)
            if key in rec_keys:
                raise ScheduleLoweringError(
                    f"duplicate RecomputeForward for microbatch {cmd.mubatch_id}"
                )
            rec_keys.add(key)
            items.append(
                WorkItem(OP_RECOMPUTE, cmd.mubatch_id, chunk=cmd.chunk_id)
            )
        elif isinstance(cmd, (S.BackwardGradAcc, S.BackwardGradAllReduce)):
            if seen_opt:
                raise ScheduleLoweringError("compute after OptimizerStep")
            if pend_fwd_msg:
                raise ScheduleLoweringError("RecvActivations not consumed by a Forward")
            if pend_bwd_msg and stage_g(cmd.chunk_id) == last_stage_g:
                raise ScheduleLoweringError("global last stage cannot RecvOutputGrad")
            if rec_keys and (cmd.chunk_id, cmd.mubatch_id) not in rec_keys:
                raise ScheduleLoweringError(
                    f"Backward for microbatch {cmd.mubatch_id} precedes its "
                    "RecomputeForward (the backward consumes the residuals "
                    "the recompute re-materializes)"
                )
            has_combined = True
            items.append(
                WorkItem(
                    OP_BWD,
                    cmd.mubatch_id,
                    chunk=cmd.chunk_id,
                    needs_bwd_msg=pend_bwd_msg,
                    allreduce=isinstance(cmd, S.BackwardGradAllReduce),
                )
            )
            pend_bwd_msg = False
        elif isinstance(cmd, S.BackwardInputGradAcc):
            # the relay-critical half: same message structure as the
            # combined backward (consumes the output-grad, may send dx)
            if seen_opt:
                raise ScheduleLoweringError("compute after OptimizerStep")
            if pend_fwd_msg:
                raise ScheduleLoweringError("RecvActivations not consumed by a Forward")
            if pend_bwd_msg and stage_g(cmd.chunk_id) == last_stage_g:
                raise ScheduleLoweringError("global last stage cannot RecvOutputGrad")
            if rec_keys and (cmd.chunk_id, cmd.mubatch_id) not in rec_keys:
                raise ScheduleLoweringError(
                    f"BackwardInputGrad for microbatch {cmd.mubatch_id} "
                    "precedes its RecomputeForward (the B-input consults the "
                    "residuals the recompute re-materializes)"
                )
            has_split = True
            bin_keys.add((cmd.chunk_id, cmd.mubatch_id))
            items.append(
                WorkItem(
                    OP_BWD,
                    cmd.mubatch_id,
                    chunk=cmd.chunk_id,
                    needs_bwd_msg=pend_bwd_msg,
                )
            )
            pend_bwd_msg = False
        elif isinstance(cmd, S.BackwardWeightGradAcc):
            # the deferred half: no messages in or out — only the stashes
            if seen_opt:
                raise ScheduleLoweringError("compute after OptimizerStep")
            if pend_fwd_msg or pend_bwd_msg:
                raise ScheduleLoweringError(
                    "a Recv cannot bind to a BackwardWeightGrad (it consumes "
                    "no messages — only the activation and grad stashes)"
                )
            key = (cmd.chunk_id, cmd.mubatch_id)
            if key not in bin_keys:
                raise ScheduleLoweringError(
                    f"BackwardWeightGrad for microbatch {cmd.mubatch_id} "
                    "precedes its BackwardInputGrad (the weight half reads "
                    "the grad stash the input half fills)"
                )
            if key in bww_keys:
                raise ScheduleLoweringError(
                    f"duplicate BackwardWeightGrad for microbatch {cmd.mubatch_id}"
                )
            has_split = True
            bww_keys.add(key)
            items.append(
                WorkItem(
                    OP_BWD_W,
                    cmd.mubatch_id,
                    chunk=cmd.chunk_id,
                    allreduce=isinstance(cmd, S.BackwardWeightGradAllReduce),
                )
            )
        elif isinstance(cmd, S.SendActivations):
            if not items or items[-1].kind != OP_FWD or items[-1].sends_fwd:
                raise ScheduleLoweringError(
                    "SendActivations must directly follow its Forward"
                )
            if stage_g(items[-1].chunk) == last_stage_g:
                raise ScheduleLoweringError("global last stage cannot SendActivations")
            items[-1] = dataclasses.replace(items[-1], sends_fwd=True)
        elif isinstance(cmd, S.SendInputGrad):
            if not items or items[-1].kind != OP_BWD or items[-1].sends_bwd:
                raise ScheduleLoweringError(
                    "SendInputGrad must directly follow its Backward"
                )
            if stage_g(items[-1].chunk) == 0:
                raise ScheduleLoweringError("global stage 0 cannot SendInputGrad")
            items[-1] = dataclasses.replace(items[-1], sends_bwd=True)
        else:
            raise ScheduleLoweringError(f"unknown instruction {cmd!r}")
    if pend_fwd_msg or pend_bwd_msg:
        raise ScheduleLoweringError("dangling Recv with no consuming compute")
    if training and not (seen_zero and seen_opt):
        raise ScheduleLoweringError("training stream must bracket with ZeroGrad/OptimizerStep")
    if has_combined and has_split:
        raise ScheduleLoweringError(
            "stream mixes combined Backward and split BackwardInput/"
            "BackwardWeight instructions — a program is split or it is not"
        )
    for it in items:
        if not 0 <= it.chunk < num_chunks:
            raise ScheduleLoweringError(f"chunk {it.chunk} out of range [0,{num_chunks})")
    return items


class _Mailbox:
    """Receiver-side slot allocator for one direction at one device."""

    def __init__(self):
        self.free_from = []  # per slot: earliest tick this slot may take an arrival
        self.msgs = []  # FIFO of (sent_tick, slot, key)

    def deliver(self, tick, key):
        for i, f in enumerate(self.free_from):
            if f <= tick:
                self.free_from[i] = np.inf  # occupied
                self.msgs.append((tick, i, key))
                return i
        self.free_from.append(np.inf)
        self.msgs.append((tick, len(self.free_from) - 1, key))
        return len(self.free_from) - 1

    def _find(self, tick, key):
        for i, (sent, _, k) in enumerate(self.msgs):
            if sent < tick and k == key:
                return i
        return None

    def consumable(self, tick, key):
        """A delivered message for exactly this (chunk, microbatch) is
        available. Binding consumption by key (not FIFO position) both
        supports out-of-order consumers and turns sender/receiver order
        mismatches into visible deadlocks instead of silently mispairing
        activations."""
        return self._find(tick, key) is not None

    def consume(self, tick, key):
        i = self._find(tick, key)
        assert i is not None
        _, slot, _ = self.msgs.pop(i)
        self.free_from[slot] = tick  # reusable for arrivals this very tick
        return slot

    @property
    def depth(self):
        return len(self.free_from)


def lower_schedule(
    schedule_cls,
    num_micro_batches,
    num_stages,
    training=None,
    virtual=1,
    backward_split=False,
    recompute=False,
):
    """Compile a Schedule class into a TickProgram.

    ``num_stages`` is the number of pp DEVICES; ``virtual`` (V) is the number
    of virtual stages per device for interleaved schedules (the model has
    ``num_stages * virtual`` stages, stage ``s`` on device ``s % num_stages``
    as chunk ``s // num_stages``). V=1 is the ordinary one-stage-per-device
    case.

    ``backward_split``: lower the schedule's two-stage backward (B-input /
    B-weight) variant. B-inputs keep exactly the combined backward's ticks
    (same message structure, so the greedy simulation reproduces the same
    placement); B-weight items have no dependencies beyond their own
    B-input and are DEFERRED — each tick a stage first tries its next
    F/B-input item and, only when that is message-blocked or exhausted,
    runs its oldest pending B-weight instead, packing the weight halves
    into what were bubble ticks. FIFO deferral preserves the per-stage
    weight-grad accumulation order of the combined schedule (bit-identical
    fp sums); the verifier additionally rejects streams whose B-weight
    order disagrees with their B-input order, a B-weight without (or
    before) its B-input, and a DP anchor anywhere but the final B-weight.
    """
    if issubclass(schedule_cls, S.InterleavedSchedule):
        if backward_split:
            raise ScheduleLoweringError(
                "backward_split is not supported for interleaved schedules "
                "(the virtual-chunk steady state interleaves its own "
                "chunks; splitting its backward is future work)"
            )
        if recompute:
            raise ScheduleLoweringError(
                "recompute is not supported for interleaved schedules "
                "(per-chunk input stashes under the virtual-chunk steady "
                "state are future work)"
            )
        kw = {"num_chunks": virtual}  # V=1 degenerates to one chunk per device
    elif virtual != 1:
        raise ScheduleLoweringError(
            f"virtual={virtual} requires an interleaved schedule; "
            f"{schedule_cls.__name__} places one stage per device"
        )
    else:
        kw = {}
        if backward_split:
            kw["backward_split"] = True
        if recompute:
            kw["recompute"] = True
    streams = [
        S.flat_commands(
            schedule_cls(
                num_micro_batches=num_micro_batches,
                num_stages=num_stages,
                stage_id=s,
                **kw,
            )
        )
        for s in range(num_stages)
    ]
    if training is None:
        training = any(isinstance(c, S.OptimizerStep) for c in streams[0])
    stage_items = [
        parse_stage_stream(streams[s], s, num_stages, training, num_chunks=virtual)
        for s in range(num_stages)
    ]

    # a program is split iff any stage deferred weight grads — and then
    # every backward-bearing stage must be split the same way (each stage's
    # own stream already rejects intra-stream mixing)
    split = any(i.kind == OP_BWD_W for items in stage_items for i in items)
    if split:
        for s, items in enumerate(stage_items):
            if any(i.kind == OP_BWD for i in items) and not any(
                i.kind == OP_BWD_W for i in items
            ):
                raise ScheduleLoweringError(
                    f"stage {s}: combined backwards in a split program "
                    "(every stage must defer its weight grads or none may)"
                )

    # a program recomputes iff any stage emitted recompute cells — and then
    # every backward-bearing stage must recompute too (the executor's
    # forward branch stops stashing residuals program-wide)
    rec = any(i.kind == OP_RECOMPUTE for items in stage_items for i in items)
    if rec:
        for s, items in enumerate(stage_items):
            if any(i.kind == OP_BWD for i in items) and not any(
                i.kind == OP_RECOMPUTE for i in items
            ):
                raise ScheduleLoweringError(
                    f"stage {s}: backwards without RecomputeForwards in a "
                    "recompute program (every stage re-materializes its "
                    "residuals or none does)"
                )

    # validate per-device (chunk, microbatch) coverage
    want = sorted(
        (c, mb) for c in range(virtual) for mb in range(num_micro_batches)
    )
    for s, items in enumerate(stage_items):
        fwd = sorted((i.chunk, i.mubatch_id) for i in items if i.kind == OP_FWD)
        if fwd != want:
            raise ScheduleLoweringError(f"stage {s}: forwards {fwd} != chunks x 0..M-1")
        if training:
            bwd = sorted((i.chunk, i.mubatch_id) for i in items if i.kind == OP_BWD)
            if bwd != want:
                raise ScheduleLoweringError(f"stage {s}: backwards {bwd} != chunks x 0..M-1")
            if rec:
                rcs = sorted(
                    (i.chunk, i.mubatch_id)
                    for i in items
                    if i.kind == OP_RECOMPUTE
                )
                if rcs != want:
                    raise ScheduleLoweringError(
                        f"stage {s}: recomputes {rcs} != chunks x 0..M-1"
                    )
            if split:
                # exactly one B-weight per B-input, in the SAME per-stage
                # order: the weight-grad accumulators sum per microbatch in
                # B-weight order, so matching the B-input (= combined
                # backward) order is what keeps the fp sum — and therefore
                # the weight hash — bit-identical to the unsplit schedule
                bin_seq = [
                    (i.chunk, i.mubatch_id) for i in items if i.kind == OP_BWD
                ]
                bww_seq = [
                    (i.chunk, i.mubatch_id) for i in items if i.kind == OP_BWD_W
                ]
                if sorted(bww_seq) != want:
                    raise ScheduleLoweringError(
                        f"stage {s}: B-weights {sorted(bww_seq)} != chunks x 0..M-1"
                    )
                if bww_seq != bin_seq:
                    raise ScheduleLoweringError(
                        f"stage {s}: B-weight order {bww_seq} must match the "
                        f"B-input order {bin_seq} (weight-grad accumulation "
                        "order is the bitwise-parity contract)"
                    )
            ars = [i for i in items if i.allreduce]
            if split:
                bwws = [i for i in items if i.kind == OP_BWD_W]
                if len(ars) != 1 or bwws[-1] is not ars[0]:
                    raise ScheduleLoweringError(
                        f"stage {s}: the DP anchor must be exactly the final "
                        "B-weight (the gradient is incomplete until the last "
                        "deferred weight half lands)"
                    )
            else:
                bwds = [i for i in items if i.kind == OP_BWD]
                if len(ars) != 1 or bwds[-1] is not ars[0]:
                    raise ScheduleLoweringError(
                        f"stage {s}: BackwardGradAllReduce must be exactly the final backward"
                    )

    # --- greedy tick simulation -------------------------------------------
    # one compute per DEVICE per tick; messages keyed (chunk, microbatch).
    # Forward sends from device d chunk c go to the global next stage, which
    # is ALWAYS device (d+1) % P: chunk c for d < P-1, chunk c+1 on the ring
    # wrap d = P-1 -> 0. Backward mirrors it. That ring structure is why the
    # executor can use one uniform ppermute shift per direction.
    P = num_stages
    last_stage_g = virtual * P - 1
    ptr = [0] * P
    fwd_mail = [_Mailbox() for _ in range(P)]  # from the prior stage
    bwd_mail = [_Mailbox() for _ in range(P)]  # from the next stage
    # activation-stash allocation (training only): a forward claims a slot
    # for its residuals; the matching backward frees it (the B-WEIGHT in a
    # split program — the deferred wgrad still reads the activations, so
    # deferral extends the stash lifetime; the higher slot peak is the
    # split schedule's honest extra memory). Slot pressure is therefore the
    # schedule's REAL activation memory — GPipe peaks at M,
    # PipeDream-Flush at min(M, depth - stage): 1F1B's memory advantage
    # becomes physical buffer sizes, not just an instruction-stream property.
    stash_free_from = [[] for _ in range(P)]  # per device, per slot
    stash_of = [dict() for _ in range(P)]  # (chunk, mubatch) -> slot
    # grad-stash allocation (split programs): a B-input claims a slot for
    # the per-slot effective output-grads; the matching B-weight frees it.
    # Same discipline as the activation stash — held exactly from the
    # B-input tick to the B-weight tick, peak depth becomes buffer shapes.
    gstash_free_from = [[] for _ in range(P)]
    gstash_of = [dict() for _ in range(P)]
    # stage-input stash allocation (recompute programs): a forward claims a
    # slot for its INPUT (global stage 0 exempt — its recompute reloads the
    # microbatch from HBM); the matching recompute frees it and claims the
    # residual-stash slot instead. The residual stash is therefore held
    # only recompute->backward — the measurably lower peak the stash
    # analysis asserts.
    xin_free_from = [[] for _ in range(P)]
    xin_of = [dict() for _ in range(P)]
    # deferred B-weight items, FIFO per stage (FIFO = B-input order = the
    # combined schedule's accumulation order, the bitwise-parity contract)
    pending_w = [deque() for _ in range(P)]
    rows = []  # per tick: list of per-device dicts
    t = 0
    # recompute programs run one extra compute cell per (chunk, microbatch)
    limit = (5 if rec else 4) * virtual * num_micro_batches * P + 8 * virtual * P + 16
    while any(
        ptr[s] < len(stage_items[s]) or pending_w[s] for s in range(P)
    ):
        if t > limit:
            raise ScheduleLoweringError("schedule failed to converge (livelock?)")
        row = [
            dict(
                op=OP_NOOP, mb=num_micro_batches, rf=-1, rb=-1, sf=0, sb=0,
                inf=-1, inb=-1, sw=-1, sr=-1, ck=0, li=0, ih=0,
                sp=-1, gw=-1, gr=-1, xw=-1, xr=-1,
            )
            for _ in range(P)
        ]
        arrivals = []  # (direction, to_device, key)
        progressed = False
        for s in range(P):
            items = stage_items[s]
            # defer B-weights as the pointer reaches them: no message
            # dependencies, so they wait for an idle tick instead of
            # delaying the relay-critical stream behind them
            while ptr[s] < len(items) and items[ptr[s]].kind == OP_BWD_W:
                pending_w[s].append(items[ptr[s]])
                ptr[s] += 1
            item = items[ptr[s]] if ptr[s] < len(items) else None
            blocked = item is None or (
                item.needs_fwd_msg
                and not fwd_mail[s].consumable(t, (item.chunk, item.mubatch_id))
            ) or (
                item.needs_bwd_msg
                and not bwd_mail[s].consumable(t, (item.chunk, item.mubatch_id))
            )
            if blocked:
                if not pending_w[s]:
                    continue  # a true bubble tick
                # pack the oldest deferred B-weight into this bubble
                w = pending_w[s].popleft()
                key = (w.chunk, w.mubatch_id)
                r = row[s]
                r["op"], r["mb"], r["ck"] = OP_BWD_W, w.mubatch_id, w.chunk
                slot = stash_of[s].pop(key)
                stash_free_from[s][slot] = t + 1  # activations done
                r["sr"] = slot
                gslot = gstash_of[s].pop(key)
                gstash_free_from[s][gslot] = t + 1
                r["gr"] = gslot
                progressed = True
                continue
            if (
                item.kind == OP_RECOMPUTE
                and pending_w[s]
                and stash_free_from[s]
                and all(f > t for f in stash_free_from[s])
            ):
                # Drain a deferred B-weight BEFORE starting the next
                # microbatch's recompute when every residual-stash slot is
                # occupied: the B-weight frees its slot, so the recompute
                # about to claim one reuses it instead of growing the peak.
                # Without this rule a split-backward drain phase holds all M
                # stashes (every tick has r/B work, so B-weights never pack
                # into bubbles) and recompute buys no peak reduction. FIFO
                # order is preserved — same accumulation order as the
                # stashed twin, so bitwise parity holds; the cost is
                # delaying the relay stream by one tick per drained
                # B-weight, the memory-for-time recompute trade.
                w = pending_w[s].popleft()
                wkey = (w.chunk, w.mubatch_id)
                r = row[s]
                r["op"], r["mb"], r["ck"] = OP_BWD_W, w.mubatch_id, w.chunk
                slot = stash_of[s].pop(wkey)
                stash_free_from[s][slot] = t + 1
                r["sr"] = slot
                gslot = gstash_of[s].pop(wkey)
                gstash_free_from[s][gslot] = t + 1
                r["gr"] = gslot
                progressed = True
                continue
            key = (item.chunk, item.mubatch_id)
            # execute item at tick t
            stage_g = item.chunk * P + s
            r = row[s]
            r["op"], r["mb"], r["ck"] = item.kind, item.mubatch_id, item.chunk
            r["li"] = int(
                stage_g == 0 and item.kind in (OP_FWD, OP_RECOMPUTE)
            )
            r["ih"] = int(stage_g == last_stage_g)
            if item.needs_fwd_msg:
                r["rf"] = fwd_mail[s].consume(t, key)
            if item.needs_bwd_msg:
                r["rb"] = bwd_mail[s].consume(t, key)
            if training and item.kind == OP_FWD:
                if rec:
                    # stash the stage INPUT only; residuals wait for the
                    # recompute (global stage 0 reloads from HBM instead)
                    if stage_g != 0:
                        xfree = xin_free_from[s]
                        for xslot, f in enumerate(xfree):
                            if f <= t:
                                break
                        else:
                            xfree.append(0)
                            xslot = len(xfree) - 1
                        xfree[xslot] = np.inf  # held until the recompute
                        xin_of[s][key] = xslot
                        r["xw"] = xslot
                else:
                    free = stash_free_from[s]
                    for slot, f in enumerate(free):
                        if f <= t:
                            break
                    else:
                        free.append(0)
                        slot = len(free) - 1
                    free[slot] = np.inf  # occupied until the matching backward
                    stash_of[s][key] = slot
                    r["sw"] = slot
            elif training and item.kind == OP_RECOMPUTE:
                # free the input stash and claim the residual-stash slot the
                # imminent backward consumes — the short stash lifetime
                if stage_g != 0:
                    xslot = xin_of[s].pop(key)
                    xin_free_from[s][xslot] = t + 1
                    r["xr"] = xslot
                free = stash_free_from[s]
                for slot, f in enumerate(free):
                    if f <= t:
                        break
                else:
                    free.append(0)
                    slot = len(free) - 1
                free[slot] = np.inf  # occupied until the matching backward
                stash_of[s][key] = slot
                r["sw"] = slot
            elif training and item.kind == OP_BWD:
                if split:
                    # B-input: PEEK the activation stash (masks + logits;
                    # the B-weight frees it) and claim a grad-stash slot
                    r["sp"] = stash_of[s][key]
                    gfree = gstash_free_from[s]
                    for gslot, f in enumerate(gfree):
                        if f <= t:
                            break
                    else:
                        gfree.append(0)
                        gslot = len(gfree) - 1
                    gfree[gslot] = np.inf  # held until the matching B-weight
                    gstash_of[s][key] = gslot
                    r["gw"] = gslot
                else:
                    slot = stash_of[s].pop(key)
                    stash_free_from[s][slot] = t + 1  # reusable next tick
                    r["sr"] = slot
            if item.sends_fwd:
                r["sf"] = 1
                dst = (s + 1) % P
                dst_chunk = item.chunk + (1 if s == P - 1 else 0)
                arrivals.append(("fwd", dst, (dst_chunk, item.mubatch_id)))
            if item.sends_bwd:
                r["sb"] = 1
                dst = (s - 1) % P
                dst_chunk = item.chunk - (1 if s == 0 else 0)
                arrivals.append(("bwd", dst, (dst_chunk, item.mubatch_id)))
            ptr[s] += 1
            progressed = True
        if not progressed:
            state = [(s, ptr[s], len(stage_items[s])) for s in range(P)]
            raise ScheduleLoweringError(f"deadlock at tick {t}: {state}")
        for direction, dst, key in arrivals:
            mail = fwd_mail[dst] if direction == "fwd" else bwd_mail[dst]
            slot = mail.deliver(t, key)
            row[dst]["inf" if direction == "fwd" else "inb"] = slot
        rows.append(row)
        t += 1

    for s in range(num_stages):
        if fwd_mail[s].msgs or bwd_mail[s].msgs:
            raise ScheduleLoweringError(f"stage {s}: unconsumed messages at end")

    for s in range(num_stages):
        if stash_of[s]:
            raise ScheduleLoweringError(f"stage {s}: unfreed activation stash")
        if gstash_of[s]:
            raise ScheduleLoweringError(f"stage {s}: unfreed grad stash")
        if xin_of[s]:
            raise ScheduleLoweringError(f"stage {s}: unfreed input stash")

    K_f = max((m.depth for m in fwd_mail), default=0) or 1
    K_b = max((m.depth for m in bwd_mail), default=0) or 1
    K_s = max((len(f) for f in stash_free_from), default=0) or 1
    K_g = max((len(f) for f in gstash_free_from), default=0) if split else 0
    K_x = max((len(f) for f in xin_free_from), default=0) if rec else 0
    T = len(rows)

    def table(key, trash):
        out = np.full((T, num_stages), 0, dtype=np.int32)
        for ti, row in enumerate(rows):
            for s in range(num_stages):
                v = row[s][key]
                out[ti, s] = trash if v == -1 else v
        return out

    def raw(key):
        return np.array(
            [[r[s][key] for s in range(num_stages)] for r in rows], np.int32
        )

    return TickProgram(
        num_ticks=T,
        num_stages=num_stages,
        num_micro_batches=num_micro_batches,
        n_fwd_slots=K_f,
        n_bwd_slots=K_b,
        n_stash_slots=K_s,
        is_training=training,
        op=raw("op"),
        mb=raw("mb"),
        read_fwd_slot=table("rf", K_f),
        read_bwd_slot=table("rb", K_b),
        in_fwd_slot=table("inf", K_f),
        in_bwd_slot=table("inb", K_b),
        send_fwd=raw("sf"),
        send_bwd=raw("sb"),
        stash_write=table("sw", K_s),
        stash_read=table("sr", K_s),
        num_chunks=virtual,
        chunk=raw("ck"),
        load_in=raw("li"),
        is_head=raw("ih"),
        backward_split=split,
        n_gstash_slots=K_g,
        stash_peek=table("sp", K_s),
        gstash_write=table("gw", K_g),
        gstash_read=table("gr", K_g),
        recompute=rec,
        n_xin_slots=K_x,
        xin_write=table("xw", K_x),
        xin_read=table("xr", K_x),
    )
