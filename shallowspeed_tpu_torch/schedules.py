"""Pipeline schedules as pure instruction streams.

The port's copy of ``shallowspeed_tpu/schedules.py`` (pure Python);
``tests/test_torch_lowering.py`` holds every instruction stream equal to
the JAX package's.

This preserves the reference's best abstraction (pipe.py:12-299): a schedule
is trace-time *data* — a generator of steps, each step a list of small
dataclass instructions — with zero knowledge of communication or arrays. The
TPU twist is what consumes them: instead of an MPI-interpreting Worker, the
``parallel.lowering`` module compiles the per-stage instruction streams into a
static clock-tick program executed SPMD under shard_map (MPMD -> SPMD).

Instruction set parity (reference pipe.py:12-138): ZeroGrad, OptimizerStep,
Recv/SendActivations, Recv/SendOutputGrad/InputGrad, Forward,
BackwardGradAcc, BackwardGradAllReduce, LoadMuBatchInput/Target — plus the
split-backward trio beyond the reference (``backward_split=True``):
BackwardInputGradAcc (the relay-critical dx half, at the combined
backward's tick), BackwardWeightGradAcc (the deferrable dW/db half, packed
into bubble ticks by the lowering) and BackwardWeightGradAllReduce (the
DP-sync anchor, moved to the final weight half).

Schedules: Naive (pipe.py:184-222), GPipe (pipe.py:225-272), Inference
(pipe.py:275-294) — and PipeDream-Flush (1F1B), which the reference declares
but leaves as a ``raise NotImplementedError`` stub (pipe.py:297-299); here it
is fully implemented.
"""

import dataclasses
from abc import ABC, abstractmethod


# ---------------------------------------------------------------------------
# Instruction set: the schedule <-> executor contract.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Instruction:
    pass


@dataclasses.dataclass(frozen=True)
class ZeroGrad(Instruction):
    """Reset gradient accumulators (start of every training batch)."""


@dataclasses.dataclass(frozen=True)
class OptimizerStep(Instruction):
    """Apply the optimizer update (end of every training batch)."""


@dataclasses.dataclass(frozen=True)
class BufferInstruction(Instruction):
    buffer_id: int = 0


@dataclasses.dataclass(frozen=True)
class RecvActivations(BufferInstruction):
    """Receive the forward activations of a microbatch from stage-1."""


@dataclasses.dataclass(frozen=True)
class SendActivations(BufferInstruction):
    """Send this stage's forward output for a microbatch to stage+1."""


@dataclasses.dataclass(frozen=True)
class RecvOutputGrad(BufferInstruction):
    """Receive d(loss)/d(stage output) for a microbatch from stage+1."""


@dataclasses.dataclass(frozen=True)
class SendInputGrad(BufferInstruction):
    """Send d(loss)/d(stage input) for a microbatch to stage-1."""


@dataclasses.dataclass(frozen=True)
class ComputeInstruction(Instruction):
    buffer_id: int = 0
    mubatch_id: int = 0
    chunk_id: int = 0  # virtual-stage chunk on this device (interleaved only)


@dataclasses.dataclass(frozen=True)
class Forward(ComputeInstruction):
    """Forward one microbatch through the local stage, stashing residuals."""


@dataclasses.dataclass(frozen=True)
class RecomputeForward(ComputeInstruction):
    """Activation recompute (torchgpipe, arxiv 2004.09910): re-run the local
    stage forward for one microbatch from the stashed STAGE INPUT — the
    character-identical forward expressions — re-materializing the per-slot
    residuals right before the backward consumes them. Emitted only under
    ``Schedule(recompute=True)``, immediately ahead of each backward step;
    no messages in or out (the input was stashed at the forward tick)."""


@dataclasses.dataclass(frozen=True)
class BackwardGradAcc(ComputeInstruction):
    """Backward one microbatch, accumulating into the gradient buffers."""


@dataclasses.dataclass(frozen=True)
class BackwardGradAllReduce(ComputeInstruction):
    """Backward + DP gradient all-reduce. Appears exactly once per batch, on
    the final backward microbatch — it marks WHERE the cross-replica psum is
    allowed to overlap the remaining backward compute (reference
    pipe.py:108-122, 302-327). The SPMD executor lowers it to jax.lax.psum
    over the ``dp`` mesh axis; XLA's latency-hiding scheduler provides the
    compute/communication overlap the reference hand-rolls with Iallreduce."""


@dataclasses.dataclass(frozen=True)
class BackwardInputGradAcc(ComputeInstruction):
    """The relay-critical HALF of a split backward (2BP, arxiv 2405.18047):
    compute d(loss)/d(stage input) for one microbatch — dx from W and the
    relu masks only — and stash the per-slot effective output-grads for the
    deferred weight half. This is the only backward product the upstream
    stage waits for, so it runs (and relays, via a following SendInputGrad)
    at exactly the tick the combined backward would have."""


@dataclasses.dataclass(frozen=True)
class BackwardWeightGradAcc(ComputeInstruction):
    """The deferrable HALF of a split backward: dW/db for one microbatch
    from the stashed activation and the stashed output-grad, accumulated
    into the gradient buffers. No messages in or out — the lowering packs
    these greedily into otherwise-idle bubble ticks, preserving the
    per-stage accumulation order of the combined schedule (so the fp sum,
    and therefore the weight hash, is bit-identical)."""


@dataclasses.dataclass(frozen=True)
class BackwardWeightGradAllReduce(BackwardWeightGradAcc):
    """Split-schedule DP-sync anchor: the FINAL weight-grad compute of the
    batch. In a split schedule the gradient is not complete until the last
    deferred B-weight lands, so the all-reduce anchor moves here from the
    final backward (every B-weight completes before the dp psum)."""


@dataclasses.dataclass(frozen=True)
class LoadInstruction(Instruction):
    mubatch_id: int = 0
    buffer_id: int = 0


@dataclasses.dataclass(frozen=True)
class LoadMuBatchInput(LoadInstruction):
    """First stage only: load a microbatch of inputs into the input buffer."""


@dataclasses.dataclass(frozen=True)
class LoadMuBatchTarget(LoadInstruction):
    """Last stage only: load a microbatch of targets into the output buffer
    (the backward pass consumes targets where upstream grads would sit)."""


# ---------------------------------------------------------------------------
# Schedule ABC (reference pipe.py:141-181).
# ---------------------------------------------------------------------------


class Schedule(ABC):
    """Emits, for ONE pipeline stage, an ordered stream of instruction steps.

    Pure data: no arrays, no communication — which is exactly why it can be
    unit-tested stream-wise and compiled to a clock-tick program.
    """

    def __init__(
        self,
        num_micro_batches: int,
        num_stages: int,
        stage_id: int,
        backward_split: bool = False,
        recompute: bool = False,
    ):
        assert num_micro_batches > 0 and num_stages > 0
        assert 0 <= stage_id < num_stages
        self.num_micro_batches = num_micro_batches
        self.num_stages = num_stages
        self.stage_id = stage_id
        # two-stage backward: emit BackwardInputGradAcc + a deferred
        # BackwardWeightGradAcc per microbatch instead of the combined
        # Backward (the lowering packs the weight halves into bubble ticks)
        self.backward_split = backward_split
        # activation recompute: the forward stashes only the stage INPUT;
        # a RecomputeForward re-materializes the residuals right before
        # each backward step (torchgpipe trade: FLOPs for stash peak)
        self.recompute = recompute

    @abstractmethod
    def steps(self):
        """Yield lists of Instructions, in per-stage program order."""

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.num_stages - 1

    def is_first_mubatch(self, mubatch_id):
        return mubatch_id == 0

    def is_last_mubatch(self, mubatch_id):
        return mubatch_id == self.num_micro_batches - 1

    # -- shared step helpers -------------------------------------------------

    def _fwd_step(self, mb):
        cmds = []
        if self.is_first_stage:
            cmds.append(LoadMuBatchInput(mubatch_id=mb))
        else:
            cmds.append(RecvActivations())
        cmds.append(Forward(mubatch_id=mb))
        return cmds

    def _fwd_step_send(self, mb):
        """Forward step that relays activations downstream; the last stage
        discards its forward output — backward needs only targets + residuals
        (reference pipe.py:262-266)."""
        cmds = self._fwd_step(mb)
        if not self.is_last_stage:
            cmds.append(SendActivations())
        return cmds

    def _bwd_compute(self, mb, allreduce):
        """The backward compute (+ input-grad send) for one microbatch —
        combined, or the split B-input/B-weight pair. The send always
        follows the compute that produces dx (B-input when split), and the
        DP-sync anchor rides the final backward's WEIGHT half when split
        (the gradient is not complete until the last deferred B-weight)."""
        cmds = []
        if self.backward_split:
            cmds.append(BackwardInputGradAcc(mubatch_id=mb))
            if not self.is_first_stage:
                cmds.append(SendInputGrad())
            wcls = BackwardWeightGradAllReduce if allreduce else BackwardWeightGradAcc
            cmds.append(wcls(mubatch_id=mb))
        else:
            cls = BackwardGradAllReduce if allreduce else BackwardGradAcc
            cmds.append(cls(mubatch_id=mb))
            if not self.is_first_stage:
                cmds.append(SendInputGrad())
        return cmds

    def _bwd_step(self, mb, allreduce):
        cmds = []
        if self.recompute:
            # re-materialize the residuals FIRST: the recompute binds no
            # messages (its input was stashed at the forward tick), so the
            # Recv/Load that follows still binds to the backward compute
            cmds.append(RecomputeForward(mubatch_id=mb))
        if self.is_last_stage:
            cmds.append(LoadMuBatchTarget(mubatch_id=mb))
        else:
            cmds.append(RecvOutputGrad())
        cmds.extend(self._bwd_compute(mb, allreduce))
        return cmds


class NaiveParallelSchedule(Schedule):
    """One microbatch fully forward AND backward at a time; only one stage is
    active at any moment (reference pipe.py:184-222)."""

    def steps(self):
        yield [ZeroGrad()]
        for mb in range(self.num_micro_batches):
            cmds = self._fwd_step(mb)
            if not self.is_last_stage:
                cmds.append(SendActivations())
            if self.recompute:
                # same contract as _bwd_step: re-materialize residuals
                # ahead of the Recv/Load that binds to the backward
                cmds.append(RecomputeForward(mubatch_id=mb))
            if self.is_last_stage:
                cmds.append(LoadMuBatchTarget(mubatch_id=mb))
            else:
                cmds.append(RecvOutputGrad())
            cmds.extend(self._bwd_compute(mb, self.is_last_mubatch(mb)))
            yield cmds
        yield [OptimizerStep()]


class GPipeSchedule(Schedule):
    """All microbatches forward, then all backward in reverse order
    (reference pipe.py:225-272). The DP all-reduce interleaves into the LAST
    executed backward, which is microbatch 0."""

    def steps(self):
        yield [ZeroGrad()]
        for mb in range(self.num_micro_batches):
            yield self._fwd_step_send(mb)
        for mb in reversed(range(self.num_micro_batches)):
            yield self._bwd_step(mb, allreduce=self.is_first_mubatch(mb))
        yield [OptimizerStep()]


class PipeDreamFlushSchedule(Schedule):
    """PipeDream-Flush / 1F1B with a full flush per batch — same weight-update
    semantics as GPipe (synchronous, one optimizer step per batch) but peak
    activation memory of min(M, depth - stage) microbatches instead of M.

    The reference registers this schedule in its CLI but leaves the class an
    unimplemented stub (pipe.py:297-299, train.py:50-54); this is the real
    thing. Structure per stage: warmup of ``min(depth - 1 - stage, M)``
    forwards, then 1F1B steady state, then the remaining backwards (flush).
    """

    def steps(self):
        yield [ZeroGrad()]
        M = self.num_micro_batches
        warmup = min(self.num_stages - 1 - self.stage_id, M)
        # warmup forwards
        for mb in range(warmup):
            yield self._fwd_step_send(mb)
        # steady state: one forward, one backward
        fwd_mb, bwd_mb = warmup, 0
        while fwd_mb < M:
            yield self._fwd_step_send(fwd_mb)
            yield self._bwd_step(bwd_mb, allreduce=bwd_mb == M - 1)
            fwd_mb += 1
            bwd_mb += 1
        # cooldown/flush: drain the remaining backwards
        while bwd_mb < M:
            yield self._bwd_step(bwd_mb, allreduce=bwd_mb == M - 1)
            bwd_mb += 1
        yield [OptimizerStep()]


class InferenceSchedule(Schedule):
    """Forward-only relay for validation/accuracy (reference pipe.py:275-294)."""

    def steps(self):
        for mb in range(self.num_micro_batches):
            yield self._fwd_step_send(mb)


# ---------------------------------------------------------------------------
# Interleaved (virtual-stage) schedules — beyond the reference.
# ---------------------------------------------------------------------------


class InterleavedSchedule(Schedule):
    """Megatron-style interleaved pipeline: S = P x V model stages on P
    devices, stage ``s`` on device ``s mod P`` as virtual chunk ``s // P``.
    The reference has nothing like this (its Worker owns exactly one stage,
    pipe.py:330-353); on TPU it is a natural fit because EVERY stage-to-stage
    link — including the device-(P-1) -> device-0 wraps between chunks —
    becomes the same ring ``ppermute`` shift over the ``pp`` axis.

    This class emits per-DEVICE streams (stage_id is the device id), with
    ``chunk_id`` on each compute naming the virtual stage. Schedule shape is
    1F1B over (chunk, microbatch) pairs in Megatron's order — microbatches
    grouped P at a time, each group pushed through every chunk before the
    next group starts — which shrinks the pipeline-fill bubble by ~V versus
    giving each device one fat stage. Requires M % P == 0 (same restriction
    as Megatron's interleaved mode).

    Subclasses set ``num_chunks`` via the constructor (V=1 degenerates to
    PipeDream-Flush over P stages).
    """

    def __init__(self, num_micro_batches, num_stages, stage_id, num_chunks=2):
        super().__init__(num_micro_batches, num_stages, stage_id)
        if num_micro_batches % num_stages != 0:
            raise ValueError(
                f"interleaved schedule needs M % P == 0 "
                f"(got M={num_micro_batches}, P={num_stages})"
            )
        assert num_chunks >= 1
        self.num_chunks = num_chunks

    # (chunk, microbatch) of the k-th forward in device execution order
    def _fwd_k(self, k):
        P = self.num_stages
        return (k // P) % self.num_chunks, (k // (P * self.num_chunks)) * P + k % P

    # backwards run chunks in reverse
    def _bwd_k(self, k):
        P = self.num_stages
        c = self.num_chunks - 1 - (k // P) % self.num_chunks
        return c, (k // (P * self.num_chunks)) * P + k % P

    def _is_input_end(self, chunk):
        return self.is_first_stage and chunk == 0

    def _is_head_end(self, chunk):
        return self.is_last_stage and chunk == self.num_chunks - 1

    def _ifwd(self, k):
        c, mb = self._fwd_k(k)
        cmds = []
        if self._is_input_end(c):
            cmds.append(LoadMuBatchInput(mubatch_id=mb))
        else:
            cmds.append(RecvActivations())
        cmds.append(Forward(mubatch_id=mb, chunk_id=c))
        if not self._is_head_end(c):
            cmds.append(SendActivations())
        return cmds

    def _ibwd(self, k, total):
        c, mb = self._bwd_k(k)
        cmds = []
        if self._is_head_end(c):
            cmds.append(LoadMuBatchTarget(mubatch_id=mb))
        else:
            cmds.append(RecvOutputGrad())
        cls = BackwardGradAllReduce if k == total - 1 else BackwardGradAcc
        cmds.append(cls(mubatch_id=mb, chunk_id=c))
        if not self._is_input_end(c):
            cmds.append(SendInputGrad())
        return cmds

    def steps(self):
        P, V, M = self.num_stages, self.num_chunks, self.num_micro_batches
        total = M * V
        # Megatron warmup: enough forwards to fill the pipeline ahead of the
        # first backward, shrunk by rank and grown by (V-1) microbatch groups
        warmup = min((P - self.stage_id - 1) * 2 + (V - 1) * P, total)
        yield [ZeroGrad()]
        for k in range(warmup):
            yield self._ifwd(k)
        fwd_k, bwd_k = warmup, 0
        while fwd_k < total:
            yield self._ifwd(fwd_k)
            yield self._ibwd(bwd_k, total)
            fwd_k += 1
            bwd_k += 1
        while bwd_k < total:
            yield self._ibwd(bwd_k, total)
            bwd_k += 1
        yield [OptimizerStep()]


class InterleavedInferenceSchedule(InterleavedSchedule):
    """Forward-only relay over virtual chunks (interleaved accuracy path).
    No M % P restriction — there is no 1F1B steady state to group for, so
    microbatches simply stream through the chunks in stage order."""

    def __init__(self, num_micro_batches, num_stages, stage_id, num_chunks=2):
        Schedule.__init__(self, num_micro_batches, num_stages, stage_id)
        assert num_chunks >= 1
        self.num_chunks = num_chunks

    def _fwd_k(self, k):
        M = self.num_micro_batches
        return k // M, k % M

    def steps(self):
        for k in range(self.num_micro_batches * self.num_chunks):
            yield self._ifwd(k)


SCHEDULES = {
    "naive": NaiveParallelSchedule,
    "gpipe": GPipeSchedule,
    "pipedream": PipeDreamFlushSchedule,
    "interleaved": InterleavedSchedule,
}


def flat_commands(schedule: Schedule):
    """The stage's instruction stream flattened to a single command list."""
    return [cmd for step in schedule.steps() for cmd in step]
