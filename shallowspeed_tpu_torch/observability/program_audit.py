"""The program audit: the port's counterpart of
``shallowspeed_tpu/observability/program_audit.py``.

The JAX module audits what XLA compiled: it parses the post-optimization
HLO for collectives and reads XLA's memory analysis. The port compiles no
XLA program. Its "collectives" are the executor's data movers between the
virtual ranks of one card, so the evidence comes from those movers as they
run, and from the CUDA caching allocator:

- ``CommCensus`` / ``recording``: a recorder the movers feed. The
  module-level ``active`` is None outside a census, so a mover pays one
  ``is None`` check and no host sync. Each mover notes ``(kind, site,
  nbytes)``: ``relay`` a ``collective_permute`` (one site per direction),
  ``dp_sum``, the tp rank sums and the lockstep inference's head-preds
  hand-out an ``all_reduce``, the ZeRO sums and scatters a
  ``reduce_scatter``, the ZeRO gathers an ``all_gather``. ``nbytes`` is
  what ONE virtual rank holds after the op (the JAX census's per-device
  result size): a relay's payload, the dp sum's per-(pp, tp)-rank gradient,
  a reduce-scatter's shard, an all-gather's gathered row. The census is
  STRUCTURAL, as the JAX census is: one op per distinct site executed in
  the recorded run, its bytes what the site moves in one execution (the
  largest one where they differ). A mover inside a tick names the tick's
  branch (forward, backward, recompute, B-weight), as an XLA tick branch
  holds its own copy of an op. The census is taken from the movers and
  never derived from the tick tables: the contract (``expected_comms``)
  is, so a census computed from them would always agree with it.
  The lockstep loss tally's replica sum is not a site (a scalar; the JAX
  census counts it among the all-reduces it tolerates), so a dropped
  gradient sum cannot hide behind it. The port keeps no per-bucket
  emitters, so a bucketed dp sync is ONE site of the anchor sum's total
  bytes, the shape the bucketed check accepts ("ONE sync op of the total
  byte size", below); nothing fakes per-bucket ops. ``active`` is
  process-wide: one census records at a time (``recording`` refuses a
  second, and the session audits a program's first dispatch under its own
  lock); a mover another thread runs meanwhile would be counted in it,
  and the port's entry points dispatch from one thread at a time.
- ``memory_stats``: on the card, ``torch.cuda.reset_peak_memory_stats``
  before the recorded run and ``max_memory_allocated`` minus the bytes
  allocated before it after, as ``peak_hbm_bytes`` (the run's transient
  peak above what was resident), with ``argument_size_in_bytes`` the
  run's params + optimizer state + batch. The JAX keys that do not map
  are None. On the CPU every value is None, with a ``reason``.
- ``check_dispatch_safety``: a serving rung must leave every param tensor
  it reads unwritten. Torch counts in-place writes per tensor
  (``Tensor._version``), so the check compares the counters before and
  after a run; the counterpart of the JAX HLO donation pass.
- ``hbm_per_chip("gpu")`` reads the card's capacity from
  ``torch.cuda.get_device_properties`` and raises without a card (no
  fallback). ``interconnect_bytes_per_sec("gpu")`` is None: every mover
  of the virtual mesh is a copy inside one card's memory, so no
  interconnect exists to bound it (the source string says so), and the
  contract's comms time and bound verdict stay None on the card.
- Copies of the JAX module's pure functions, with its signatures, words
  and dict keys, so the port's report renders the records unchanged:
  ``AuditMismatchError``, ``census_of_ops``, ``zero_peak_forecast``,
  ``expected_comms`` (plus a ``device_name`` for the card's fp32 peak),
  ``check_census``, ``verify_census`` and ``format_bytes``.
- ``audit_program``: the ``xla_audit`` record (``audit_compiled``'s
  fields; ``hlo_available`` False and ``census_source: "movers"``).

The HLO-only functions (``parse_collectives``, ``collective_census``,
``parse_input_output_aliases``, ``donation_census``, the HLO text of
``check_dispatch_safety``) have no counterpart: the port compiles no HLO.

Census contract semantics, as in the JAX module: a sequential program
must move nothing between ranks, a pipeline (pp > 1) program must relay in
both directions, dp > 1 without ZeRO must all-reduce and must NOT
reduce-scatter/all-gather, and every ZeRO stage must reduce-scatter AND
all-gather (dp = 1 included). Bucketed: every planned bucket must be
accounted for by the sync ops' sizes, one op per bucket or merged runs of
ADJACENT buckets, a single op of the total size accepted.
"""

import contextlib
import copy
import math
import os
import time

from shallowspeed_tpu_torch.observability.costmodel import (
    mlp_train_flops_per_sample,
    peak_flops_per_chip,
)

# The collective kinds of a census, in the JAX census's spelling.
COLLECTIVE_KINDS = (
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "collective_permute",
    "all_to_all",
)

# The audit record's platform name of a CUDA card (JAX's name for it).
GPU = "gpu"

# A clearly-labeled NOMINAL figure for the host CPU (there is no single
# honest "device memory" for a host; the source tag says so). The card's
# capacity is read from the card. Override with SHALLOWSPEED_HBM_BYTES.
HBM_PER_CHIP = {
    "cpu": 8 * 2**30,
}

# A NOMINAL loopback figure for the CPU (the movers are memcpys; the tag
# says nominal). Override with SHALLOWSPEED_PEAK_BW_BYTES.
INTERCONNECT_BYTES_PER_SEC = {
    "cpu": 10e9,
}

ENV_HBM = "SHALLOWSPEED_HBM_BYTES"
ENV_BW = "SHALLOWSPEED_PEAK_BW_BYTES"

_MEMORY_KEYS = (
    "argument_size_in_bytes",
    "output_size_in_bytes",
    "temp_size_in_bytes",
    "alias_size_in_bytes",
    "generated_code_size_in_bytes",
    "peak_hbm_bytes",
)


class AuditMismatchError(ValueError):
    """The compiled program's collective census violates the layout's
    analytical contract — either the lowering or the contract regressed."""


# ---------------------------------------------------------------------------
# The census the movers feed
# ---------------------------------------------------------------------------

# The census being recorded, or None: the movers' one check.
active = None


class CommCensus:
    """The ops one recorded run moved between virtual ranks: one per
    distinct site, its kind and the largest per-rank payload one
    execution moved. ``branch`` names the tick branch the movers inside a
    tick run in (set by the executor and the MPMD runner)."""

    def __init__(self):
        self.sites = {}  # site -> [kind, nbytes]
        self.branch = None
        self.wall_s = None  # the recorded run's host wall (``recording``)

    def here(self, site):
        """``site`` inside the current tick branch."""
        return site if self.branch is None else f"{self.branch}/{site}"

    def note(self, kind, site, nbytes):
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        entry = self.sites.get(site)
        if entry is None:
            self.sites[site] = [kind, int(nbytes)]
            return
        if entry[0] != kind:
            raise ValueError(f"census site {site!r} moved {entry[0]} and {kind}")
        entry[1] = max(entry[1], int(nbytes))

    def ops(self):
        """The structural op list (``parse_collectives``' shape, with the
        site): ``[{"kind", "bytes", "site"}]`` in first-execution order."""
        return [{"kind": k, "bytes": b, "site": s} for s, (k, b) in self.sites.items()]


def nbytes(t):
    """A tensor's payload bytes, ``numel x element_size`` (no sync)."""
    return t.numel() * t.element_size()


def tree_tensors(tree):
    """Every tensor in a nest of dicts, tuples, lists and modules (a
    module's parameters and buffers), in walk order; host values (numpy
    flags, ints) are skipped."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_tensors(v)]
    if hasattr(tree, "state_dict"):
        return list(tree.state_dict(keep_vars=True).values())
    return [tree] if hasattr(tree, "element_size") else []


def tree_nbytes(tree):
    """The payload bytes of every tensor in ``tree`` (``tree_tensors``)."""
    return sum(nbytes(t) for t in tree_tensors(tree))


def clone_tree(tree):
    """A copy of every tensor in a nest of dicts, tuples, lists and modules,
    the rest shared: a probe run on the copy leaves the original
    bitwise as it was."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone_tree(v) for v in tree)
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    if hasattr(tree, "state_dict"):
        return copy.deepcopy(tree)
    return tree.clone() if hasattr(tree, "element_size") else tree


@contextlib.contextmanager
def recording(device, argument_bytes=None):
    """Record a census (and the device's memory) of the run inside the
    block; yields ``(census, memory)``, ``memory`` filled when the block
    ends (``memory_stats``) and ``census.wall_s`` the block's host wall,
    up to the device's completion of its work on the card. One census at
    a time."""
    global active
    if active is not None:
        raise RuntimeError("a census is already recording")
    probe = _MemoryProbe(device, argument_bytes)
    census = CommCensus()
    memory = {}
    active = census
    t0 = time.perf_counter()
    try:
        yield census, memory
    finally:
        active = None
    memory.update(probe.stop())
    census.wall_s = time.perf_counter() - t0


class _MemoryProbe:
    def __init__(self, device, argument_bytes):
        self.device = device
        self.argument_bytes = argument_bytes
        self.base = None
        if getattr(device, "type", device) == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats(device)
            self.base = torch.cuda.memory_allocated(device)

    def stop(self):
        if self.base is None:
            return memory_stats(None)
        import torch

        torch.cuda.synchronize(self.device)  # the run's wall ends on the card
        return memory_stats(
            torch.cuda.max_memory_allocated(self.device) - self.base,
            self.argument_bytes,
        )


def memory_stats(peak_bytes, argument_bytes=None):
    """The ``xla_audit`` record's memory dict: the JAX keys, with
    ``peak_hbm_bytes`` the allocator's peak above the bytes resident before
    the run and ``argument_size_in_bytes`` its params + optimizer state +
    batch; the keys that do not map are None. ``peak_bytes`` None (no
    device allocator: the CPU) gives every value None and a ``reason``."""
    out = dict.fromkeys(_MEMORY_KEYS)
    if peak_bytes is None:
        out["reason"] = (
            "no device allocator on this device (the CPU): the peak is not "
            "measured"
        )
        return out
    out["peak_hbm_bytes"] = int(peak_bytes)
    if argument_bytes is not None:
        out["argument_size_in_bytes"] = int(argument_bytes)
    out["source"] = "cuda-caching-allocator"
    return out


# ---------------------------------------------------------------------------
# Dispatch safety: in-place writes of a serving rung's params
# ---------------------------------------------------------------------------


def tensor_versions(tree):
    """The in-place write counters (``Tensor._version``) of every tensor in
    ``tree`` (``tree_tensors``), in walk order."""
    return [t._version for t in tree_tensors(tree)]


def check_dispatch_safety(before, after, context="compiled program"):
    """The dispatch-safety leg: a program that serves requests reads its
    params again on the very next dispatch, so it must write none of them
    in place. ``before``/``after``: ``tensor_versions`` of its params
    around a run. Returns a list of mismatch strings (empty = safe)."""
    written = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    if not written and len(before) == len(after):
        return []
    return [
        f"{context}: program writes its input buffers in place "
        f"({len(written)} of {len(before)} param tensors, at {written[:8]}) "
        "— dispatching it from a serving path is the documented "
        "use-after-free hazard (the next request reads what this one wrote)"
    ]


# ---------------------------------------------------------------------------
# Copies of the JAX module's pure functions
# ---------------------------------------------------------------------------


def census_of_ops(ops):
    """Aggregate a ``parse_collectives`` op list into the census shape:
    ``{kind: {"count": n, "bytes": summed result bytes}}``."""
    census = {}
    for op in ops:
        agg = census.setdefault(op["kind"], {"count": 0, "bytes": 0})
        agg["count"] += 1
        agg["bytes"] += op["bytes"]
    return census


def hbm_per_chip(platform, device=None):
    """-> ``(capacity_bytes, source)`` for one chip; ``(None, source)``
    when the platform is unknown. On the card (``"gpu"``) the capacity is
    the card's own, from ``torch.cuda.get_device_properties``
    of ``device`` (default the current one); without a card that raises:
    no figure is assumed. The CPU's figure is nominal and tagged so."""
    env = os.environ.get(ENV_HBM)
    if env:
        return float(env), f"env:{ENV_HBM}"
    if platform == GPU:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"hbm_per_chip({platform!r}): no CUDA device is visible; the "
                "card's capacity is read from the card, never assumed (set "
                f"{ENV_HBM} to audit against a figure of your own)"
            )
        if device is None:
            device = torch.cuda.current_device()
        props = torch.cuda.get_device_properties(device)
        return int(props.total_memory), f"cuda-device-properties:{props.name}"
    if platform not in HBM_PER_CHIP:
        return None, f"unknown-platform:{platform}"
    return HBM_PER_CHIP[platform], "nominal-cpu-default"


def interconnect_bytes_per_sec(platform):
    """-> ``(bytes_per_sec, source)`` per chip; ``(None, source)`` when
    unknown. The card: None, since the virtual mesh's movers are copies
    inside one card's memory (no interconnect carries them); CPU: a
    nominal loopback figure; env override for anything else."""
    env = os.environ.get(ENV_BW)
    if env:
        return float(env), f"env:{ENV_BW}"
    if platform == GPU:
        return None, (
            "none:virtual-mesh-on-one-card (every mover is a copy inside the "
            "card's memory)"
        )
    if platform not in INTERCONNECT_BYTES_PER_SEC:
        return None, f"unknown-platform:{platform}"
    return INTERCONNECT_BYTES_PER_SEC[platform], "nominal-cpu-default"


def zero_peak_forecast(spec, dp, pp, tp=1, state_parts=0, num_chunks=None,
                       bucketed=False):
    """The analytical per-device PARAM-STATE footprint at every ZeRO
    stage (the JAX function): ``params_bytes`` at rest, ``grads_bytes``
    (full slabs at stages 0-1, the reduce-scattered shard at 2-3, full at a
    bucketed stage 2), ``state_bytes`` (``state_parts`` optimizer parts,
    full or sharded), ``transient_bytes`` (stage 3: one chunk's gathered
    params) and their ``total_bytes``, priced from the executor's own
    layout math (``stacked_flat_len`` / ``zero_block_slots``). f32
    model-state bytes per device; activations and temporaries ride on
    top."""
    from shallowspeed_tpu_torch.parallel.executor import (
        stacked_flat_len,
        zero_block_slots,
    )

    f = 4 * stacked_flat_len(spec, pp, tp)  # per-device stacked f32 bytes
    _, csz3 = zero_block_slots(spec, pp, dp, tp)
    shard = 4 * csz3  # the padded block-cyclic per-rank shard
    n = int(state_parts)
    chunks = int(num_chunks) if num_chunks else 1
    # string stage keys: the record round-trips through JSON
    stages = {
        "0": {"params_bytes": f, "grads_bytes": f, "state_bytes": n * f,
              "transient_bytes": 0},
        "1": {"params_bytes": f, "grads_bytes": f, "state_bytes": n * shard,
              "transient_bytes": 0},
        "2": {"params_bytes": f,
              "grads_bytes": f if bucketed else shard,
              "state_bytes": n * shard, "transient_bytes": 0},
        "3": {"params_bytes": shard, "grads_bytes": shard,
              "state_bytes": n * shard,
              # JIT gathering keeps ONE chunk's params live at a time
              "transient_bytes": -(-f // chunks)},
    }
    for s in stages.values():
        s["total_bytes"] = (
            s["params_bytes"] + s["grads_bytes"] + s["state_bytes"]
            + s["transient_bytes"]
        )
    return {
        "stacked_param_bytes_per_device": f,
        "shard_bytes_per_device": shard,
        "state_parts": n,
        "stages": stages,
    }


def expected_comms(
    spec,
    dp,
    pp,
    prog=None,
    zero1=False,
    zero=None,
    mubatch_size=None,
    platform="cpu",
    precision="highest",
    grad_bucket_plan=None,
    tp=1,
    opt_state_parts=0,
    device_name=None,
):
    """The layout's analytical comms contract (the JAX function, its
    arguments, words and keys; ``device_name`` selects the card's fp32
    peak on the ``"gpu"`` platform): ``required``/``forbidden``
    collective kinds, per-mesh-axis bytes per device per optimizer step
    (``pp``: 2 relays x ticks x payload from the lowered tables, one
    direction for inference; ``dp``: ``gradsync.sync_comm_bytes``; ``tp``:
    the Megatron sums and their ``hlo_min_all_reduce_ops`` floor;
    ``preds``: the inference head's hand-out), the bandwidth and compute
    lower bounds with their provenance, and the training program's
    ``zero_forecast``. ``prog`` None is the sequential layout; a
    ``prog.is_training`` False program the forward-only inference contract
    (ZeRO kinds forbidden, at most one all-reduce beyond the tp sites)."""
    if zero is None:
        zero = 1 if zero1 else 0
    zero = int(zero)
    sequential = prog is None
    axes = {}
    required, forbidden = [], []
    if sequential:
        # one device, one program: ANY collective is a contract violation
        forbidden = list(COLLECTIVE_KINDS)
        flops_per_step = mlp_train_flops_per_sample(spec.sizes) * spec.global_batch_size
    else:
        from shallowspeed_tpu_torch.parallel.lowering import (
            program_comm_bytes,
            program_flops,
        )

        forbidden.append("all_to_all")
        inference = not prog.is_training
        if tp > 1:
            # the Megatron axis: its all-reduces exist in both training and
            # inference programs, so the kind is required and a structural
            # op-count floor rides the axis entry for check_census
            from shallowspeed_tpu_torch.parallel.executor import tp_allreduce_sites

            fwd_w, bwd_w = tp_allreduce_sites(spec, tp, training=not inference)
            cells = prog.num_chunks * prog.num_micro_batches
            # recompute re-runs the stage forward inside the backward tick:
            # every forward sum site fires twice per (chunk, microbatch),
            # and the recompute branch holds its own copy of the sites
            rec = bool(getattr(prog, "recompute", False))
            fwd_passes = 2 if rec else 1
            payload = 4 * mubatch_size * cells * (
                fwd_passes * sum(fwd_w) + sum(bwd_w)
            )
            axes["tp"] = {
                "kind": "all_reduce",
                "algorithm": "ring",
                "sites_fwd": len(fwd_w),
                "sites_bwd": len(bwd_w),
                "site_payload_bytes": [
                    4 * mubatch_size * w for w in list(fwd_w) + list(bwd_w)
                ],
                "allreduce_bytes_per_device": int(payload),
                "bytes_per_step_per_device": int(2 * (tp - 1) / tp * payload),
                "hlo_min_all_reduce_ops": (
                    fwd_passes * len(fwd_w) + len(bwd_w)
                ),
            }
            required.append("all_reduce")
        if pp > 1:
            # only a real pipeline axis demands the relays; at pp == 1 they
            # would be self-loops, allowed but neither demanded nor counted
            required.append("collective_permute")
            comm = program_comm_bytes(prog, spec, mubatch_size)
            # an inference program relays one direction only
            wire = comm["wire_bytes_per_device"]
            useful = comm["useful_bytes_per_device"]
            if inference:
                wire //= 2
            axes["pp"] = {
                "kind": "collective_permute",
                "ticks": comm["num_ticks"],
                "payload_bytes": comm["relay_payload_bytes"],
                "bytes_per_step_per_device": wire,
                "useful_bytes_per_step_per_device": useful,
            }
        if inference:
            # a forward-only relay plus ONE lawful reduction, the head
            # stage's predictions handed to every pp rank (required at
            # pp > 1); the ZeRO collectives are training-only
            forbidden += ["reduce_scatter", "all_gather"]
            if pp > 1:
                required.append("all_reduce")
                from shallowspeed_tpu_torch.parallel.executor import slot_shapes

                # the executor moves the PADDED head width (tp-rounded when
                # a tp axis is active)
                preds_bytes = (
                    4
                    * prog.num_micro_batches
                    * mubatch_size
                    * slot_shapes(spec, tp)[-1][0]
                )
                axes["preds"] = {
                    "kind": "all_reduce",
                    "bytes_per_step_per_device": int(
                        2 * (pp - 1) / pp * preds_bytes
                    ),
                }
        else:
            from shallowspeed_tpu_torch.parallel.gradsync import sync_comm_bytes

            if zero >= 1:
                # every sharded stage moves both, dp = 1 included
                required += ["reduce_scatter", "all_gather"]
            else:
                forbidden += ["reduce_scatter", "all_gather"]
                if dp > 1:
                    # "the DP all-reduce really is one psum"
                    required.append("all_reduce")
            # the dp-axis byte model has ONE definition, shared with the
            # executor: gradsync.sync_comm_bytes. Stage 3's gathers scale
            # with the microbatch passes (recompute re-gathers in the
            # backward tick, a third pass per (chunk, microbatch))
            axes["dp"] = sync_comm_bytes(
                spec, dp, pp, zero=zero, plan=grad_bucket_plan, tp=tp,
                mubatches=prog.num_micro_batches,
                gather_passes=(
                    3 if getattr(prog, "recompute", False) else 2
                ),
            )
        # per-device padded compute: the tick program's FLOPs are the whole
        # pp x tp group's, split evenly across its ranks
        flops_per_step = program_flops(prog, spec, mubatch_size, tp=tp) / (pp * tp)

    # a kind may be demanded by several axes; the contract lists it once
    required = list(dict.fromkeys(required))
    total = sum(a["bytes_per_step_per_device"] for a in axes.values())
    bw, bw_source = interconnect_bytes_per_sec(platform)
    if platform == GPU:
        peak, peak_source = peak_flops_per_chip("cuda", precision, device_name)
    else:
        peak, peak_source = peak_flops_per_chip(platform, precision)
    comms_t = (total / bw) if bw else None
    compute_t = (flops_per_step / peak) if peak else None
    bound = None
    serial_t = overlapped_t = hidden_share = None
    if comms_t is not None and compute_t is not None:
        bound = "comms" if comms_t > compute_t else "compute"
        # the anchor's serial comm-then-compute chain vs a perfectly
        # overlapped bucketed sync
        serial_t = comms_t + compute_t
        overlapped_t = max(comms_t, compute_t)
        if comms_t > 0:
            hidden_share = min(comms_t, compute_t) / comms_t
    forecast = None
    if not sequential and prog.is_training:
        forecast = zero_peak_forecast(
            spec, dp, pp, tp=tp, state_parts=opt_state_parts,
            num_chunks=prog.num_chunks,
            bucketed=bool(grad_bucket_plan) and int(zero or 0) == 2,
        )
    return {
        "dp": int(dp),
        "pp": int(pp),
        "tp": int(tp),
        "zero": zero,
        "zero1": zero == 1,
        "zero_forecast": forecast,
        "sequential": sequential,
        "inference": bool(prog is not None and not prog.is_training),
        "required": required,
        "forbidden": forbidden,
        "axes": axes,
        "bytes_per_step_per_device": total,
        "bandwidth_bytes_per_sec": bw,
        "bandwidth_source": bw_source,
        "comms_time_per_step_s": comms_t,
        "compute_flops_per_step_per_device": flops_per_step,
        "peak_flops_per_chip": peak,
        "peak_flops_source": peak_source,
        "compute_time_per_step_s": compute_t,
        "bound": bound,
        "serial_bound_s": serial_t,
        "overlapped_bound_s": overlapped_t,
        "model_hidden_comm_share": hidden_share,
    }


def check_census(census, expected, ops=None):
    """Compare a program's collective census against the layout contract
    (the JAX function and words). Returns a list of human-readable
    mismatch strings (empty = the census matches). ``ops``: the per-op
    list, for the bucketed size-accounting leg."""
    mismatches = []
    for kind in expected.get("required", ()):
        if census.get(kind, {}).get("count", 0) < 1:
            mismatches.append(
                f"required collective {kind!r} is absent from the compiled "
                f"program (census: {sorted(census) or 'empty'})"
            )
    for kind in expected.get("forbidden", ()):
        n = census.get(kind, {}).get("count", 0)
        if n:
            mismatches.append(
                f"forbidden collective {kind!r} appears {n}x in the "
                "compiled program"
            )
    if "collective_permute" in expected.get("required", ()):
        n = census.get("collective_permute", {}).get("count", 0)
        # inference programs relay one direction, so the both-directions
        # rule applies to training programs only
        if 0 < n < 2 and not expected.get("inference"):
            mismatches.append(
                "pipeline relay must permute in BOTH directions "
                f"(>= 2 collective-permutes); compiled program has {n}"
            )
    tp_axis = (expected.get("axes") or {}).get("tp") or {}
    if expected.get("inference") and not tp_axis:
        # a forward-only program has exactly one lawful all-reduce, the
        # preds hand-out; a second one means a gradient sync leaked into
        # the serving path (zero is tolerated: the required leg above
        # still demands it at pp > 1)
        n = census.get("all_reduce", {}).get("count", 0)
        if n > 1:
            mismatches.append(
                "forward-only inference program must lower at most ONE "
                f"all-reduce (the preds psum); compiled program has {n} — "
                "a gradient sync leaked into the serving path"
            )
    if tp_axis:
        # the Megatron structural floor: each tp sum site is a distinct op
        # inside its tick branch; the dp sync only ADDS ops
        need = int(tp_axis.get("hlo_min_all_reduce_ops", 0))
        n = census.get("all_reduce", {}).get("count", 0)
        if n < need:
            mismatches.append(
                f"tensor-parallel program must hold >= {need} all-reduce "
                f"ops ({tp_axis.get('sites_fwd')} forward + "
                f"{tp_axis.get('sites_bwd')} backward Megatron psum sites); "
                f"compiled program has {n}"
            )
        if expected.get("inference") and n > need + 1:
            # the forward-only upper pin survives tp: the Megatron sites
            # plus the one preds hand-out
            mismatches.append(
                f"forward-only tensor-parallel program must lower at most "
                f"{need + 1} all-reduce ops ({need} Megatron sites + the "
                f"preds psum); compiled program has {n} — a gradient sync "
                "leaked into the serving path"
            )
    dp_axis = (expected.get("axes") or {}).get("dp") or {}
    need_ag = int(dp_axis.get("hlo_min_all_gather_ops", 0))
    if need_ag and expected.get("dp", 1) > 1:
        # the ZeRO-3 gather floor: every gather-bearing tick branch
        # (forward, backward, recompute) gathers its chunk's params
        n = census.get("all_gather", {}).get("count", 0)
        if n < need_ag:
            mismatches.append(
                f"zero-3 program must hold >= {need_ag} all-gather ops "
                "(one JIT parameter gather per gather-bearing tick "
                f"branch); compiled program has {n}"
            )
    mismatches += _check_bucketed_sync(census, expected, ops)
    return mismatches


def _check_bucketed_sync(census, expected, ops):
    """The bucketed gradient-sync leg: every planned bucket accounted for
    by the sync ops, one op of exactly the bucket's result size or one op
    of a MERGED adjacent run's summed size; a single op of the total size
    is accepted. Checked only with per-op evidence (``ops``) and only when
    the dp axis is real traffic (dp > 1)."""
    axis = (expected.get("axes") or {}).get("dp") or {}
    if axis.get("mode") != "bucketed" or expected.get("dp", 1) <= 1:
        return []
    if ops is None:
        return []  # census aggregates carry no per-op sizes: no evidence
    # stages 1-2 bucket their tail reduce-scatter; stage 0 the all-reduce
    stage = expected.get("zero", 1 if expected.get("zero1") else 0)
    kind = "reduce_scatter" if stage else "all_reduce"
    planned = [int(b) for b in axis.get("bucket_census_bytes", ())]
    compiled = sorted(op["bytes"] for op in ops if op["kind"] == kind)
    if _buckets_accounted(planned, compiled):
        return []

    def _fmt(sizes):
        s = ", ".join(str(v) for v in sizes[:12])
        return f"[{s}{', ...' if len(sizes) > 12 else ''}]"

    return [
        f"bucketed sync: the compiled program's {kind} result sizes "
        f"{_fmt(compiled)} cannot account for the planned bucket sizes "
        f"{_fmt(planned)} (neither one op per bucket nor merged adjacent "
        "runs)"
    ]


def _buckets_accounted(planned, compiled, node_budget=100_000):
    """Can the ordered ``planned`` bucket sizes be partitioned into
    contiguous runs whose sums each match a distinct ``compiled`` op
    size? Extra ops may go unused. Backtracking with a node budget; an
    infeasible search falls back to the weaker total-bytes check."""
    from collections import Counter

    class _Exhausted(Exception):
        pass

    avail = Counter(compiled)
    budget = [node_budget]

    def match(i):
        if budget[0] <= 0:
            raise _Exhausted  # budget spent: no verdict either way
        budget[0] -= 1
        if i == len(planned):
            return True
        run = 0
        for j in range(i, len(planned)):
            run += planned[j]
            if avail[run] > 0:
                avail[run] -= 1
                if match(j + 1):
                    return True
                avail[run] += 1
        return False

    try:
        return match(0)
    except (_Exhausted, RecursionError):
        return sum(compiled) >= sum(planned)


def verify_census(census, expected, context="compiled program", ops=None):
    """``check_census`` that fails loudly — the tested layout invariant."""
    mismatches = check_census(census, expected, ops=ops)
    if mismatches:
        raise AuditMismatchError(
            f"{context}: collective census disagrees with the layout "
            "contract: " + "; ".join(mismatches)
        )


def audit_program(census, memory, expected=None, platform=None, n_devices=1,
                  device=None):
    """The ``xla_audit`` record of one recorded run (``audit_compiled``'s
    fields): ``census`` (a ``CommCensus``: its aggregate, and its sites),
    ``memory`` (``memory_stats``), the contract verdict when ``expected``
    is given, and the capacity leg when ``platform`` is (``device``: the
    card whose capacity ``hbm_per_chip`` reads)."""
    ops = census.ops()
    rec = {
        "hlo_available": False,
        "census_source": "movers",
        "census": census_of_ops(ops),
        "census_sites": {op["site"]: [op["kind"], op["bytes"]] for op in ops},
        "recorded_run_s": census.wall_s,
        "memory": memory,
        "n_devices": int(n_devices),
    }
    if platform is not None:
        cap, src = hbm_per_chip(platform, device)
        rec["platform"] = platform
        rec["hbm_per_chip"] = cap
        rec["hbm_source"] = src
        peak = (memory or {}).get("peak_hbm_bytes")
        if cap and peak is not None:
            rec["peak_hbm_per_chip_bytes"] = peak
            rec["hbm_headroom_fraction"] = 1.0 - peak / cap
    if expected is not None:
        mismatches = check_census(rec["census"], expected, ops=ops)
        rec["expected"] = expected
        rec["mismatches"] = mismatches
        rec["census_ok"] = not mismatches
    return rec


def format_bytes(n):
    """Human-readable byte count (shared by the report renderer)."""
    if n is None or not isinstance(n, (int, float)) or not math.isfinite(n):
        return "n/a"
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(n) >= div:
            return f"{n / div:,.2f} {unit}"
    return f"{n:,.0f} B"
