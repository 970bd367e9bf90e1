"""MPMD per-stage pipeline runtime on one device: the port's counterpart of
``shallowspeed_tpu/parallel/mpmd.py``.

The JAX package's MPMD runtime is one host process that dispatches one
compiled program per STAGE ROLE (a stage's forward, its backward or split
B-input / B-weight halves, its optimizer update) onto each pipeline stage's
sub-mesh, straight from the lowered tick tables, with activations relayed
stage to stage by ``device_put``; each stage's device queue advances at its
own pace, ordered only by the data its programs read. This module runs the
same plan on one ``torch.device``:

- **one CUDA stream per stage** stands for a stage's device queue: every
  role of stage ``s`` is issued under ``torch.cuda.stream(streams[s])``, so
  the stages' kernels may overlap on the card where the data allows it;
- **event-ordered relays**: a relay records an event on the sender's stream
  and hands the payload over (one device, so nothing is copied); the
  receiving stage's stream waits on that event just before the program that
  consumes it. Every relayed tensor is ``record_stream``-ed onto the
  receiver's stream, so the caching allocator does not hand its memory to a
  new tensor of the sender while the receiver still reads it. The per-batch
  x / y stacks are copied from pinned host memory on the stream of the stage
  that reads them (stage 0, the head stage), so they never cross a stream;
- **no noop dispatches**: ``stage_cells`` keeps the tables' active cells
  only (the port's lockstep executor skips noops too, on one stream);
- **the admission gate** (``analysis.progcheck.analyze_program``) runs in
  each runner's constructor, before any stage program or stream exists;
- **bitwise parity with the lockstep executor**: every stage program calls
  the executor's own stage functions (``_stage_fwd`` / ``_stage_bwd`` / the
  split and tp variants) over the same zero-padded slot widths, for every
  dp (and tp) rank of its stage in rank order as the lockstep tick does;
  the gradients accumulate into ``torch.zeros_like`` slabs with ``add_`` in
  the tables' order (never by assignment: ``0.0 + (-0.0)`` is ``+0.0``);
  ``update`` is the fixed-order ``dp_sum`` then ``opt.apply`` on the
  stage's rows, in place. Adam's step count is a 'scalar' part that every
  stage advances once a batch from the same value, so the reassembled state
  is the lockstep state.

On one device a stage's params are zero-copy row slices of the session's
stacked tensors (``stage_param_view``: stage ``s`` owns rows ``s*V ..
s*V+V-1`` in ``executor.interleave_order``), and an update writes into those
rows, so reassembling the full mesh is the identity. There are no
sub-meshes, no reshard fallback and no packed representation (the JAX
package packs each stage's leaves into one buffer to cut XLA's per-program
dispatch cost; the port's stage views are already one set of tensors).

On the CPU the stream contexts are null contexts: the order of issue is the
only order, which is the lockstep executor's order. ``runtime="mpmd"`` in
``api.TrainingSession`` runs this module; ``parallel/multihost.py`` (several
processes) is a different, unported runtime.

``MpmdInferenceRunner`` streams request slots through per-stage forwards on
the same streams: ``submit`` issues a slot's whole chain without blocking
and returns a handle, so slot k enters stage 0 while slot k-1 occupies a
later stage.
"""

import contextlib
import functools
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import ops, resolve_device
from shallowspeed_tpu_torch.optimizer import join_state, split_state
from shallowspeed_tpu_torch.parallel import executor as E
from shallowspeed_tpu_torch.parallel.lowering import (
    OP_BWD,
    OP_BWD_W,
    OP_FWD,
    OP_NOOP,
    OP_RECOMPUTE,
)
from shallowspeed_tpu_torch.parallel.mesh import mesh_tp

# ---------------------------------------------------------------------------
# Zero-copy stage views
# ---------------------------------------------------------------------------


def _stage_rows(s, V):
    return slice(s * V, (s + 1) * V)


def stage_param_view(stacked, s, V):
    """Stage ``s``'s ``(V, ...)`` rows of the stacked ``{"W", "b"}`` tree:
    row slices of the same tensors (an in-place update of the view writes
    the session's rows)."""
    rows = _stage_rows(s, V)
    return {k: tuple(a[rows] for a in stacked[k]) for k in ("W", "b")}


def stage_flags_view(flags, s, V, device):
    """Stage ``s``'s flag rows: ``active``/``relu``/``residual`` as host
    lists (``[v][l]``; the host decides each slot's work, as the lockstep
    executor does) and ``head_mask`` as a ``(V, out_last)`` bool tensor on
    ``device`` (the softmax's operand)."""
    rows = _stage_rows(s, V)
    view = {k: np.asarray(flags[k])[rows].tolist() for k in ("active", "relu", "residual")}
    hm = np.ascontiguousarray(np.asarray(flags["head_mask"], np.bool_)[rows])
    view["head_mask"] = torch.from_numpy(hm).to(device)
    return view


def stage_state_view(opt, state, s, V):
    """Stage ``s``'s optimizer-state view: 'params' parts mirror the param
    stage view, 'scalar' parts (Adam's ``t``) are shared until the stage's
    first update replaces its own; ``()`` for stateless state."""
    if isinstance(state, tuple) and state == ():
        return ()
    parts, scalars = split_state(opt, state)
    return join_state(
        opt, {k: stage_param_view(v, s, V) for k, v in parts.items()}, dict(scalars)
    )


def _check_rows(views, full, what):
    """Every stage view is its rows of ``full``, in place (the identity
    reassembly's precondition)."""
    for k in ("W", "b"):
        for leaf, whole in enumerate(full[k]):
            for s, view in enumerate(v[k][leaf] for v in views):
                V = view.shape[0]
                want = whole.data_ptr() + s * V * whole.stride(0) * whole.element_size()
                if view.data_ptr() != want:
                    raise ValueError(f"{what}: stage {s}'s {k}[{leaf}] is not its rows of the full tensor")


def full_param_from_stage(stage_params, stacked):
    """The per-stage views -> the full stacked tree. Each view is its rows
    of ``stacked`` and every update wrote into it in place, so this is the
    identity (checked)."""
    _check_rows(stage_params, stacked, "full_param_from_stage")
    return stacked


def full_state_from_stage(opt, stage_states, opt_state):
    """The per-stage state views -> the full state: the 'params' parts are
    ``opt_state``'s own tensors (updated in place through the views), the
    'scalar' parts stage 0's (every stage advanced them the same way)."""
    if isinstance(opt_state, tuple) and opt_state == ():
        return ()
    parts, _ = split_state(opt, opt_state)
    split = [split_state(opt, st) for st in stage_states]
    for k, full in parts.items():
        _check_rows([p[k] for p, _ in split], full, "full_state_from_stage")
    return join_state(opt, parts, dict(split[0][1]))


# ---------------------------------------------------------------------------
# Per-stage comms contract (a copy of the JAX function)
# ---------------------------------------------------------------------------

_NEVER = ["collective_permute", "all_to_all", "reduce_scatter", "all_gather"]


def expected_stage_comms(role, spec, dp, tp, sends=True):
    """The per-stage-program collective contract (``mpmd.
    expected_stage_comms``, without the packed representation's roles):
    relays left the program, so a ``collective_permute`` anywhere in a stage
    program breaks it; the only lawful all-reduces are the Megatron tp sums
    inside compute roles and the dp gradient/loss sum inside the update/loss
    roles. ``sends`` (backward roles): whether the program returns its dx
    relay payload (a non-relaying first stage drops the last column slot's
    dx sum)."""
    required, forbidden = [], list(_NEVER)
    axes = {}
    if role in ("fwd", "fwd_ns", "recompute", "bwd", "bwd_in"):
        fwd_like = role in ("fwd", "fwd_ns", "recompute")
        if tp > 1:
            fwd_w, bwd_w = E.tp_allreduce_sites(spec, tp, training=True)
            sites = len(fwd_w) if fwd_like else len(bwd_w)
            if role in ("bwd", "bwd_in") and not sends:
                sites -= 1
            if sites > 0:
                required.append("all_reduce")
                axes["tp"] = {
                    "kind": "all_reduce",
                    "sites_fwd": sites if fwd_like else 0,
                    "sites_bwd": 0 if fwd_like else sites,
                    "hlo_min_all_reduce_ops": sites,
                }
        else:
            forbidden.append("all_reduce")
    elif role == "bwd_w":
        forbidden.append("all_reduce")
    elif role in ("update", "loss_sync"):
        if dp > 1:
            required.append("all_reduce")
    elif role == "infer_fwd":
        if tp > 1:
            fwd_w, _ = E.tp_allreduce_sites(spec, tp, training=False)
            if fwd_w:
                required.append("all_reduce")
                axes["tp"] = {
                    "kind": "all_reduce",
                    "sites_fwd": len(fwd_w),
                    "sites_bwd": 0,
                    "hlo_min_all_reduce_ops": len(fwd_w),
                }
        else:
            forbidden.append("all_reduce")
    else:
        raise ValueError(f"unknown stage-program role {role!r}")
    return {
        "dp": int(dp),
        "tp": int(tp),
        "zero1": False,
        "inference": False,
        "mpmd_role": role,
        "required": required,
        "forbidden": forbidden,
        "axes": axes,
    }


# ---------------------------------------------------------------------------
# The tick-table-driven host plan
# ---------------------------------------------------------------------------


def stage_cells(prog):
    """The per-stage streams read from the lowered tick tables: a list over
    ticks of the ACTIVE cells only (``mpmd.stage_cells``), each with the
    static facts a dispatch needs. Mailbox slot numbers are absent: the
    host dataflow is keyed by (chunk, microbatch)."""
    out = []
    for t in range(prog.num_ticks):
        row = []
        for s in range(prog.num_stages):
            op = int(prog.op[t, s])
            if op == OP_NOOP:
                continue
            row.append(
                dict(
                    s=s,
                    op=op,
                    mb=int(prog.mb[t, s]),
                    v=int(prog.chunk[t, s]) if prog.chunk is not None else 0,
                    load=bool(prog.load_in[t, s]),
                    head=bool(prog.is_head[t, s]),
                    send_fwd=bool(prog.send_fwd[t, s]),
                    send_bwd=bool(prog.send_bwd[t, s]),
                )
            )
        if row:
            out.append(row)
    return out


class _StagePrograms:
    """The per-stage programs of one (mesh, spec, prog): plain functions
    built lazily per ``(stage, role, variant)`` key. Each runs every dp
    replica of its stage in replica order (and, at tp > 1, every tp rank
    through the executor's Megatron stage functions), over per-replica
    tuples: a relay payload, a stash entry and a loss tally hold one tensor
    per replica."""

    def __init__(self, mesh, spec, prog, mubatch_size, opt=None):
        self.prog = prog
        self.tp = mesh_tp(mesh)
        self.dp = mesh.dp
        self.V = prog.num_chunks
        self.opt = opt
        self.act = spec.act
        self.rec = bool(getattr(prog, "recompute", False))
        self.dims = E.slot_shapes(spec, self.tp)
        self.D_in = self.dims[0][1]
        self.D_out = self.dims[-1][0]
        self.W_rel = E.relay_width(spec)
        self.mb_sz = mubatch_size  # rows per dp replica per microbatch
        self.B_global = spec.global_batch_size
        self._fns = {}

    # -- shared pieces --------------------------------------------------------

    def _rows(self, d):
        return slice(d * self.mb_sz, (d + 1) * self.mb_sz)

    def _fwd(self, params, flags, v, x):
        """The executor's stage forward of chunk ``v`` (the lockstep tick's
        ``fwd`` call: the same for the forward and the recompute)."""
        Ws, bs = [w[v] for w in params["W"]], [b[v] for b in params["b"]]
        a, r, res = flags["active"][v], flags["relu"][v], flags["residual"][v]
        if self.tp > 1:
            return E._stage_fwd_tp(Ws, bs, a, r, res, self.dims, x, self.act, self.tp)
        return E._stage_fwd(Ws, bs, a, r, res, self.dims, x, "xla", self.act)

    def _sink(self, acc, v):
        """Accumulate one replica's slot gradients into its slabs' chunk-v
        rows, through the rank views (the lockstep ``grad_sink``)."""
        tp = self.tp
        gW = [E._tp_w(w[v], l, tp) for l, w in enumerate(acc["W"])]
        gb = [E._tp_b(b[v], tp) for b in acc["b"]]

        def sink(l, dw, db):
            gW[l].add_(dw)
            gb[l].add_(db.reshape(tp, -1))

        return sink

    # -- builders ---------------------------------------------------------------

    def _build_fwd(self, s, v, load, head, send, training, stash=True):
        """The stage forward. Training signatures (``x_full``/``y_full``:
        the batch's ``(M, dp*mb, width)`` stacks; ``mb`` a host int):

            load+head: (params, flags, x_full, y_full, mb, loss_acc)
            load:      (params, flags, x_full, mb)
            head:      (params, flags, x_in, y_full, mb, loss_acc)
            neither:   (params, flags, x_in)

        ``x_in`` is the relayed payload (one tensor per replica). Returns
        ``(payload?, stash?, z?, loss_acc?)``: the payload when the cell
        sends, the ``(xs, masks)`` stash unless ``stash=False`` (the no-stash
        forward of a recompute program), the head logits with the stash, the
        new loss tally at the head. Inference: ``(params, flags, x)``, ``x``
        the slot's ``(dp*mb, in_dim)`` rows at the load stage, else the
        payload; returns ``(payload?, preds?)``."""
        dp, D_in, W_rel, B = self.dp, self.D_in, self.W_rel, self.B_global

        def fn(params, flags, x, *rest):
            if training and head:
                y_full, m, loss_acc = rest
            elif training and load:
                (m,) = rest
            hm = flags["head_mask"][v].reshape(1, -1) if head else None
            payload, xs_d, masks_d, z_d, loss_d, preds = [], [], [], [], [], []
            for d in range(dp):
                if training and load:
                    x_in = x[m, self._rows(d)]
                elif load:
                    x_in = E._fit(x[self._rows(d)], D_in)
                else:
                    x_in = E._fit(x[d], D_in)
                out, xs, masks = self._fwd(params, flags, v, x_in)
                if training:
                    xs_d.append(xs)
                    masks_d.append(masks)
                    if head:
                        z_d.append(out)
                        p = ops.softmax(out, valid_mask=hm)
                        loss_d.append(loss_acc[d] + ops.mse_loss(p, y_full[m, self._rows(d)], B))
                elif head:
                    preds.append(ops.softmax(out, valid_mask=hm))
                if send:
                    payload.append(E._fit(out, W_rel))
            rets = [tuple(payload)] if send else []
            if training:
                if stash:
                    rets.append((tuple(xs_d), tuple(masks_d)))
                    if head:
                        rets.append(tuple(z_d))
                if head:
                    rets.append(loss_d)
            elif head:
                rets.append(torch.cat(preds, dim=0))
            return tuple(rets)

        return fn

    def _build_recompute(self, s, v, load, head):
        """The OP_RECOMPUTE program: the stage forward again from the kept
        input (the load stage reloads its microbatch from the batch stack),
        returning the stash the backward consumes. No relay, no loss.

            load: (params, flags, x_full, mb);  else: (params, flags, x_in)"""
        dp, D_in = self.dp, self.D_in

        def fn(params, flags, x, *rest):
            xs_d, masks_d, z_d = [], [], []
            for d in range(dp):
                if load:
                    x_in = x[rest[0], self._rows(d)]
                else:
                    x_in = E._fit(x[d], D_in)
                out, xs, masks = self._fwd(params, flags, v, x_in)
                xs_d.append(xs)
                masks_d.append(masks)
                z_d.append(out)
            rets = [(tuple(xs_d), tuple(masks_d))]
            if head:
                rets.append(tuple(z_d))
            return tuple(rets)

        return fn

    def _build_bwd(self, s, v, head, send, split_input):
        """The combined backward, or (``split_input``) the split B-input
        half (the dgrad chain, returning the effective output-grads instead
        of accumulating weight gradients):

            combined head: (params, flags, xs, masks, z, y_full, mb, grads)
            split head:    (params, flags, masks, z, y_full, mb)
            combined:      (params, flags, xs, masks, g_relay, grads)
            split:         (params, flags, masks, g_relay)

        ``grads``: the stage's per-replica accumulators, updated in place and
        returned. Returns ``(payload?, grads | g_effs)``."""
        dp, tp, dims, W_rel, B = self.dp, self.tp, self.dims, self.W_rel, self.B_global

        def fn(params, flags, *args):
            if head:
                if split_input:
                    masks, z, y_full, m = args
                else:
                    xs, masks, z, y_full, m, grads = args
            elif split_input:
                masks, g_relay = args
            else:
                xs, masks, g_relay, grads = args
            Ws = [w[v] for w in params["W"]]
            a, r, res = flags["active"][v], flags["relu"][v], flags["residual"][v]
            hm = flags["head_mask"][v].reshape(1, -1) if head else None
            payload, g_effs_d = [], []
            for d in range(dp):
                if head:
                    g_in = ops.softmax_mse_head_grad(
                        z[d], y_full[m, self._rows(d)], B, valid_mask=hm
                    )
                else:
                    g_in = g_relay[d]
                if split_input:
                    if tp > 1:
                        dx, g_effs = E._stage_bwd_input_tp(Ws, a, r, res, dims, masks[d], g_in, tp)
                    else:
                        dx, g_effs = E._stage_bwd_input(Ws, a, r, res, dims, masks[d], g_in)
                    g_effs_d.append(g_effs)
                else:
                    sink = self._sink(grads[d], v)
                    if tp > 1:
                        dx = E._stage_bwd_tp(Ws, a, r, res, dims, xs[d], masks[d], g_in, tp, sink)
                    else:
                        dx = E._stage_bwd(Ws, a, r, res, dims, xs[d], masks[d], g_in, "xla", sink)
                if send:
                    payload.append(E._fit(dx, W_rel))
            rets = [tuple(payload)] if send else []
            rets.append(tuple(g_effs_d) if split_input else grads)
            return tuple(rets)

        return fn

    def _build_bwd_w(self, s, v):
        """The deferred B-weight half: ``(flags, xs, g_effs, grads) ->
        grads``, the weight gradients from the two stashes accumulated in
        the tables' (= the combined backward's) order."""
        dp, tp = self.dp, self.tp

        def fn(flags, xs, g_effs, grads):
            active = flags["active"][v]
            for d in range(dp):
                sink = self._sink(grads[d], v)
                if tp > 1:
                    E._stage_bwd_weight_tp(active, xs[d], g_effs[d], tp, sink)
                else:
                    E._stage_bwd_weight(active, xs[d], g_effs[d], sink)
            return grads

        return fn

    def _build_update(self, s):
        """The per-stage optimizer tail: ``(params, grads, state) ->
        (params, state)``, the replicas' accumulators summed in replica
        order (``executor.dp_sum``), then ``opt.apply`` on the stage's rows,
        in place."""
        opt = self.opt

        def fn(params, grads, state):
            return opt.apply(params, E.dp_sum(grads), state)

        return fn

    def _build_loss_sync(self, s):
        """``loss_acc -> loss``: the head stage's per-replica tallies summed
        in replica order (the lockstep dp sum)."""

        def fn(loss_acc):
            return functools.reduce(torch.add, loss_acc)

        return fn

    # -- lookup -------------------------------------------------------------------

    def get(self, s, role, variant=()):
        key = (s, role, variant)
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        if role in ("fwd", "fwd_ns", "infer_fwd"):
            v, load, head, send = variant
            fn = self._build_fwd(
                s, v, load, head, send, training=role != "infer_fwd", stash=role != "fwd_ns"
            )
        elif role == "recompute":
            v, load, head = variant
            fn = self._build_recompute(s, v, load, head)
        elif role in ("bwd", "bwd_in"):
            v, head, send = variant
            fn = self._build_bwd(s, v, head, send, split_input=role == "bwd_in")
        elif role == "bwd_w":
            (v,) = variant
            fn = self._build_bwd_w(s, v)
        elif role == "update":
            fn = self._build_update(s)
        elif role == "loss_sync":
            fn = self._build_loss_sync(s)
        else:
            raise ValueError(f"unknown stage-program role {role!r}")
        self._fns[key] = fn
        return fn

    def label(self, s, role, variant=()):
        """The program's name in records (``mpmd_s{s}_{role}[_{variant}]``;
        ``mpmd_inf`` for the inference set), as the JAX package labels it."""
        kind = "mpmd" if self.prog.is_training else "mpmd_inf"
        tag = "".join(str(int(x)) for x in variant)
        return f"{kind}_s{s}_{role}" + (f"_{tag}" if tag else "")


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


class _Streams:
    """The per-stage streams of one device (None on the CPU) and the
    orderings between them and the caller's stream."""

    def __init__(self, device, n, streams=None):
        self.device = device
        if device.type != "cuda":
            self.streams = None
        elif streams is not None:
            if len(streams) != n:
                raise ValueError(f"{len(streams)} streams for {n} stages")
            self.streams = list(streams)
        else:
            self.streams = [torch.cuda.Stream(device) for _ in range(n)]

    def on(self, s):
        """Issue under stage ``s``'s stream (a null context on the CPU)."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[s])

    def enter(self):
        """Every stage stream waits on the caller's stream: what the caller
        wrote before (a weight load, a poisoned element) lands first."""
        if self.streams is not None:
            cur = torch.cuda.current_stream(self.device)
            for st in self.streams:
                st.wait_stream(cur)

    def join(self):
        """The caller's stream waits on every stage stream: a reader that
        follows on it sees every stage's writes."""
        if self.streams is not None:
            cur = torch.cuda.current_stream(self.device)
            for st in self.streams:
                cur.wait_stream(st)

    def synchronize(self):
        """The host waits for every stage stream."""
        if self.streams is not None:
            for st in self.streams:
                st.synchronize()

    def handover(self, src, dst, payload):
        """A relay from stage ``src`` to ``dst``: an event on the sender's
        stream (None on the CPU or within one stream), and every tensor
        marked in use by the receiver's stream."""
        if self.streams is None or src == dst:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[src])
        for t in payload:
            t.record_stream(self.streams[dst])
        return ev

    def receive(self, s, ev):
        if ev is not None:
            self.streams[s].wait_event(ev)

    def to_device(self, a):
        """Host rows onto the device, issued on the current stream: from
        pinned memory without blocking on the card; on the CPU a tensor over
        the array."""
        t = torch.from_numpy(a)
        if self.streams is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)


# ---------------------------------------------------------------------------
# The training runner
# ---------------------------------------------------------------------------


class MpmdTrainRunner:
    """The training-side MPMD runtime: per-stage programs and the
    tick-table-driven host loop (``mpmd.MpmdTrainRunner``).

    ``run(stacked, flags, opt_state, X, Y)`` has the lockstep epoch's
    signature and state contract: the stacked tensors and the optimizer
    state are updated in place through the stage views and returned with
    the batches' mean loss (a 0-d tensor, the lockstep epoch's sum in batch
    order over the batch count). ``X``/``Y``: host arrays ``(nb, B, ...)``.
    ``flags``: the host flags of ``stack_params``.

    Construction runs the admission gate first: ``analyze_program`` must
    prove the tables send/recv-matched and deadlock-free before any stage
    program or stream exists (``ProgramAnalysisError`` otherwise).
    With an enabled ``tracer`` each ``run`` emits the first batch's
    ``stage.*`` span chain. ``dispatch_count``/``relay_count`` count the
    stage-program calls and the relays issued."""

    def __init__(self, mesh, spec, prog, mubatch_size, opt, tracer=None):
        from shallowspeed_tpu_torch.analysis import analyze_program

        self.admission = analyze_program(prog, program="mpmd_train")
        if not prog.is_training:
            raise ValueError("MpmdTrainRunner needs a training TickProgram")
        self.device = resolve_device(mesh.device)
        self.P = prog.num_stages
        self.V = prog.num_chunks
        self.dp = mesh.dp
        self.opt = opt
        self.split = bool(prog.backward_split)
        self.programs = _StagePrograms(mesh, spec, prog, mubatch_size, opt)
        self.cells = stage_cells(prog)
        self.M = prog.num_micro_batches
        self.mb_sz = mubatch_size
        self._tracer = tracer
        self.dispatch_count = 0
        self.relay_count = 0
        self._streams = _Streams(self.device, self.P)

    @property
    def streams(self):
        """The per-stage CUDA streams (None on the CPU)."""
        return self._streams.streams

    def join(self):
        """Make the caller's current stream wait on every stage stream."""
        self._streams.join()

    # -- one batch --------------------------------------------------------------

    def _put_batch(self, xb, yb):
        """Host batch -> one ``(M, dp*mb, width)`` stack each for x and y,
        widths padded to the executor's D_in/D_out (exact zeros), rank
        ``r``'s rows of microbatch ``m`` the lockstep shard's. x is copied
        on stage 0's stream, y on the head stage's: the streams that read
        them."""
        dp, M, mb = self.dp, self.M, self.mb_sz

        def stack(a, w):
            a = np.asarray(a, np.float32).reshape(a.shape[0], -1)
            if a.shape[-1] != w:
                a = np.pad(a, ((0, 0), (0, w - a.shape[-1])))
            a = np.ascontiguousarray(a.reshape(dp, M, mb, w).transpose(1, 0, 2, 3))
            return self._streams.to_device(a.reshape(M, dp * mb, w))

        with self._streams.on(0):
            x = stack(xb, self.programs.D_in)
        with self._streams.on(self.P - 1):
            y = stack(yb, self.programs.D_out)
        return x, y

    def _span(self, spans, name, t0, **fields):
        if spans is not None:
            spans.append((name, t0, time.perf_counter(), fields))

    def _zero_grads(self, params):
        """One stage's per-replica accumulators (``zeros_like`` the stage's
        slabs; the first gradient is added to them, as the lockstep adds)."""
        return [
            {k: tuple(torch.zeros_like(a) for a in params[k]) for k in ("W", "b")}
            for _ in range(self.dp)
        ]

    def run_batch(self, params, flags, state, xb, yb, spans=None):
        """Issue one global batch through the per-stage streams; nothing
        here waits on the card. ``params``/``flags``/``state``: per-stage
        views (updated in place). Returns the batch loss (a 0-d tensor on
        the head stage's stream)."""
        progs, st, P = self.programs, self._streams, self.P
        rec = progs.rec
        x_full, y_full = self._put_batch(xb, yb)
        mail = {}
        stash = [dict() for _ in range(P)]
        gstash = [dict() for _ in range(P)]
        xin = [dict() for _ in range(P)]  # recompute: kept stage inputs
        grads = [None] * P
        for s in range(P):
            with st.on(s):
                grads[s] = self._zero_grads(params[s])
        with st.on(P - 1):
            loss_acc = [torch.zeros((), dtype=torch.float32, device=self.device)
                        for _ in range(self.dp)]

        def relay(direction, src, payload, key):
            dst = (src + 1) % P if direction == "fwd" else (src - 1) % P
            v, mb = key
            if direction == "fwd" and src == P - 1:
                v += 1
            elif direction == "bwd" and src == 0:
                v -= 1
            t0 = time.perf_counter()
            ev = st.handover(src, dst, payload)
            self.relay_count += 1
            self._span(spans, "stage.relay", t0, stage=src, to_stage=dst,
                       direction=direction, mb=mb)
            mail[(direction, dst, (v, mb))] = (payload, ev)

        def receive(direction, s, key):
            payload, ev = mail.pop((direction, s, key))
            st.receive(s, ev)
            return payload

        for row in self.cells:
            for c in row:
                s, v, mb = c["s"], c["v"], c["mb"]
                key = (v, mb)
                t0 = time.perf_counter()
                if c["op"] == OP_FWD:
                    fn = c.get("_fn")
                    if fn is None:
                        fn = c["_fn"] = progs.get(
                            s, "fwd_ns" if rec else "fwd",
                            (v, c["load"], c["head"], c["send_fwd"]),
                        )
                    if c["load"]:
                        args = (x_full,)
                    else:
                        x_in = receive("fwd", s, key)
                        if rec:
                            xin[s][key] = x_in
                        args = (x_in,)
                    if c["head"]:
                        args += (y_full, mb, loss_acc)
                    elif c["load"]:
                        args += (mb,)
                    with st.on(s):
                        outs = fn(params[s], flags[s], *args)
                    i = 1 if c["send_fwd"] else 0
                    if not rec:
                        xs_masks = outs[i]
                        stash[s][key] = xs_masks + ((outs[i + 1],) if c["head"] else (None,))
                    if c["head"]:
                        loss_acc = outs[-1]
                    self.dispatch_count += 1
                    self._span(spans, "stage.dispatch", t0, stage=s, op="fwd", mb=mb)
                    if c["send_fwd"]:
                        relay("fwd", s, outs[0], key)
                elif c["op"] == OP_RECOMPUTE:
                    fn = c.get("_fn")
                    if fn is None:
                        fn = c["_fn"] = progs.get(s, "recompute", (v, c["load"], c["head"]))
                    args = (x_full, mb) if c["load"] else (xin[s].pop(key),)
                    with st.on(s):
                        outs = fn(params[s], flags[s], *args)
                    stash[s][key] = outs[0] + ((outs[1],) if c["head"] else (None,))
                    self.dispatch_count += 1
                    self._span(spans, "stage.dispatch", t0, stage=s, op="recompute", mb=mb)
                elif c["op"] == OP_BWD and self.split:
                    _, masks, z = stash[s][key]  # peek: the B-weight frees it
                    fn = c.get("_fn")
                    if fn is None:
                        fn = c["_fn"] = progs.get(s, "bwd_in", (v, c["head"], c["send_bwd"]))
                    if c["head"]:
                        args = (masks, z, y_full, mb)
                    else:
                        args = (masks, receive("bwd", s, key))
                    with st.on(s):
                        outs = fn(params[s], flags[s], *args)
                    gstash[s][key] = outs[-1]
                    self.dispatch_count += 1
                    self._span(spans, "stage.dispatch", t0, stage=s, op="bwd_in", mb=mb)
                    if c["send_bwd"]:
                        relay("bwd", s, outs[0], key)
                elif c["op"] == OP_BWD:
                    xs, masks, z = stash[s].pop(key)
                    fn = c.get("_fn")
                    if fn is None:
                        fn = c["_fn"] = progs.get(s, "bwd", (v, c["head"], c["send_bwd"]))
                    if c["head"]:
                        args = (xs, masks, z, y_full, mb, grads[s])
                    else:
                        args = (xs, masks, receive("bwd", s, key), grads[s])
                    with st.on(s):
                        outs = fn(params[s], flags[s], *args)
                    grads[s] = outs[-1]
                    self.dispatch_count += 1
                    self._span(spans, "stage.dispatch", t0, stage=s, op="bwd", mb=mb)
                    if c["send_bwd"]:
                        relay("bwd", s, outs[0], key)
                elif c["op"] == OP_BWD_W:
                    xs, _, _ = stash[s].pop(key)
                    g_effs = gstash[s].pop(key)
                    fn = c.get("_fn")
                    if fn is None:
                        fn = c["_fn"] = progs.get(s, "bwd_w", (v,))
                    with st.on(s):
                        grads[s] = fn(flags[s], xs, g_effs, grads[s])
                    self.dispatch_count += 1
                    self._span(spans, "stage.dispatch", t0, stage=s, op="bwd_w", mb=mb)
                else:
                    raise ValueError(f"stage {s}: op code {c['op']} not ported")

        assert not mail, "undelivered relay payloads (tables violated)"
        assert not any(xin), "unconsumed recompute input handles"
        # the per-stage optimizer tail: dp sum + update, one dispatch a stage
        for s in range(P):
            t0 = time.perf_counter()
            with st.on(s):
                progs.get(s, "update")(params[s], grads[s], state[s])
            self.dispatch_count += 1
            self._span(spans, "stage.dispatch", t0, stage=s, op="update")
        with st.on(P - 1):
            loss = progs.get(P - 1, "loss_sync")(loss_acc)
        self.dispatch_count += 1
        return loss

    def run(self, stacked, flags, opt_state, X, Y, trace_id=None):
        """The epoch-shaped entry point (the lockstep epoch's signature):
        the batches of ``X``/``Y`` through ``run_batch`` in order. Reads no
        loss until the loop ends, and returns only when every stage stream
        has finished (the lockstep epoch's timing contract). Returns
        ``(stacked, opt_state, mean_loss)``."""
        st, P, V = self._streams, self.P, self.V
        params = [stage_param_view(stacked, s, V) for s in range(P)]
        flag_views = [stage_flags_view(flags, s, V, self.device) for s in range(P)]
        states = [stage_state_view(self.opt, opt_state, s, V) for s in range(P)]
        st.enter()
        nb = len(X)
        with st.on(P - 1):
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for k in range(nb):
            spans = None
            if self._tracer is not None and self._tracer.enabled and k == 0:
                spans = []
            loss = self.run_batch(params, flag_views, states, X[k], Y[k], spans=spans)
            if spans is not None:
                # one chain a traced batch, its update span the terminal: the
                # chain's timeline is the batch's host issue window
                tid = trace_id or "mpmd"
                for i, (name, t0, t1, fields) in enumerate(spans):
                    last = i == len(spans) - 1
                    self._tracer.span(
                        name, f"{tid}-b{k}", t0, t1, terminal=last,
                        **(dict(fields, verdict="ok") if last else fields),
                    )
            with st.on(P - 1):
                loss_sum = loss_sum + loss
        with st.on(P - 1):
            mean_loss = loss_sum / nb
        new_stacked = full_param_from_stage(params, stacked)
        new_state = full_state_from_stage(self.opt, states, opt_state)
        st.synchronize()
        return new_stacked, new_state, mean_loss

    def planned_programs(self):
        """Every (stage, role, variant) the plan can dispatch, in first-use
        order, then each stage's update and the head's loss sync."""
        seen = {}
        rec = self.programs.rec
        for row in self.cells:
            for c in row:
                s, v = c["s"], c["v"]
                if c["op"] == OP_FWD:
                    role = "fwd_ns" if rec else "fwd"
                    seen[(s, role, (v, c["load"], c["head"], c["send_fwd"]))] = c
                elif c["op"] == OP_RECOMPUTE:
                    seen[(s, "recompute", (v, c["load"], c["head"]))] = c
                elif c["op"] == OP_BWD and self.split:
                    seen[(s, "bwd_in", (v, c["head"], c["send_bwd"]))] = c
                elif c["op"] == OP_BWD:
                    seen[(s, "bwd", (v, c["head"], c["send_bwd"]))] = c
                else:
                    seen[(s, "bwd_w", (v,))] = c
        keys = list(seen)
        for s in range(self.P):
            keys.append((s, "update", ()))
        keys.append((self.P - 1, "loss_sync", ()))
        return keys


# ---------------------------------------------------------------------------
# The inference runner
# ---------------------------------------------------------------------------


class MpmdHandle:
    """One submitted slot: the head output and an event recorded on the
    head stage's stream after it. ``result()`` waits on the event, then
    copies the rows to the host (once)."""

    __slots__ = ("_out", "_event", "_host")

    def __init__(self, out, event):
        self._out, self._event, self._host = out, event, None

    def result(self):
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
            self._host = self._out.cpu().numpy()
            self._out = None
        return self._host


class MpmdInferenceRunner:
    """Forward-only MPMD streaming (``mpmd.MpmdInferenceRunner``): the
    inference tables' chain of stage hops for one slot, admission-gated
    like the trainer. ``submit()`` issues a slot's whole chain and returns
    an ``MpmdHandle``; nothing in it blocks, so consecutive submits
    pipeline across the stage streams."""

    def __init__(self, mesh, spec, prog, mubatch_size, streams=None):
        from shallowspeed_tpu_torch.analysis import analyze_program

        self.admission = analyze_program(prog, program="mpmd_infer")
        if prog.is_training:
            raise ValueError("MpmdInferenceRunner needs an inference program")
        self.device = resolve_device(mesh.device)
        self.P = prog.num_stages
        self.V = prog.num_chunks
        self.programs = _StagePrograms(mesh, spec, prog, mubatch_size, None)
        self.dispatch_count = 0
        # every slot's cells are slot 0's (a straight pipeline), so the
        # M-slot tables collapse to slot 0's chain
        self.chain = [c for row in stage_cells(prog) for c in row if c["mb"] == 0]
        self._streams = _Streams(self.device, self.P, streams)

    def enter(self):
        """Order the caller's earlier writes (on its current stream) before
        the next submits: call after the weights change in place."""
        self._streams.enter()

    def submit(self, params, flag_views, x_slot):
        """Issue one slot (``(dp*mb, in_dim)`` host rows) through the stage
        chain; returns its ``MpmdHandle``."""
        st = self._streams
        with st.on(self.chain[0]["s"]):
            x = st.to_device(np.ascontiguousarray(np.asarray(x_slot, np.float32)))
        preds = ev = None
        prev = self.chain[0]["s"]
        for c in self.chain:
            s, v = c["s"], c["v"]
            st.receive(s, ev)
            fn = c.get("_fn")
            if fn is None:
                fn = c["_fn"] = self.programs.get(
                    s, "infer_fwd", (v, c["load"], c["head"], c["send_fwd"])
                )
            with st.on(s):
                outs = fn(params[s], flag_views[s], x)
            self.dispatch_count += 1
            prev = s
            if c["head"]:
                preds = outs[-1]
            ev = None
            if c["send_fwd"]:
                x = outs[0]
                ev = st.handover(s, (s + 1) % self.P, x)
        done = None
        if st.streams is not None:
            done = torch.cuda.Event()
            done.record(st.streams[prev])
        return MpmdHandle(preds, done)

    def views(self, stacked, flags):
        """Per-stage param and flag views of the session's stacked tensors
        (rebuild after the tensors are replaced)."""
        params = [stage_param_view(stacked, s, self.V) for s in range(self.P)]
        fls = [stage_flags_view(flags, s, self.V, self.device) for s in range(self.P)]
        return params, fls
