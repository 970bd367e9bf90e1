"""Numerics provenance: first-divergence attribution + checkpoint-bisect
replay over per-layer digest streams (docs/numerics.md "Divergence
debugging").

Copied from ``shallowspeed_tpu/observability/divergence.py``. The stream
analysis is the JAX module's; the bisect replay rebuilds the port's
``TrainingSession`` (on ``--device``, the card by default) from the
``digest_config`` record and resumes it through the port's ``checkpoint``
and ``faults``. The JAX record's ``scan_unroll``/``tick_unroll`` (lax.scan
unroll factors with identical numerics) have no counterpart and are not
passed on.

Two runs that should match — a resumed run vs an uninterrupted one, MPMD
vs lockstep, bucketed sync vs the anchor — historically compared ONE
number: ``utils.model_hash`` at the end. A mismatch said "something,
somewhere, at some point". The digest stream (schema v12,
``TrainingSession(digests=True)`` / ``train.py --digests``) records a
per-step, per-LAYER checksum + norm row computed inside the fused epoch
program, and this module turns two such streams into an attribution:

- ``first_divergence``  joins the streams and names the FIRST divergent
  ``(global_step, layer, tensor)`` — walking steps ascending, layers
  ascending, W before b — classified as a tolerance class from the
  recorded block norms (``ulp-level`` / ``float-tolerance`` / ``gross``)
  or ``structurally-missing`` (a step or layer one stream never
  recorded);
- ``tensor_diff``       elementwise float32 forensics for the bisect
  replay: max ULP distance (int32-lexicographic), the first differing
  flat index, and value-domain deltas;
- ``assert_models_equal`` / ``assert_digest_streams_equal``  the
  test-suite comparators: bitwise equality checks that FAIL with the
  attribution above instead of a bare hash mismatch;
- the CLI              ``python -m shallowspeed_tpu_torch.observability.divergence
  runA.jsonl runB.jsonl`` — exit 0 when the streams are bitwise-equal,
  2 on divergence (printing the attribution), 1 on usage/read errors.
  ``--bisect CKPT_DIR_A CKPT_DIR_B`` additionally restores each run's
  last agreeing step checkpoint (the ``digest_config`` record carries
  the session config + fault plan; ``die`` faults are stripped, step
  faults re-arm so injected flips reproduce), re-executes exactly ONE
  step under both configs, and dumps the offending tensor's diff.

The digest-at-step-N ↔ checkpoint-at-step-N+1 correspondence the bisect
relies on: a digest row covers the params AFTER step N's update, which
is exactly what the ``step-(N+1)`` snapshot holds (its cursor says "N+1
steps trained").
"""

import argparse
import sys

import numpy as np

# tolerance classes for a crc mismatch, from the recorded block norms:
# the max relative norm delta bounds how large the value-domain change
# can be, so a flipped mantissa LSB classifies as ulp-level while a real
# algorithmic drift classifies as float-tolerance or gross
TOLERANCE_CLASSES = (("ulp-level", 1e-9), ("float-tolerance", 1e-6))

_TENSORS = (("W", "crc_w", "pnorm_w", "gnorm_w"), ("b", "crc_b", "pnorm_b", "gnorm_b"))


def classify_rel(rel):
    """Map a max relative norm delta to its tolerance-class name."""
    for name, thr in TOLERANCE_CLASSES:
        if rel <= thr:
            return name
    return "gross"


def digest_stream(records, name="train"):
    """Index a record list's ``digest`` records by global step.

    Accepts the full ``read_jsonl`` output of a run (other kinds are
    skipped). The first record per step wins — a resumed run may re-emit
    a tail step it re-trained; the divergence walk wants the FIRST
    evidence for each step, matching the numbering contract (one
    optimizer step, one digest row).
    """
    out = {}
    for r in records:
        if r.get("kind") == "digest" and r.get("name", name) == name:
            out.setdefault(int(r["step"]), r)
    return out


def _rel_delta(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def first_divergence(recs_a, recs_b):
    """First divergent ``(global_step, layer, tensor)`` between two digest
    streams, or None when every recorded step is bitwise-equal.

    ``recs_a`` / ``recs_b``: record lists (``read_jsonl`` output) or the
    ``digest_stream`` dicts built from them. Returns a dict:
    ``step``/``layer``/``tensor`` name the divergence,
    ``classification`` is ``structurally-missing`` or a tolerance class
    from the recorded norms, ``last_agreeing_step`` is the newest step
    BEFORE it whose whole row matched (None when divergence is at the
    first recorded step) — the bisect replay's restore target is that
    step's post-update snapshot (``step-(last_agreeing+1)``).
    """
    sa = recs_a if isinstance(recs_a, dict) else digest_stream(recs_a)
    sb = recs_b if isinstance(recs_b, dict) else digest_stream(recs_b)
    last_agreeing = None
    for step in sorted(set(sa) | set(sb)):
        a, b = sa.get(step), sb.get(step)
        if a is None or b is None:
            return {
                "step": step, "layer": None, "tensor": None,
                "classification": "structurally-missing",
                "detail": f"step {step} missing from run "
                          f"{'A' if a is None else 'B'}",
                "last_agreeing_step": last_agreeing,
            }
        la, lb = int(a.get("layers", 0)), int(b.get("layers", 0))
        if la != lb:
            return {
                "step": step, "layer": min(la, lb), "tensor": None,
                "classification": "structurally-missing",
                "detail": f"step {step} records {la} layers in A vs {lb} in B",
                "last_agreeing_step": last_agreeing,
            }
        for layer in range(la):
            for tensor, ck, pk, gk in _TENSORS:
                ca, cb = int(a[ck][layer]), int(b[ck][layer])
                if ca == cb:
                    continue
                rel_p = _rel_delta(float(a[pk][layer]), float(b[pk][layer]))
                rel_g = _rel_delta(float(a[gk][layer]), float(b[gk][layer]))
                return {
                    "step": step, "layer": layer, "tensor": tensor,
                    "classification": classify_rel(max(rel_p, rel_g)),
                    "crc_a": ca, "crc_b": cb,
                    "pnorm_a": float(a[pk][layer]),
                    "pnorm_b": float(b[pk][layer]),
                    "rel_pnorm_delta": rel_p, "rel_gnorm_delta": rel_g,
                    "last_agreeing_step": last_agreeing,
                }
        last_agreeing = step
    return None


def format_divergence(div, label_a="run A", label_b="run B"):
    """Human-readable attribution lines for a ``first_divergence`` result."""
    lines = [
        f"first divergence: step {div['step']}"
        + (f" layer {div['layer']}" if div["layer"] is not None else "")
        + (f" tensor {div['tensor']}" if div["tensor"] else "")
    ]
    if "crc_a" in div:
        lines.append(
            f"  crc {label_a}=0x{div['crc_a']:08x} "
            f"{label_b}=0x{div['crc_b']:08x}"
        )
        lines.append(
            f"  classification: {div['classification']} "
            f"(rel pnorm delta {div['rel_pnorm_delta']:.3e}, "
            f"rel gnorm delta {div['rel_gnorm_delta']:.3e})"
        )
    else:
        lines.append(f"  classification: {div['classification']}"
                     f" — {div.get('detail', '')}")
    la = div.get("last_agreeing_step")
    lines.append(
        "  last agreeing step: "
        + ("none (diverged at the first recorded step)" if la is None else str(la))
    )
    return lines


def _f32_lex(a):
    """int32-lexicographic keys of float32 values: monotonic in the float
    order, adjacent representable floats differ by exactly 1 — so key
    distance IS the ULP distance. Both zeros map to 0."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.int64)
    return np.where(u < 0x80000000, u, 0x80000000 - u)


def tensor_diff(a, b):
    """Elementwise forensics for one block pair: ``n_diff`` (bitwise
    differing elements), ``first_index`` (first differing FLAT index, or
    None), ``max_ulp`` (int32-lexicographic ULP distance), and the
    value-domain ``max_abs_delta`` / ``max_rel_delta``."""
    fa = np.ascontiguousarray(np.asarray(a), np.float32).ravel()
    fb = np.ascontiguousarray(np.asarray(b), np.float32).ravel()
    if fa.shape != fb.shape:
        raise ValueError(f"shape mismatch: {fa.shape} vs {fb.shape}")
    neq = fa.view(np.uint32) != fb.view(np.uint32)
    n_diff = int(neq.sum())
    if n_diff == 0:
        return {"n_diff": 0, "first_index": None, "max_ulp": 0,
                "max_abs_delta": 0.0, "max_rel_delta": 0.0}
    ulp = np.abs(_f32_lex(fa) - _f32_lex(fb))
    da = np.abs(fa.astype(np.float64) - fb.astype(np.float64))
    denom = np.maximum(np.maximum(np.abs(fa), np.abs(fb)), 1e-30)
    return {
        "n_diff": n_diff,
        "first_index": int(np.argmax(neq)),
        "max_ulp": int(ulp.max()),
        "max_abs_delta": float(da.max()),
        "max_rel_delta": float((da / denom).max()),
    }


def assert_models_equal(params_a, params_b, label_a="A", label_b="B"):
    """Bitwise equality of two logical params trees, failing with the
    digest attribution — which (layer, tensor) diverged, how far —
    instead of a bare hash mismatch. The blocks compared are exactly
    ``utils.iter_param_blocks``'s (the ONE shared digest definition)."""
    from shallowspeed_tpu_torch import utils

    blocks_a = list(utils.iter_param_blocks(params_a))
    blocks_b = list(utils.iter_param_blocks(params_b))
    if len(blocks_a) != len(blocks_b):
        raise AssertionError(
            f"models differ structurally: {len(blocks_a)} blocks in "
            f"{label_a} vs {len(blocks_b)} in {label_b}"
        )
    bad = []
    for (gl, key, aa), (_, _, ab) in zip(blocks_a, blocks_b):
        if aa.shape != ab.shape:
            raise AssertionError(
                f"layer {gl} {key}: shape {aa.shape} in {label_a} vs "
                f"{ab.shape} in {label_b}"
            )
        if aa.tobytes() != ab.tobytes():
            d = tensor_diff(aa, ab)
            bad.append(
                f"layer {gl} {key}: {d['n_diff']}/{aa.size} elements "
                f"differ, max ulp {d['max_ulp']}, first flat index "
                f"{d['first_index']}, max rel delta {d['max_rel_delta']:.3e}"
            )
    if bad:
        raise AssertionError(
            f"models diverge ({label_a} vs {label_b}) — first at "
            + bad[0].split(":")[0] + ":\n  " + "\n  ".join(bad)
        )


def assert_digest_streams_equal(recs_a, recs_b, label_a="A", label_b="B"):
    """Bitwise equality of two digest streams, failing with the
    first-divergence attribution."""
    div = first_divergence(recs_a, recs_b)
    if div is not None:
        raise AssertionError(
            f"digest streams diverge ({label_a} vs {label_b}):\n"
            + "\n".join(format_divergence(div, label_a, label_b))
        )


# ---------------------------------------------------------------------------
# checkpoint-bisect replay
# ---------------------------------------------------------------------------


def _digest_config(records, path):
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "digest_config":
            return r
    raise ValueError(
        f"{path}: no digest_config record — was the run started with "
        "digests enabled (train.py --digests) and a metrics sink?"
    )


def _session_from_config(cfg, resume_path, device=None):
    """Reconstruct the recorded session (numerics-relevant config only) on
    ``device``, resumed from ``resume_path``, with ``die`` faults stripped
    — the replay must survive to the divergent step — and step faults
    (nan/flip) re-armed so an injected divergence reproduces."""
    from shallowspeed_tpu_torch import faults as F
    from shallowspeed_tpu_torch.api import TrainingSession

    plan = F.FaultPlan.parse(cfg.get("faults") or "")
    keep = ",".join(repr(f) for f in plan.faults if f.kind != "die")
    return TrainingSession(
        sizes=tuple(cfg["sizes"]),
        model=cfg.get("model"),
        dp=cfg["dp"], pp=cfg["pp"], tp=cfg["tp"],
        schedule=cfg["schedule"],
        global_batch_size=cfg["global_batch_size"],
        mubatches=cfg["mubatches"],
        lr=cfg["lr"],
        precision=cfg["precision"],
        data_dir=cfg.get("data_dir"),
        resume=resume_path,
        fuse_mubatches=cfg.get("fuse_mubatches", False),
        optimizer=cfg.get("optimizer", "sgd"),
        momentum=cfg.get("momentum", 0.9),
        virtual_stages=cfg.get("virtual_stages", 1),
        zero1=cfg.get("zero1", False),
        grad_bucket_bytes=cfg.get("grad_bucket_bytes", 0),
        backward_split=cfg.get("backward_split", False),
        recompute=cfg.get("recompute", False),
        weight_decay=cfg.get("weight_decay", 0.0),
        clip_norm=cfg.get("clip_norm"),
        faults=keep,
        device=device,
    )


def _advance_to(session, target_step):
    """Train the session forward until ``global_step == target_step``
    (chunk boundaries land on fault steps automatically)."""
    while session.global_step < target_step:
        session.train_steps(target_step - session.global_step)
    if session.global_step != target_step:
        raise ValueError(
            f"replay overshot: wanted step {target_step}, at "
            f"{session.global_step}"
        )


def bisect_replay(records_a, records_b, ckpt_dir_a, ckpt_dir_b, div, out=print,
                  device=None):
    """Restore each run's last agreeing snapshot, re-execute ONE step
    under both recorded configs, and dump the offending tensor's diff.

    ``div`` is the ``first_divergence`` result; the divergent step s*
    means: params after step s*−1 agree (snapshot ``step-(s*)``), params
    after step s* differ. Each side restores its newest verifying
    snapshot at-or-before s*, trains forward to global_step == s*, then
    trains exactly step s* — with the recorded fault plan re-armed
    (minus ``die``), so an injected flip fires again on its step.
    Returns the list of per-block ``tensor_diff`` results that differ.
    """
    from shallowspeed_tpu_torch import checkpoint as C
    from shallowspeed_tpu_torch import utils

    s_star = int(div["step"])
    cfg_a = _digest_config(records_a, "run A")
    cfg_b = _digest_config(records_b, "run B")
    sessions = []
    for label, cfg, ckpt_dir in (("A", cfg_a, ckpt_dir_a),
                                 ("B", cfg_b, ckpt_dir_b)):
        got, path, _meta, skipped = C.find_step_at_or_before(ckpt_dir, s_star)
        if got is None:
            raise ValueError(
                f"run {label}: no verifying step checkpoint at or before "
                f"step {s_star} in {ckpt_dir} (skipped: {skipped})"
            )
        out(f"run {label}: restoring {path} (step {got}), replaying "
            f"forward to step {s_star}")
        s = _session_from_config(cfg, path, device=device)
        _advance_to(s, s_star)
        sessions.append(s)
    sa, sb = sessions
    pre_a, pre_b = sa.params(), sb.params()
    pre_equal = utils.model_hash(pre_a) == utils.model_hash(pre_b)
    out(f"pre-step params at step {s_star}: "
        + ("bitwise-equal (divergence is INSIDE step "
           f"{s_star})" if pre_equal else
           "already differ (divergence predates the restored window — "
           "re-run with a denser checkpoint cadence)"))
    sa.train_steps(1)
    sb.train_steps(1)
    post_a, post_b = sa.params(), sb.params()
    diffs = []
    for (gl, key, aa), (_, _, ab) in zip(
        utils.iter_param_blocks(post_a), utils.iter_param_blocks(post_b)
    ):
        if aa.tobytes() == ab.tobytes():
            continue
        d = tensor_diff(aa, ab)
        d.update(layer=gl, tensor=key)
        diffs.append(d)
        out(
            f"  layer {gl} {key}: {d['n_diff']}/{aa.size} elements "
            f"differ, max ulp {d['max_ulp']}, first flat index "
            f"{d['first_index']}, max abs delta {d['max_abs_delta']:.6e}, "
            f"max rel delta {d['max_rel_delta']:.3e}"
        )
    if not diffs:
        out("  post-step params are bitwise-equal under replay — the "
            "recorded divergence did not reproduce (nondeterministic "
            "cause, or an un-rearmable fault)")
    elif div.get("layer") is not None:
        first = (diffs[0]["layer"], diffs[0]["tensor"])
        want = (div["layer"], div["tensor"])
        out(
            "  replay attribution "
            + ("MATCHES" if first == want else "DIFFERS FROM")
            + f" the stream's: first divergent block {first} vs "
            f"recorded {want}"
        )
    return diffs


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


class _Parser(argparse.ArgumentParser):
    # exit-code contract: 0 identical, 2 divergence — so usage/read
    # errors must NOT collide with argparse's default exit code 2
    def error(self, message):
        self.print_usage(sys.stderr)
        self.exit(1, f"{self.prog}: error: {message}\n")


def main(argv=None):
    ap = _Parser(
        prog="python -m shallowspeed_tpu_torch.observability.divergence",
        description="Join two runs' digest streams and name the first "
        "divergent (global_step, layer, tensor). Exit 0 when the streams "
        "are bitwise-equal, 2 on divergence, 1 on usage/read errors.",
    )
    ap.add_argument("run_a", help="metrics JSONL of run A (digest records)")
    ap.add_argument("run_b", help="metrics JSONL of run B")
    ap.add_argument(
        "--bisect", nargs=2, metavar=("CKPT_DIR_A", "CKPT_DIR_B"),
        default=None,
        help="restore each run's last agreeing step checkpoint and "
        "re-execute ONE step under both recorded configs, dumping the "
        "offending tensor's elementwise diff (max ULP distance, first "
        "differing flat index)",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where --bisect replays the step: cuda (the hand-written "
        "kernels) or cpu (the plain PyTorch path)",
    )
    args = ap.parse_args(argv)

    from shallowspeed_tpu_torch.observability.metrics import read_jsonl

    try:
        records_a = read_jsonl(args.run_a)
        records_b = read_jsonl(args.run_b)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sa, sb = digest_stream(records_a), digest_stream(records_b)
    if not sa or not sb:
        empty = args.run_a if not sa else args.run_b
        print(
            f"error: {empty}: no digest records — was the run started "
            "with --digests and --metrics-out?",
            file=sys.stderr,
        )
        return 1
    div = first_divergence(sa, sb)
    if div is None:
        steps = len(set(sa) & set(sb))
        layers = next(iter(sa.values())).get("layers", 0)
        print(
            f"IDENTICAL: {steps} steps x {layers} layers bitwise-equal "
            f"({args.run_a} vs {args.run_b})"
        )
        return 0
    print("DIVERGENT:")
    for line in format_divergence(div, "run-a", "run-b"):
        print(line)
    if args.bisect is not None:
        try:
            bisect_replay(records_a, records_b, args.bisect[0],
                          args.bisect[1], div, device=args.device)
        except ValueError as e:
            print(f"bisect error: {e}", file=sys.stderr)
            return 1
    return 2


if __name__ == "__main__":
    sys.exit(main())
