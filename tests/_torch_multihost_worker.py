"""Worker process of the port's multi-process tests (spawned by
tests/test_torch_multihost.py; never collected).

    python tests/_torch_multihost_worker.py PID WORLD PORT OUTDIR

``WORLD`` processes join one gloo group on the CPU through
``multihost.initialize`` and drive the port's lockstep executor on process
meshes, the surface of the JAX package's ``_multihost_worker.py`` (two
processes) and ``_multihost_worker4.py`` (four) at their sizes. Each leg of
``LEGS`` for this world writes this process's share of the params (rows,
tp bands, or its ZeRO-3 shard) and optimizer state to
``OUTDIR/<leg>.p<PID>.npz``; the last stdout line is one JSON object of
losses, census sites and checks, which the parent holds to the port's
lockstep twin and the JAX executor. The parent reads ``LEGS`` from here.
Imports the port only.
"""

import json
import os
import sys

SIZES, SIZES_I, B, M = (12, 10, 9, 8), (12, 11, 10, 9, 9, 8, 8, 8), 16, 2
VAL_ROWS, VAL_PADDED = 13, 16  # the fused run's split, padded to a dp multiple

# every leg: name -> (the fleet's world, layout), run in this order. Layout
# keys: dp, pp, tp, sizes, sched (a schedules class name), virtual,
# backward_split, recompute, opt (sgd/momentum/adam), steps, zero,
# clip_norm, kernel_backend, grad_bucket_bytes, with_digests
LEGS = {
    "gpipe": (2, dict(dp=2, pp=2)),
    "zero1_clip": (2, dict(dp=2, pp=2, opt="momentum", zero=1, clip_norm=1.0)),
    "interleaved": (2, dict(dp=2, pp=2, sizes=SIZES_I, sched="InterleavedSchedule", virtual=2)),
    "pallas": (2, dict(dp=2, pp=2, kernel_backend="pallas")),
    "bucketed": (2, dict(dp=2, pp=2, grad_bucket_bytes=160)),
    "zero1_bucketed": (2, dict(dp=2, pp=2, zero=1, grad_bucket_bytes=64)),
    "zero2_pallas": (2, dict(dp=2, pp=2, opt="momentum", zero=2, kernel_backend="pallas", steps=2)),
    "zero3": (2, dict(dp=2, pp=2, opt="momentum", zero=3, steps=2)),
    "zero2_bucketed": (2, dict(dp=2, pp=2, opt="momentum", zero=2, grad_bucket_bytes=64, steps=2)),
    "tp2": (2, dict(dp=1, pp=1, tp=2, opt="momentum", steps=2)),
    "tp4": (2, dict(dp=1, pp=1, tp=4, steps=2)),
    "digests": (2, dict(dp=2, pp=2, opt="momentum", with_digests=True, steps=2)),
    "mesh2x2": (4, dict(dp=2, pp=2, opt="momentum", steps=2)),
    "dp4": (4, dict(dp=4, pp=1, clip_norm=0.5)),
    "dp2pp4_zero1": (4, dict(dp=2, pp=4, sizes=SIZES_I, opt="momentum", zero=1, clip_norm=1.0)),
    "pipedream_split": (4, dict(dp=2, pp=2, sched="PipeDreamFlushSchedule", backward_split=True)),
    "recompute": (4, dict(dp=2, pp=2, recompute=True)),
    "naive_adam_clip": (4, dict(dp=2, pp=2, sched="NaiveParallelSchedule", opt="adam", steps=2,
                                clip_norm=0.5)),
    "zero1_adam": (4, dict(dp=2, pp=2, opt="adam", zero=1, steps=2)),
    "zero2_mesh": (4, dict(dp=2, pp=2, opt="momentum", zero=2, steps=2)),
    "zero3_adam": (4, dict(dp=2, pp=2, opt="adam", zero=3, steps=2)),
    "dp2tp2": (4, dict(dp=2, pp=1, tp=2, opt="momentum", steps=2)),
    "dp2tp2_zero3": (4, dict(dp=2, pp=1, tp=2, opt="momentum", zero=3, steps=2)),
    "dp2pp2tp2_zero2": (4, dict(dp=2, pp=2, tp=2, opt="momentum", zero=2, steps=2)),
    "dp4_zero2_clip": (4, dict(dp=4, pp=1, opt="momentum", zero=2, clip_norm=0.5, steps=2)),
    "digests_zero1": (4, dict(dp=2, pp=2, opt="momentum", zero=1, with_digests=True, steps=2)),
    "tp4_digests": (4, dict(dp=1, pp=1, tp=4, with_digests=True)),
}


def main():
    pid, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch

    from shallowspeed_tpu_torch import model as Mo
    from shallowspeed_tpu_torch import schedules as S
    from shallowspeed_tpu_torch import utils
    from shallowspeed_tpu_torch.observability import metrics as Me
    from shallowspeed_tpu_torch.observability import program_audit as A
    from shallowspeed_tpu_torch.optimizer import SGD, MomentumSGD, make_optimizer
    from shallowspeed_tpu_torch.parallel import executor as E
    from shallowspeed_tpu_torch.parallel import gradsync, multihost
    from shallowspeed_tpu_torch.parallel.lowering import lower_schedule

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=pid,
                         backend="gloo", device="cpu", timeout_s=60)
    assert multihost.process_count() == world and multihost.process_index() == pid

    rng = np.random.RandomState(0)
    X = rng.randn(B, SIZES[0]).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], B)]
    out = {"pid": pid, "world": world}

    def save(leg, stacked, state=None):
        arrays = {f"{k}{l}": a.numpy() for k in ("W", "b") if k in stacked
                  for l, a in enumerate(stacked[k])}
        if "P" in stacked:
            arrays["P"] = stacked["P"].numpy()
        if isinstance(state, dict):
            for key, leaf in utils._leaves(state):
                arrays["state_" + "_".join(str(p) for p in key)] = leaf.numpy()
        np.savez(os.path.join(outdir, f"{leg}.p{pid}.npz"), **arrays)

    def drive(leg, dp, pp, tp=1, sizes=SIZES, sched="GPipeSchedule", virtual=1, opt=None,
              steps=1, zero=0, backward_split=False, recompute=False, with_digests=False, **kw):
        """``steps`` steps of one layout on a process mesh over every
        process, the global replica check after each; the census of the
        first, held to the layout's contract."""
        mesh = multihost.make_process_mesh(dp, pp, tp, device="cpu")
        opt = make_optimizer(opt or "sgd", 0.05)
        spec = Mo.make_model_spec(sizes, pp * virtual, B)
        prog = lower_schedule(getattr(S, sched), M, pp, virtual=virtual,
                              backward_split=backward_split, recompute=recompute)
        order = E.interleave_order(pp * virtual, pp) if virtual > 1 else None
        stacked, flags = E.init_stacked(spec, mesh, order=order)
        if zero >= 2:
            state = E.zero_block_init_state(opt, spec, mesh)
        else:
            state = E.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)
        if zero == 3:
            full, _ = E.stack_params(Mo.init_model(spec), spec, order=order, tp=tp)
            stacked = E.zero_params_at_rest(full, spec, mesh)
        mb = B // dp // M
        step = E.make_pipeline_step(mesh, spec, prog, mb, opt, zero=zero,
                                    with_digests=with_digests, **kw)
        x = multihost.shard_batch_for_process(X, mesh, ("dp",))
        y = multihost.shard_batch_for_process(Y, mesh, ("dp",))
        plan = gradsync.plan_buckets(spec, dp, pp, kw.get("grad_bucket_bytes", 0), zero=zero, tp=tp)
        exp = A.expected_comms(spec, dp, pp, prog, zero=zero, mubatch_size=mb,
                               grad_bucket_plan=plan, tp=tp)
        losses, digests = [], []
        for i in range(steps):
            if i == 0:
                with A.recording(torch.device("cpu")) as (census, _):
                    res = step(stacked, flags, state, x, y)
                ops = census.ops()
                out[f"{leg}_census"] = A.check_census(A.census_of_ops(ops), exp, ops=ops)
                out[f"{leg}_sites"] = {s: [k, b] for s, (k, b) in census.sites.items()}
                out[f"{leg}_stats"] = dict(mesh.comm.stats)  # the first step's
            else:
                res = step(stacked, flags, state, x, y)
            stacked, state, loss = res[:3]
            losses.append(float(loss))
            if with_digests:
                digests.append({k: v.tolist() for k, v in res[-1].items()})
            utils.assert_dp_replicas_in_sync_global(stacked, spec, mesh)
            utils.assert_dp_replicas_in_sync_global(state, spec, mesh, sharded=zero >= 1)
        out[leg] = losses
        if with_digests:
            out[f"{leg}_digests"] = digests
        save(leg, stacked, state)
        return mesh, spec, stacked

    def run_eval(leg, dp, pp):
        """The fused 2-epoch run with the in-run eval on a process mesh:
        this process's dp rows of the padded split, the whole split's
        labels."""
        mesh = multihost.make_process_mesh(dp, pp, device="cpu")
        spec = Mo.make_model_spec(SIZES, pp, B)
        vr = np.random.RandomState(1)
        VX = np.zeros((VAL_PADDED, SIZES[0]), np.float32)
        VX[:VAL_ROWS] = vr.randn(VAL_ROWS, SIZES[0])
        VY = vr.randint(0, SIZES[-1], VAL_ROWS)
        stacked, flags = E.init_stacked(spec, mesh)
        run = E.make_pipeline_run(
            mesh, spec, lower_schedule(S.GPipeSchedule, M, pp), B // dp // M, SGD(0.05),
            eval_prog=lower_schedule(S.InferenceSchedule, 1, pp, training=False),
            eval_mubatch_size=VAL_PADDED // dp,
        )
        stacked, _, losses, accs = run(
            stacked, flags, (), multihost.shard_batch_for_process(X, mesh, ("dp",))[None],
            multihost.shard_batch_for_process(Y, mesh, ("dp",))[None],
            multihost.shard_batch_for_process(VX, mesh, ("dp",)), torch.from_numpy(VY), 2)
        out[leg] = {"losses": losses.tolist(), "accs": accs.tolist()}
        save(leg, stacked)

    if world == 2:
        # the cross-process dp sum of 1 and 2
        mesh = multihost.make_process_mesh(2, 2, device="cpu")
        got = mesh.comm.all_reduce(torch.full((1, 4), float(pid + 1)), "dp")
        out["psum"] = got.tolist()
    for leg, (w, lay) in LEGS.items():
        if w == world:
            drive(leg, **lay)
    if world == 2:
        # the fused 2-epoch run
        spec = Mo.make_model_spec(SIZES, 2, B)
        prog = lower_schedule(S.GPipeSchedule, M, 2)
        stacked, flags = E.init_stacked(spec, mesh)
        run = E.make_pipeline_run(mesh, spec, prog, B // 2 // M, SGD(0.05))
        xs = multihost.shard_batch_for_process(X, mesh, ("dp",))[None]
        ys = multihost.shard_batch_for_process(Y, mesh, ("dp",))[None]
        stacked, _, losses = run(stacked, flags, (), xs, ys, 2)
        out["run"] = losses.tolist()
        save("run", stacked)
        run_eval("run_eval", 2, 2)
        # inference: this process's dp rows of the predictions
        iprog = lower_schedule(S.InferenceSchedule, M, 2, training=False)
        stacked, flags = E.init_stacked(spec, mesh)
        infer = E.make_pipeline_step(mesh, spec, iprog, B // 2 // M)
        preds = infer(stacked, flags, multihost.shard_batch_for_process(X, mesh, ("dp",)))
        np.save(os.path.join(outdir, f"infer.p{pid}.npy"), preds.numpy())
        # the full tree back on every process, for the hash
        out["hash"] = utils.model_hash(E.unstack_params(multihost.gather_stacked(stacked, mesh), spec))
        # one JSONL shard a process; one line from process 0
        with Me.JsonlMetrics(os.path.join(outdir, "m.jsonl")) as m:
            out["jsonl_path"] = m.path
            m.event("hello", pid=pid)
        utils.p0print("p0print from process 0")
        # the session refuses a multi-process group
        try:
            from shallowspeed_tpu_torch.api import TrainingSession

            TrainingSession(device="cpu", dp=2, pp=2)
            out["session_refused"] = False
        except ValueError as e:
            out["session_refused"] = "ROADMAP item 7b" in str(e)
    else:
        # the negative controls: one process's copy diverged, a stage row
        # of the 2x2 mesh and a tp band of DP=2 x TP=2
        for leg, dp, pp, tp in (("mesh2x2", 2, 2, 1), ("dp2tp2", 2, 1, 2)):
            mesh = multihost.make_process_mesh(dp, pp, tp, device="cpu")
            spec = Mo.make_model_spec(SIZES, pp, B)
            stacked, _ = E.init_stacked(spec, mesh)
            bad = {k: tuple(a.clone() for a in v) for k, v in stacked.items()}
            if pid == 3:
                bad["W"][0].view(-1)[0] += 0.5
            try:
                utils.assert_dp_replicas_in_sync_global(bad, spec, mesh)
                out[f"{leg}_desync"] = None
            except ValueError as e:
                out[f"{leg}_desync"] = str(e)
            # the gathered tree, from rows and bands (and a ZeRO-3 shard)
            full, _ = E.stack_params(Mo.init_model(spec), spec, tp=tp)
            got = multihost.gather_stacked(stacked, mesh)
            shard = E.zero_params_at_rest(full, spec, mesh)
            got3 = multihost.gather_stacked(shard, mesh, spec=spec)
            out[f"{leg}_gathered"] = all(
                np.array_equal(a, b) and np.array_equal(a, c)
                for k in ("W", "b") for a, b, c in zip(full[k], got[k], got3[k]))
        # the telemetry aux: the grad and param norms over every process
        mesh = multihost.make_process_mesh(2, 2, device="cpu")
        spec = Mo.make_model_spec(SIZES, 2, B)
        x = multihost.shard_batch_for_process(X, mesh, ("dp",))
        y = multihost.shard_batch_for_process(Y, mesh, ("dp",))
        for zero in (0, 1):
            stacked, flags = E.init_stacked(spec, mesh)
            opt = MomentumSGD(0.05, 0.9)
            state = E.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)
            step = E.make_pipeline_step(mesh, spec, lower_schedule(S.GPipeSchedule, M, 2), B // 2 // M,
                                        opt, zero=zero, clip_norm=0.5, with_step_stats=True)
            out[f"stats{zero}"] = [float(v) for v in step(stacked, flags, state, x, y)[2:]]
        run_eval("run_eval4", 2, 2)
        # inference: the head stage's process hands its rows to its pp group
        stacked, flags = E.init_stacked(spec, mesh)
        infer = E.make_pipeline_step(mesh, spec, lower_schedule(S.InferenceSchedule, M, 2, training=False),
                                     B // 2 // M)
        preds = infer(stacked, flags, multihost.shard_batch_for_process(X, mesh, ("dp",)))
        np.save(os.path.join(outdir, f"infer4.p{pid}.npy"), preds.numpy())
    multihost.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
