"""Worker process of the port's multi-process tests (spawned by
tests/test_torch_multihost.py; never collected).

    python tests/_torch_multihost_worker.py PID WORLD PORT OUTDIR

``WORLD`` processes join one gloo group on the CPU through
``multihost.initialize`` and drive the port's lockstep executor on process
meshes, the surface of the JAX package's ``_multihost_worker.py`` (two
processes) and ``_multihost_worker4.py`` (four) at their sizes. Each leg
writes this process's rows of the params (and optimizer state) to
``OUTDIR/<leg>.p<PID>.npz``; the last stdout line is one JSON object of
losses, census sites and checks, which the parent holds to the port's
lockstep twin and the JAX executor. Imports the port only.
"""

import json
import os
import sys


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
    from shallowspeed_tpu_torch.optimizer import SGD, Adam, MomentumSGD
    from shallowspeed_tpu_torch.parallel import executor as E
    from shallowspeed_tpu_torch.parallel import gradsync, multihost
    from shallowspeed_tpu_torch.parallel.lowering import lower_schedule

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=pid,
                         backend="gloo", device="cpu", timeout_s=60)
    assert multihost.process_count() == world and multihost.process_index() == pid

    SIZES, SIZES_I, B, M = (12, 10, 9, 8), (12, 11, 10, 9, 9, 8, 8, 8), 16, 2
    rng = np.random.RandomState(0)
    X = rng.randn(B, SIZES[0]).astype(np.float32)
    Y = np.eye(SIZES[-1], dtype=np.float32)[rng.randint(0, SIZES[-1], B)]
    out = {"pid": pid, "world": world}

    def save(leg, stacked, state=None):
        arrays = {f"{k}{l}": a.numpy() for k in ("W", "b") for l, a in enumerate(stacked[k])}
        if isinstance(state, dict):
            for key, leaf in utils._leaves(state):
                arrays["state_" + "_".join(str(p) for p in key)] = leaf.numpy()
        np.savez(os.path.join(outdir, f"{leg}.p{pid}.npz"), **arrays)

    def drive(leg, dp, pp, sizes=SIZES, sched=S.GPipeSchedule, opt=None, steps=1, zero=0,
              virtual=1, check_sync=False, prog_kw=None, **kw):
        """``steps`` steps of one layout on a process mesh over every
        process; the census of the first, held to the layout's contract."""
        mesh = multihost.make_process_mesh(dp, pp, device="cpu")
        opt = opt or SGD(0.05)
        spec = Mo.make_model_spec(sizes, pp * virtual, B)
        prog = lower_schedule(sched, M, pp, virtual=virtual, **(prog_kw or {}))
        order = E.interleave_order(pp * virtual, pp) if virtual > 1 else None
        stacked, flags = E.init_stacked(spec, mesh, order=order)
        state = E.zero1_init_state(opt, spec, mesh) if zero else opt.init(stacked)
        mb = B // dp // M
        step = E.make_pipeline_step(mesh, spec, prog, mb, opt, zero=zero, **kw)
        x = multihost.shard_batch_for_process(X, mesh, ("dp",))
        y = multihost.shard_batch_for_process(Y, mesh, ("dp",))
        losses = []
        for i in range(steps):
            if i == 0:
                with A.recording(torch.device("cpu")) as (census, _):
                    stacked, state, loss = step(stacked, flags, state, x, y)
                ops = census.ops()
                plan = gradsync.plan_buckets(spec, dp, pp, kw.get("grad_bucket_bytes", 0), zero=zero)
                exp = A.expected_comms(spec, dp, pp, prog, zero=zero, mubatch_size=mb,
                                       grad_bucket_plan=plan)
                out[f"{leg}_census"] = A.check_census(A.census_of_ops(ops), exp, ops=ops)
                out[f"{leg}_sites"] = {s: [k, b] for s, (k, b) in census.sites.items()}
            else:
                stacked, state, loss = step(stacked, flags, state, x, y)
            losses.append(float(loss))
            if check_sync:
                utils.assert_dp_replicas_in_sync_global(stacked, spec, mesh)
                if not zero:
                    utils.assert_dp_replicas_in_sync_global(state, spec, mesh)
        out[leg] = losses
        out[f"{leg}_stats"] = dict(mesh.comm.stats)
        save(leg, stacked, state)
        return mesh, spec, stacked

    if world == 2:
        # the cross-process dp sum of 1 and 2
        mesh = multihost.make_process_mesh(2, 2, device="cpu")
        got = mesh.comm.all_reduce(torch.full((1, 4), float(pid + 1)), "dp")
        out["psum"] = got.tolist()
        drive("gpipe", 2, 2)
        drive("zero1_clip", 2, 2, opt=MomentumSGD(0.05, 0.9), zero=1, clip_norm=1.0)
        drive("interleaved", 2, 2, sizes=SIZES_I, sched=S.InterleavedSchedule, virtual=2)
        drive("pallas", 2, 2, kernel_backend="pallas")
        drive("bucketed", 2, 2, grad_bucket_bytes=160)
        drive("zero1_bucketed", 2, 2, zero=1, grad_bucket_bytes=64)
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
        # both axes cross processes: dp {0,2}/{1,3}, the relays {0,1}/{2,3};
        # two momentum steps, the global check after each, state too
        mesh, spec, stacked = drive("mesh2x2", 2, 2, opt=MomentumSGD(0.05, 0.9), steps=2,
                                    check_sync=True)
        # the negative control: one process's copy diverged
        bad = {k: tuple(a.clone() for a in v) for k, v in stacked.items()}
        if pid == 3:
            bad["W"][0].view(-1)[0] += 0.5
        try:
            utils.assert_dp_replicas_in_sync_global(bad, spec, mesh)
            out["desync_detected"] = None
        except ValueError as e:
            out["desync_detected"] = str(e)
        drive("dp4", 4, 1, clip_norm=0.5)
        drive("dp2pp4_zero1", 2, 4, sizes=SIZES_I, opt=MomentumSGD(0.05, 0.9), zero=1,
              clip_norm=1.0)
        # the rest of the lattice with both axes crossing
        drive("pipedream_split", 2, 2, sched=S.PipeDreamFlushSchedule,
              prog_kw=dict(backward_split=True), check_sync=True)
        drive("recompute", 2, 2, prog_kw=dict(recompute=True), check_sync=True)
        drive("naive_adam_clip", 2, 2, sched=S.NaiveParallelSchedule, opt=Adam(0.05), steps=2,
              clip_norm=0.5, check_sync=True)
        drive("zero1_adam", 2, 2, opt=Adam(0.05), zero=1, steps=2, check_sync=True)
        # the telemetry aux: the grad and param norms over every process
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
