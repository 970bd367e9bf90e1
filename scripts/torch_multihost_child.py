#!/usr/bin/env python3
"""One process of ``chip_smoke.py`` phase 21 (the multi-process runtime).

    python3 scripts/torch_multihost_child.py PID WORLD PORT WORK [DEVICE]

``WORLD`` of these, started together, join one gloo process group on
``localhost:PORT`` (``multihost.initialize``; DEVICE ``cuda``, the
default, puts every process on ``cuda:0``, ``cpu`` runs the same on the
CPU) and run each leg of ``chip_smoke.mh_legs(DEVICE)`` on a process mesh
over the processes the leg names (``chip_smoke.mh_drive``, the same
function that runs the lockstep twin in the parent), on the batches
``WORK/x.npy`` and ``WORK/y.npy`` (the in-run eval on ``WORK/vx.npy`` and
``WORK/vy.npy``). Each leg's share of the params and optimizer state goes
to ``WORK/<leg>.p<PID>.npz``; the last line of the standard output is one
JSON object of every leg's losses, launches, census, replica checks and
step walls. Imports the port (and ``chip_smoke.py``'s standard-library
top), never JAX.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    pid, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    work = Path(sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cuda"
    t0 = time.perf_counter()
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from shallowspeed_tpu_torch.parallel import multihost

    import_s = time.perf_counter() - t0
    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=pid, backend="gloo",
                         device=device, timeout_s=C.MH_COLLECTIVE_TIMEOUT_S)
    X, Y = np.load(work / "x.npy"), np.load(work / "y.npy")
    val = np.load(work / "vx.npy"), np.load(work / "vy.npy")
    out = {"pid": pid, "import_s": import_s, "legs": {}}
    for label, processes, kw, _ in C.mh_legs(device):
        mesh = multihost.make_process_mesh(kw["dp"], kw["pp"], kw.get("tp", 1), device=device,
                                           processes=processes)
        if mesh is not None:
            res = C.mh_drive(torch, mesh, kw, X, Y, val=val)
            np.savez(work / f"{C.mh_slug(label)}.p{pid}.npz", **res.pop("arrays"))
            out["legs"][label] = res
        dist.barrier()  # a leg on part of the fleet: the others wait here
    multihost.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
