#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` (the multi-process runtime) alone, on one GPU.

    python3 scripts/torch_multihost_phase.py [--device cpu]

Runs ``chip_smoke.py``'s phase 1 (the card's name and power limit), builds
the kernels (phase 2) and runs its phase 21 on the same seeded synthetic
split, with the same checks and lines: four child processes
(``scripts/torch_multihost_child.py``) sharing the card over gloo, each leg
held to the lockstep twin run in this process. The quick way to check a
change to ``parallel/multihost.py`` or the executor's movers on the card.
``--device cpu`` runs the phase's logic on the CPU (the kernels' plain
versions, and without mlp-deep's legs, a card-size model; no GPU
needed). Exits non-zero when a check fails or, without
``--device cpu``, no GPU is present.
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch

    import chip_smoke as C

    from shallowspeed_tpu_torch import _build, cuda_ops, resolve_device

    os.environ.pop("SHALLOWSPEED_FAULTS", None)
    t0 = time.perf_counter()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            C.fail("torch.cuda.is_available() is False: this script needs a GPU")
        card = C.phase_device(torch, resolve_device)
        C.phase_build(_build)
    else:
        card = "the CPU"
    with tempfile.TemporaryDirectory() as tmp:
        C.write_split(Path(tmp), C.TRAIN_BATCHES * 128, C.VAL_ROWS)
        launches = C.phase_multihost(torch, cuda_ops, tmp, card, device=args.device)
    print(f"launches (each child's own): {launches}")
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
