#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` (the AOT program cache) alone, on one GPU.

    python3 scripts/torch_aot_phase.py

Runs ``chip_smoke.py``'s phase 1 (the card's name and power limit) and its
phase 20 on the same seeded synthetic split, with the same checks and the
same lines: the cold-start breakdown, the cold, cache-warm and
corrupt-entry children (each from a fresh copy of the package, so its
``build/`` starts empty) and the fleet's cold and warm scale-ups. The
quick way to check a change to ``aot_cache.py``, ``_build.py`` or the
session's cache sites on the card. Exits non-zero when a check fails or no
GPU is present.
"""

import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is False: this script needs a GPU")
    from shallowspeed_tpu_torch import cuda_ops, resolve_device
    from shallowspeed_tpu_torch.api import TrainingSession

    os.environ.pop("SHALLOWSPEED_FAULTS", None)
    t0 = time.perf_counter()
    card = C.phase_device(torch, resolve_device)
    with tempfile.TemporaryDirectory() as tmp:
        C.write_split(Path(tmp), C.TRAIN_BATCHES * 128, C.VAL_ROWS)
        launches = C.phase_aot(torch, cuda_ops, TrainingSession, tmp, card)
    print(f"launches (children and drained replicas): {launches}")
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
