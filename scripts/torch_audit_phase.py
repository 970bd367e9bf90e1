#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the program audit) alone, on one GPU.

    python3 scripts/torch_audit_phase.py

Runs ``chip_smoke.py``'s phase 1 (the card's name and power limit) and its
phase 19 on the same seeded synthetic split, with the same checks and the
same per-leg lines: each audited leg census-clean and bitwise its twin with
the probe's launches exact, the ZeRO legs' measured peaks beside the
forecast, the negative controls, the serve CLI with ``--audit`` and the
linter. The quick way to check a change to
``observability/program_audit.py`` or to a data mover on the card. Exits
non-zero when a check fails or no GPU is present.
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
    from shallowspeed_tpu_torch import _build, cuda_ops, resolve_device
    from shallowspeed_tpu_torch.api import TrainingSession

    os.environ.pop("SHALLOWSPEED_FAULTS", None)
    t0 = time.perf_counter()
    card = C.phase_device(torch, resolve_device)
    C.phase_build(_build)
    with tempfile.TemporaryDirectory() as tmp:
        C.write_split(Path(tmp), C.TRAIN_BATCHES * 128, C.VAL_ROWS)
        C.phase_audit(torch, cuda_ops, TrainingSession, tmp, card)
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
