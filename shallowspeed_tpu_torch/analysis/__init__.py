"""Static program analysis over lowered tick programs: the port's copies of
the JAX package's ``analysis/progcheck.py`` (send/recv match, deadlock
freedom) and ``analysis/stash.py`` (stash lifetimes). The multi-card
runtime admits a program through ``analyze_program`` before it dispatches
it; the house-rule linter (``rules``/``lint``) is not ported.
"""

from shallowspeed_tpu_torch.analysis.progcheck import (
    ProgramAnalysisError,
    analyze_program,
    check_deadlock_free,
    check_send_recv,
)
from shallowspeed_tpu_torch.analysis.stash import check_stash_lifetime

__all__ = [
    "ProgramAnalysisError",
    "analyze_program",
    "check_deadlock_free",
    "check_send_recv",
    "check_stash_lifetime",
]
