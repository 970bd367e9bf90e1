"""The check's control on the card, at each cell's own size: the reference
computed with TF32 products, in the program's place, is not correct, and
the program is. Run where a CUDA device is present:

    python -m pytest portbench/test_portbench_card.py -q
"""

import io
import json

import pytest

from portbench import check, control, harness

CELLS = ("mnist-mlp.epoch-kernel", "mlp-deep.seq-b1024", "mlp-deep.pp4-gpipe-b1024")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_check_and_the_program_passes(card, cell):
    bench = harness.Bench()
    out = io.StringIO()
    control.readings(bench, cell, [2**31 + 11], faults=True, device=card, out=out)
    rows = {r["kind"]: r["numbers"] for r in map(json.loads, out.getvalue().splitlines())}
    limits = bench.cell(cell)["cell"]["limits"]
    assert check.judge(rows["sound"], limits)[0], rows["sound"]
    assert not check.judge(rows["control_tf32"], limits)[0], rows["control_tf32"]
    assert not check.judge(rows["half_batch"], limits)[0], rows["half_batch"]
