"""On the card, at each cell's own batch: the control (the reference in
place of the port, one precision step down: TF32 products, a bfloat16
plant) fails the output check, and the port passes it, on three seeds,
through the numbers and the verdict that decide ``correct``. Run on the
card with ``python3 -m pytest benchmark/tests -m card``."""
import pytest

import calibrate
from harness import cells, check

CELLS = ["circle8.sweep", "parallel11ss.sweep"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_and_program_passes(card, name, seed):
    cell = cells.load(name)
    lims = check.limits(cell.config)
    r = calibrate.readings(cell, seed, card, control=True)
    prog = check.reduce({n: r["program"][n] for n in lims})
    ctrl = check.reduce({n: r["control"][n] for n in lims})
    assert check.verdict(prog, lims), prog
    assert not check.verdict(ctrl, lims), ctrl
