"""The plain reference agrees with the port's CPU path at a tiny size: the
port's step in float64 on the CPU (every kernel wrapper takes its plain
version there) against the reference's, layer by layer, from the same
carry; and the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest
import torch

from harness import cells, check
from harness.program import Program, capture, capture_out
from traffic.generate import generate

BENCH = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["circle8.sweep", "parallel11ss.sweep"])
def test_reference_matches_the_port_in_float64(name):
    cell = cells.load(name)
    config = {**cell.config, "dtype": "float64"}
    tensors = generate(config, cell.mix, 5, "cpu", batch=3)
    prog = Program(config, tensors)
    carry = prog.carry0
    for k in range(3):                  # the third step from a moved carry
        cap = {}
        with capture(prog, carry, torch.arange(1, 3), cap):
            carry_next, out = prog.step(carry)
        if k < 2:
            carry = carry_next
    cap["out"] = capture_out(out)
    ref = check.reference(config, tensors, cap)
    gaps = check.step_gaps(config, cell.mix, cap, ref, 5, 2)
    assert set(gaps) == set(config["limits"])
    for n, g in gaps.items():
        assert g.numel() == 0 or float(g.max()) < 1e-9, (n, g)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "traffic"])
def test_reference_and_traffic_import_nothing_of_the_port(folder):
    for path in sorted((BENCH / folder).glob("*.py")):
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top in {"__future__", "contextlib", "math", "json",
                           "pathlib", "typing", "dataclasses", "numpy",
                           "torch", "reference", "traffic"}, (path, mod)
