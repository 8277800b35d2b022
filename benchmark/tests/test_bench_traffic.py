"""The traffic repeats bit for bit for one seed; every seed gives the same
set of instances, in another order where the mix's ``order`` is
``"seed"`` and in the same where it is ``"fixed"``; and it is the port's
own randomized batch for the mix's instance seed."""
import pytest
import torch

from harness import cells
from traffic.generate import generate

CELLS = ["circle8.sweep", "parallel11ss.sweep", "parallel11ss.tick"]
SEED = 2 ** 31 + 977        # seeds run past 32 signed bits


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs_other_seed_other_inputs(name):
    cell = cells.load(name)
    a = generate(cell.config, cell.mix, SEED, "cpu", batch=16)
    b = generate(cell.config, cell.mix, SEED, "cpu", batch=16)
    c = generate(cell.config, cell.mix, SEED + 1, "cpu", batch=16)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the same instances: every seed gives the same work
    key = lambda x0: sorted(x0.flatten(1).tolist())
    assert key(a["x0"]) == key(c["x0"])
    assert torch.equal(a["x0"], c["x0"]) == (cell.mix["order"] == "fixed")


@pytest.mark.parametrize("name", CELLS)
def test_generated_batch_is_the_ports_make_batch(name):
    from scp_tpu_torch.scenarios import batch as port_batch
    cell = cells.load(name)
    mine = generate(cell.config, cell.mix, SEED, "cpu", batch=8)
    order = (torch.arange(8) if cell.mix["order"] == "fixed" else
             torch.randperm(8, generator=torch.Generator().manual_seed(SEED)))
    gen = torch.Generator(device="cpu").manual_seed(cell.mix["instances_seed"])
    _, data = port_batch.make_batch(
        cell.config["scenario"], 8, generator=gen, dtype=torch.float32,
        device="cpu", **cell.config["scenario_args"])
    theirs = {"x0": data.x0, "u0": data.u0, "ref_points": data.ref_points,
              "ref_valid": data.ref_valid, "obstacles": data.obstacles,
              "dsafe_veh": data.dsafe_veh, "dsafe_obst": data.dsafe_obst,
              **{k: getattr(data.params, k) for k in
                 ("lf", "lr", "length", "width", "q", "q_final", "r")}}
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k][order]), k
