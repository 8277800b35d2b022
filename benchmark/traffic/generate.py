"""The one general generator: a traffic mix's parameters and a
configuration give a batch of scenario instances from a seed."""
from __future__ import annotations

import json
from pathlib import Path

import torch

from traffic import builders, randomize

HERE = Path(__file__).resolve().parent
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_mix(name: str) -> dict:
    """The traffic mix ``<name>.json`` beside this file."""
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer: taken
    modulo 2**63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def generate(config: dict, mix: dict, seed: int, device,
             batch: int | None = None) -> dict:
    """``batch`` (default: the mix's) randomized instances of the
    configuration's scenario, in the configuration's dtype, on ``device``:
    one set of instances, drawn from the mix's ``instances_seed``, so that
    every seed gives the cell the same work (the IPM's per-instance
    freezing makes a step's time depend on which instances it holds). The
    mix's ``order`` is ``"seed"`` (an order drawn from ``seed``) or
    ``"fixed"`` (the order drawn, where the order changes the work: the
    SCP's straggler phases give their slots to the first unconverged
    instances in batch order); the seed also draws the instances that the
    output check samples. The same seed on the same device gives the same
    tensors."""
    dtype = DTYPES[config["dtype"]]
    nominal = builders.BUILDERS[config["scenario"]](
        config["settings"]["dt"], dtype, device, **config["scenario_args"])
    rand = mix["randomizer"]
    n = batch or mix["batch"]
    batch = randomize.RANDOMIZERS[rand["kind"]](
        generator(mix["instances_seed"], device), nominal, n,
        **rand["jitter"])
    if mix["order"] == "fixed":
        return batch
    order = torch.randperm(n, generator=generator(seed, device),
                           device=device)
    return {k: v.index_select(0, order) for k, v in batch.items()}
