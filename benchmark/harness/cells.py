"""Cells, configurations, traffic mixes and per-layer metric readers,
found by name in the benchmark's folders."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parent.parent
CONFIGS = BENCH / "configs"
WORKLOADS = BENCH / "workloads"
METRICS = BENCH / "metrics"


class Cell(NamedTuple):
    name: str
    config: dict
    mix: dict
    chips: int
    why: str


def _read(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} file {path}")
    return json.loads(path.read_text())


def load_config(name: str) -> dict:
    return _read(CONFIGS / f"{name}.json", "configuration")


def load(name: str) -> Cell:
    """The cell ``workloads/<name>.json`` with its configuration and its
    traffic mix."""
    from traffic.generate import load_mix
    w = _read(WORKLOADS / f"{name}.json", "workload")
    return Cell(name, load_config(w["config"]), load_mix(w["traffic"]),
                int(w["chips"]), w["why"])


def metric_reader(name: str):
    """``read(record) -> float | None`` of the per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = METRICS / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark_json(root: Path | None = None) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return _read(Path(root or BENCH.parent) / "BENCHMARK.json", "benchmark")


def per_layer_for(cell: str, bench: dict) -> list[dict]:
    """The per-layer metrics that ``cell`` reports: those that list it, and
    those without a list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(cell, bench)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]


def end_to_end_for(cell: str, bench: dict) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]
