"""What every run shares: finding a cell's files by the names in
``BENCHMARK.json``, the card, the modules a run may not load, and the
result line.

A cell names a configuration (``configs`` gives its file) and a traffic mix,
``workloads/<traffic>.json``; the mix names its driver,
``drivers/<driver>.py``; the configuration's ``model_type`` names the
program's entries, ``families/<model_type>.py``; a per-layer metric is
``metrics/<name>.py``. Each is loaded from its file by that name, so a new
cell, mix or metric is new files and new entries, not an edit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gear_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    hf: dict              # the configuration as run
    traffic: dict         # the traffic mix
    end_to_end: list      # the cell's end-to-end metrics (BENCHMARK.json)
    per_layer: list       # its per-layer metrics


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(workloads: {sorted(cells)})")
    w = cells[name]
    files = {c["name"]: ROOT / c["file"] for c in bench["configs"]}
    hf = load_json(files[w["config"]])
    traffic = load_json(BENCH_DIR / "workloads" / f"{w['traffic']}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    # an end-to-end metric without a workloads list is every cell's; a
    # per-layer one without it is every cell's that reports what it moves
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in names]
    return Cell(name=name, chips=w["chips"], hf=hf, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def rehearsal(cell: Cell) -> Cell:
    """The cell at the tiny sizes its files give under ``rehearsal`` (CPU
    runs of the tests; never a device metric)."""
    hf = {**cell.hf, **cell.hf.get("rehearsal", {})}
    tr = {**cell.traffic, **cell.traffic.get("rehearsal", {})}
    return Cell(cell.name, cell.chips, hf, tr, cell.end_to_end,
                cell.per_layer)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card: {out}"


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one a run may not load."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict            # name -> (value, unit)
    device: dict
    checks: list             # (name, value, limit)
    breakdown: dict | None = None
    extra: dict = field(default_factory=dict)

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed,
               "metrics": {k: {"value": v, "unit": u}
                           for k, (v, u) in self.metrics.items()},
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out.update(self.extra)
        out["check"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in self.checks}
        return json.dumps(out)

    def check_lines(self) -> list[str]:
        return [f"check {n} {v!r} limit {lim!r}" for n, v, lim in self.checks]


def finite(x: float) -> bool:
    return x is not None and math.isfinite(x)
