"""The control of each cell's check: the plain reference computed in
float8 weight products, put in the program's place, must come out not
correct. On the CPU at the rehearsal sizes; on the card at the cell's own
size (``pytest -m cuda portbench/tests`` on a machine with an H100)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import control

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def limits(cell, rehearse):
    tr = json.loads((ROOT / "portbench" / "workloads"
                     / f"{cell}.json").read_text())
    return (tr["rehearsal"] if rehearse else tr)["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes_at_rehearsal_size(cell):
    out = control.readings(cell, [1, 2], {1, 2}, 0.2, rehearse=True)
    for name, lim in limits(cell, True).items():
        assert out["lower"][name] <= lim, name
    # the control fails one of the cell's numbers
    assert any(out["upper"][name] > lim
               for name, lim in limits(cell, True).items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    out = control.readings(cell, [11, 12, 13], {11, 12, 13}, 1.0)
    for name, lim in limits(cell, False).items():
        assert out["lower"][name] <= lim, name
    assert any(out["upper"][name] > lim
               for name, lim in limits(cell, False).items())
