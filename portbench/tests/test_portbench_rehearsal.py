"""Each cell's driver end to end on the CPU, at the tiny sizes its files
give under ``rehearsal``, through the port's plain paths; and the same run
with a fault planted under the timed path, which has to come out not
correct."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def names(group, cell):
    return {m["name"] for m in BENCH[group]
            if cell in m.get("workloads", [cell])}


def rehearse(cell, trace=0, fault=None, seed=7):
    # starting the profiler takes the CPU a second or two: a traced window
    # is long enough to hold its stretch
    seconds = "10" if trace else "0.3"
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     seconds, "--trace", str(trace), "--rehearse"],
                    fault=fault, check_modules=False)


@pytest.mark.parametrize("cell", CELLS)
def test_the_command_prints_the_result_line_last(cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000019", "--seconds", "0.3", "--trace", "0", "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    # a CPU run reports no device metric
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert set(line["rehearsal"]["metrics"]) == names("end_to_end", cell)
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_rehearsal_reads_its_per_layer_metrics(cell):
    res = rehearse(cell, trace=1)
    assert res.correct and res.attempted > 0
    got = set(res.extra["rehearsal"]["metrics"])
    # no device records on the CPU: only the step's share of the roofline
    assert got and got <= names("per_layer", cell)
    assert set(res.breakdown) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["frozen_step", "altered_token",
                                   "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_comes_out_not_correct(cell, fault):
    res = rehearse(cell, fault=fault)
    assert res.correct is False, res.checks


def test_no_cuda_device_means_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code == 3
