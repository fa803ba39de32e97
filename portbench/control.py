"""Readings that set a cell's correctness limit, on the card.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 1]

In one process, for each seed, the cell runs as a run does (weights,
inputs, set-up, a window of ``--seconds``, the requests in progress
finished, the reference's check) and prints each number the cell's
``limits`` name as the program's served tokens read it (the lower readings
of the limits come from these). For the control seeds it also puts the
control in the program's place: the reference computed with float8 (e4m3)
weight products, whose first-ranked token's gap below the float32
reference's best is read at each position, and the same numbers taken
over those gaps (the upper readings). The last line is a JSON summary. Not
part of the benchmark's runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, run  # noqa: E402


def readings(workload: str, seeds, control_seeds, seconds: float,
             rehearse: bool = False, fault=None) -> dict:
    import torch

    cell = harness.find_cell(workload)
    if rehearse:
        cell = harness.rehearsal(cell)
        device = torch.device("cpu")
        torch.set_num_threads(run.REHEARSAL_THREADS)
    else:
        device = torch.device("cuda", 0)
    tr = cell.traffic
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / f"{tr['driver']}.py",
        f"portbench_driver_{tr['driver']}")
    family = harness.load_module(
        harness.BENCH_DIR / "families" / f"{cell.hf['model_type']}.py",
        f"portbench_family_{cell.hf['model_type']}")
    out = {"workload": workload, "program": {}, "control": {}, "spread": {}}
    for seed in seeds:
        args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
        ctx = run.Ctx(cell, args, device, family, fault)
        ctx.t_start = time.time()
        ctx.control = seed in control_seeds
        res = driver.run(ctx)
        out["program"][seed] = {n: v for n, v, _ in res["checks"]}
        line = f"seed {seed} program " + " ".join(
            f"{n} {v!r} (limit {lim!r})" for n, v, lim in res["checks"])
        out["spread"][seed] = {"program": res["extra"]["gaps"]}
        if ctx.control:
            out["control"][seed] = res["extra"]["control_numbers"]
            out["spread"][seed]["control"] = res["extra"]["control_gaps"]
            line += f" control {out['control'][seed]!r}"
        print(line, flush=True)
        del res, ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    names = next(iter(out["program"].values()))
    out["lower"] = {n: max(r[n] for r in out["program"].values())
                    for n in names}
    if out["control"]:
        out["upper"] = {n: min(r[n] for r in out["control"].values())
                        for n in names}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--rehearse", action="store_true")
    a = ap.parse_args(argv)
    seeds = [int(x) for x in a.seeds.split(",")]
    ctrl = {int(x) for x in a.control_seeds.split(",") if x}
    run._fixed_caches()
    if not a.rehearse:
        print(harness.card_line(), flush=True)
    seeds += sorted(ctrl - set(seeds))
    print(json.dumps(readings(a.workload, seeds, ctrl, a.seconds,
                              a.rehearse)), flush=True)


if __name__ == "__main__":
    main()
