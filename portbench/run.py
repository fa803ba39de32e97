"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

One process: make the weights and inputs from the seed, load and warm up
the cell's shapes (set-up), measure for ``--seconds``, check what the timed
path produced against the plain reference, and print one JSON line last on
standard output (``--trace 0``: the cell's end-to-end metrics; ``--trace
1``: its per-layer metrics, read from a profiled stretch of the window).
The numbers compared, each beside its limit, come last on standard error
and under ``check`` last in the line. Without a CUDA device (or with fewer
than the cell asks for) it exits with code 3 and prints no result; if JAX,
Flax or the JAX package is loaded once the window has closed, with code 4.

``--rehearse`` runs the cell at the tiny sizes its files give under
``rehearsal`` on the CPU, through the port's plain paths: a check of the
harness's control flow, whose numbers are reported apart, never under a
metric's name.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def _fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


REHEARSAL_THREADS = 2  # a CPU rehearsal shares its machine with others


class Ctx:
    """What a driver gets: the cell, the run's arguments, the device."""

    def __init__(self, cell, args, device, family, fault=None):
        self.cell = cell
        self.hf = cell.hf
        self.traffic = cell.traffic
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.family = family
        self.fault = fault
        self.t_start = T_START

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def main(argv=None, *, fault=None,
         check_modules: bool = True) -> harness.Result | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    _fixed_caches()
    cell = harness.find_cell(args.workload)
    import torch

    if args.rehearse:
        cell = harness.rehearsal(cell)
        device = torch.device("cpu")
        torch.set_num_threads(REHEARSAL_THREADS)
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), found {n}; no result", file=sys.stderr)
            raise SystemExit(3)
        print(harness.card_line(), flush=True)
        device = torch.device("cuda", 0)
    tr = cell.traffic
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / f"{tr['driver']}.py",
        f"portbench_driver_{tr['driver']}")
    family = harness.load_module(
        harness.BENCH_DIR / "families" / f"{cell.hf['model_type']}.py",
        f"portbench_family_{cell.hf['model_type']}")
    ctx = Ctx(cell, args, device, family, fault)
    out = driver.run(ctx)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            reader = harness.load_module(
                harness.BENCH_DIR / "metrics" / f"{m['name']}.py",
                "portbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(out["ctx"])
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = (out["e2e"][m["name"]], m["unit"])

    bad = harness.forbidden_loaded() if check_modules else []
    if bad:
        print(f"portbench: loaded {bad} (JAX or the JAX package); "
              "no result", file=sys.stderr)
        raise SystemExit(4)

    checks = out["checks"]
    correct = all(harness.finite(v) and v <= lim for _, v, lim in checks)
    if args.rehearse:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 0,
                      "memory_peak_bytes": 0}
        extra = {"rehearsal": {"metrics": {k: v for k, (v, _) in
                                           metrics.items()},
                               **out.get("extra", {})}}
        metrics = {}
    else:
        device_rec = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": cell.chips,
                      "memory_peak_bytes": out["memory_peak_bytes"]}
        extra = out.get("extra", {})
    summary = out.get("trace")
    breakdown = None
    if args.trace and summary is not None:
        from portbench import trace as tracing
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
        breakdown = tracing.breakdown(summary)
    res = harness.Result(correct=correct, attempted=out["attempted"],
                         failed=out["failed"], metrics=metrics,
                         device=device_rec, checks=checks,
                         breakdown=breakdown, extra=extra)
    return res


if __name__ == "__main__":
    result = main()
    for line in result.check_lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(result.line(), flush=True)
