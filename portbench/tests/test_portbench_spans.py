"""The per-layer metrics that read the program's spans: each reader on a
hand-built span list, on a program that records none, and in a traced
rehearsal of each cell; and their entries in ``BENCHMARK.json``."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from gear_tpu_torch import profiling
from portbench import harness, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READERS = ["decode.host_ms", "llama.layer_self_us", "cache.append_host_us",
           "attn.host_us"]


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


def rec(name, t0, t1, parent=None, root=0, **attrs):
    return profiling.Span(name, t0, t1, parent, root, 1, attrs)


def step(recs, j, t0, mode, k=1):
    """A decode step of two layers at ``t0`` (ns): the step 1000 long, each
    layer 400 holding an append of 50 (the first with a flush of 30
    inside) and an attention call of 200; every time ``k`` times that."""
    append, attend = (("cache.append", "decode.attend_fused") if mode ==
                      "fused" else ("llama.raw_append",
                                    "flash.raw_attend_flash"))
    r = len(recs)
    recs.append(rec("engine.decode_step", t0, t0 + 1000 * k, step=j,
                    batch=2))
    for li in range(2):
        a = t0 + (100 + 450 * li) * k
        recs.append(rec("llama.layer", a, a + 400 * k, r, r, layer=li))
        lay = len(recs) - 1
        recs.append(rec(append, a + 10 * k, a + 60 * k, lay, r))
        if li == 0 and mode == "fused":
            recs.append(rec("cache.flush", a + 20 * k, a + 50 * k,
                            len(recs) - 1, r))
        recs.append(rec(attend, a + 100 * k, a + 300 * k, lay, r))


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_each_reader_on_a_hand_built_span_list(monkeypatch, mode):
    recs = []
    step(recs, 6, 0, mode, k=2)        # a pad step, not counted
    step(recs, 8, 20_000, mode, k=3)   # an earlier root of a counted tag
    for j, t in ((8, 40_000), (9, 60_000)):
        step(recs, j, t, mode)
    recs.append(rec("other", 70_000, 70_100, root=len(recs)))
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    ctx = {"steps": [8, 9]}
    got = {n: reader(n).read(ctx) for n in READERS}
    flush = 30 / 2 if mode == "fused" else 0   # one flush in two appends
    want = {"decode.host_ms": 1000 / 1e6,
            "llama.layer_self_us": (400 - 50 - 200) / 1e3,
            "cache.append_host_us": (50 - flush) / 1e3,
            "attn.host_us": 200 / 1e3}
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name).read({"steps": [8, 9]}) is None
    recs = []
    step(recs, 3, 0, "fused")
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    assert reader(name).read({"steps": [8, 9]}) is None   # other steps
    assert reader(name).read({"steps": []}) is None
    # a program without the recorder (the parent of the spans)
    monkeypatch.delattr(profiling, "roots")
    assert reader(name).read({"steps": [3]}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_rehearsal_reads_the_four_span_metrics(cell):
    profiling.clear_spans()
    res = run.main(["--workload", cell, "--seed", "3000000019", "--seconds",
                    "10", "--trace", "1", "--rehearse"], check_modules=False)
    assert res.correct
    got = res.extra["rehearsal"]["metrics"]
    for name in READERS:
        assert math.isfinite(got[name]) and got[name] > 0, name
    layers = harness.rehearsal(harness.find_cell(cell)).hf[
        "num_hidden_layers"]
    inside = layers * (got["llama.layer_self_us"] +
                       got["cache.append_host_us"] + got["attn.host_us"])
    assert inside / 1e3 <= got["decode.host_ms"]


def test_the_entries_of_the_span_metrics():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    layer = {"decode.host_ms": ("ms", "model step"),
             "llama.layer_self_us": ("us", "model step"),
             "cache.append_host_us": ("us", "cache"),
             "attn.host_us": ("us", "kernels")}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["layer"]) == layer[name]
        assert (m["source"], m["moves"], m["better"]) == \
            ("host_clock", "output_tok_s", "lower")
        assert m["workloads"] == CELLS
        assert (harness.BENCH_DIR / "metrics" / f"{name}.py").is_file()
    assert list(entries)[-4:] == READERS
