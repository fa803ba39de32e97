"""Every file of the benchmark loads, follows the contract's form, and names
only files that exist."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
# widths a configuration's ``reduced`` may never name
WIDTHS = re.compile(r"(hidden_size|intermediate|latent|state|proj|head_dim|"
                    r"_dim$|_rank$|expansion|experts_per_tok)")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_the_contract_keys():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["command"][:2] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_json_of_the_benchmark_loads():
    files = sorted(BENCH.rglob("*.json"))
    assert files
    for f in files:
        json.loads(f.read_text())


def test_names_units_and_entry_keys():
    b = bench()
    entries = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"}}
    for group, keys in entries.items():
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_configs_name_existing_files_and_cut_no_width():
    for c in bench()["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        cfg = json.loads(path.read_text())
        assert (BENCH / "families" / f"{cfg['model_type']}.py").is_file()
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_names_existing_files_and_reports_enough(cell):
    b = bench()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    assert w["config"] in {c["name"] for c in b["configs"]}
    assert w["chips"] in (1, 4)
    traffic = json.loads(
        (BENCH / "workloads" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()

    def mine(m):
        return cell in m.get("workloads", [cell])

    e2e = {m["name"] for m in b["end_to_end"] if mine(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = [m for m in b["per_layer"] if mine(m)]
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_configurations_keep_the_published_numbers():
    """Only the keys ``reduced`` lists differ from the published config."""
    published = {
        "mistral-7b": {"hidden_size": 4096, "intermediate_size": 14336,
                       "num_hidden_layers": 32, "num_attention_heads": 32,
                       "num_key_value_heads": 8, "vocab_size": 32000,
                       "rope_theta": 10000.0, "sliding_window": 4096,
                       "rms_norm_eps": 1e-05,
                       "max_position_embeddings": 32768},
    }
    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key, val in published[c["name"]].items():
            assert (cfg[key] != val) == (key in c["reduced"]), key
