"""The pieces of the sharded Mixtral cell that run without a card: its
configuration against the published one, a rank's share of the seeded
weights against the port's own sharding of the whole, the rank's step
counts, and the readers of its per-layer metrics on hand-built contexts."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from gear_tpu_torch.parallel import distributed, sharding
from portbench import counts, counts_moe, harness, weights_moe

ROOT = Path(__file__).resolve().parents[2]
CELL = "mixtral8x7b-gear2-tp4-8k"
PUBLISHED = {"hidden_size": 4096, "intermediate_size": 14336,
             "num_hidden_layers": 32, "num_attention_heads": 32,
             "num_key_value_heads": 8, "num_local_experts": 8,
             "num_experts_per_tok": 2, "vocab_size": 32000,
             "rope_theta": 1000000.0, "sliding_window": None,
             "rms_norm_eps": 1e-05, "max_position_embeddings": 32768,
             "torch_dtype": "bfloat16"}


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


def test_the_configuration_keeps_every_published_number():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["mixtral-8x7b"]
    assert entry["reduced"] == []
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert {k: cfg[k] for k in PUBLISHED} == PUBLISHED


def _mesh(rank, world):
    mesh = distributed.Mesh.__new__(distributed.Mesh)
    mesh.shape, mesh.coords = {"model": world}, {"model": rank}
    return mesh


@pytest.mark.parametrize("rank", [0, 3])
def test_a_rank_share_is_the_ports_slice_of_the_whole(rank):
    hf = harness.rehearsal(harness.find_cell(CELL)).hf
    cpu = torch.device("cpu")
    whole = weights_moe.rank_share(hf, 5, cpu, 0, 1)
    want = sharding.shard_params(_mesh(rank, 4), whole)
    got = weights_moe.rank_share(hf, 5, cpu, rank, 4)
    assert torch.equal(got["lm_head"], want["lm_head"])
    assert torch.equal(got["embed"], want["embed"])
    for k, v in want["layers"].items():
        assert torch.equal(got["layers"][k], v), k
    layer = weights_moe.layer(hf, 5, 1, cpu)
    for k, v in layer.items():
        assert torch.equal(v, whole["layers"][k][1]), k


def test_a_ranks_step_counts():
    hf = harness.find_cell(CELL).hf
    # one rank of one is the whole model, as counts.weight_bytes reads it
    assert counts_moe.rank_weight_bytes(hf, 1, 16) == pytest.approx(
        counts.weight_bytes(hf, None, 16), rel=1e-12)
    assert counts_moe.rank_weight_bytes(hf, 4, 16) == pytest.approx(
        23.29e9, rel=1e-3)
    fmt = counts.kv_format(harness.find_cell(CELL).traffic["compression"],
                           128)
    state = counts.decode_state(8192, 8192, 10, 64, False)
    flops, nbytes = counts_moe.rank_step(hf, fmt, state, [100] * 16, 4)
    assert counts.bound_s(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)   # bytes bind
    assert 7.0e-3 < nbytes / 3.35e12 < 7.6e-3


def test_the_readers_on_built_contexts():
    kinds = {"graph_kinds": [["replay"] * 16, ["replay"] * 15 + ["eager"]],
             "steps": list(range(8, 24))}
    assert reader("mixtral.graph_share").read(kinds) == 100.0 * 31 / 32
    assert reader("mixtral.graph_share").read(
        {**kinds, "graph_kinds": [None, ["replay"]]}) is None
    assert reader("comm.bytes_per_step").read(
        {"comm_bytes_per_step": 18825216.0}) == 18825216.0
    assert reader("comm.bytes_per_step").read({}) is None
    trace = {"window_s": 0.2, "busy_s": 0.15, "records": 100, "idle": {},
             "by_name": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": [64, 0.01],
                         "nccl:all_reduce": [64, 0.01],
                         "nvjet_tst": [10, 0.1]}}
    ctx = {"trace": trace, "steps": [8, 9]}
    assert reader("comm.allreduce_share").read(ctx) == pytest.approx(5.0)
    assert reader("device.idle_share.tp4").read(ctx) == pytest.approx(25.0)
    for name in ("comm.allreduce_share", "device.idle_share.tp4",
                 "mixtral.step_mfu"):
        assert reader(name).read({"trace": None, "steps": [8]}) is None
