"""The plain reference against the port at tiny sizes on the CPU: GEAR's
compression block for block, and whole teacher-forced passes in float32,
where the two agree to rounding (in bf16 the port departs by rounding, and
the benchmark's limits hold that departure)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from gear_tpu_torch import cache as C
from gear_tpu_torch.models import llama
from portbench import counts, harness, inits, traffic, weights
from portbench.reference import decoder, gear

family = harness.load_module(harness.BENCH_DIR / "families" / "mistral.py",
                             "portbench_family_mistral")


@pytest.mark.parametrize("bits,d", [(4, 16), (2, 16), (4, 128), (2, 128)])
def test_compression_equals_the_ports_cache(bits, d):
    torch.manual_seed(bits * d)
    s = 192
    k = torch.randn(2, 2, s, d).bfloat16().float()
    v = torch.randn(2, 2, s, d).bfloat16().float()
    comp = {"compress_method": "GEAR", "quantize_bit": bits,
            "group_size": 64, "rank": 2, "prefill_rank": 4, "left": 0.02}
    fmt = counts.kv_format(comp, d)
    spec = C.CacheSpec(batch=2, num_kv_heads=2, head_dim=d, max_len=320,
                       bits=bits, group=64, rank=2, prefill_rank=4,
                       outliers_per_block=fmt.outliers)
    p0 = {w: torch.rand(2, 2, d, 4) for w in "kv"}
    c = C.prefill(spec, k, v, p0=lambda w, shape: p0[w])
    kd, vd = C.dequantize_kv(spec, c)
    assert torch.equal(kd[:, :, :s], gear.compress(k, "k", fmt, 4, 3, p0["k"]))
    assert torch.equal(vd[:, :, :s], gear.compress(v, "v", fmt, 4, 3, p0["v"]))
    for t in range(64):   # the residual tier fills and flushes at rank 2
        C.append(spec, c, k[:, :, t:t + 1], v[:, :, t:t + 1],
                 p0=lambda w, shape: p0[w][..., :2])
    kd, vd = C.dequantize_kv(spec, c)
    blk = slice(s, s + 64)
    assert torch.equal(kd[:, :, blk], gear.compress(
        k[:, :, :64], "k", fmt, 2, 3, p0["k"][..., :2]))
    assert torch.equal(vd[:, :, blk], gear.compress(
        v[:, :, :64], "v", fmt, 2, 3, p0["v"][..., :2]))


def _port_decode(cell_name, mode, steps=70, seed=5, convert_rope=True):
    """The port's own passes in float32 over a rehearsal cell's shapes:
    prompt, then ``steps`` greedy steps; the reference's logits over the
    served tokens; -> (served [2, steps + 1], reference logits). The port
    gets the configuration as the benchmark hands it on (its RoPE
    parameter converted), or, with ``convert_rope`` False, the published
    ``rope_theta`` as it stands."""
    cell = harness.rehearsal(harness.find_cell(cell_name))
    hf = {**cell.hf, "torch_dtype": "float32"}
    tr = cell.traffic
    dev = torch.device("cpu")
    p = weights.make(hf, seed, dev)
    r = traffic.rng(seed, "prompts")
    lens = traffic.even_lengths(*tr["prompt_len"], 2, r)
    t, m = traffic.left_pad(traffic.prompts(lens, hf["vocab_size"], r),
                            tr["bucket"])
    t, m = torch.from_numpy(t), torch.from_numpy(m)
    cfg = family.model_config(hf)
    if not convert_rope:
        cfg = dataclasses.replace(cfg, rope_theta=hf["rope_theta"])
    comp = tr.get("compression") or {}
    from gear_tpu_torch.config import CompressionConfig
    spec = cfg.cache_spec(2, tr["max_len"],
                          CompressionConfig(num_layers=cfg.num_layers,
                                            **comp).layer(0))
    starts = inits.Inits(seed, dev)
    pos = torch.clamp(torch.cumsum(m, 1) - 1, min=0)
    lg, caches = llama.forward_prefill(p, cfg, t, pos, m, spec,
                                       compress=mode == "gear", init=starts)
    cur, served = lg[:, -1].argmax(-1), []
    served.append(cur)
    plen = m.sum(1).int()
    for j in range(steps):
        out, caches = llama.forward_decode(
            p, cfg, cur, plen + j, caches, spec=spec,
            compress=mode == "gear", pad_start=(t.shape[1] - plen).int(),
            init=starts, step=j)
        cur = out.argmax(-1)
        served.append(cur)
    served = torch.stack(served, 1)
    fmt = counts.kv_format(comp if mode == "gear" else None,
                           cfg.head_dim)
    ref = decoder.forward(
        p, hf, torch.cat([t, served[:, :steps]], 1), m, mode, fmt=fmt,
        inits=starts.for_rows(torch.arange(2), 2, cfg.num_kv_heads,
                              cfg.head_dim, fmt))
    return served, ref


def _widest_gap(served, ref):
    best = ref.max(dim=-1).values
    return float((best - ref.gather(-1, served[..., None])[..., 0]).max())


@pytest.mark.parametrize("cell,mode", [
    ("mistral7b-raw-decode-4k", "raw"),
    ("mistral7b-gear4-decode-4k", "gear"),
])
def test_teacher_forced_reference_agrees_with_the_port_in_float32(cell, mode):
    # the port's tokens are the reference's best at every position
    assert _widest_gap(*_port_decode(cell, mode)) <= 1e-4


@pytest.mark.parametrize("cell,mode", [
    ("mistral7b-raw-decode-4k", "raw"),
    ("mistral7b-gear4-decode-4k", "gear"),
])
def test_the_check_sees_the_ports_rope_at_the_published_theta(cell, mode):
    # handed the published rope_theta as it stands, the port rotates at
    # theta ** (-4i / D) and serves tokens the published model ranks far
    # below its best
    assert _widest_gap(*_port_decode(cell, mode, convert_rope=False)) > 0.5


def test_the_ports_rope_parameter_gives_the_published_frequencies():
    for theta, d in [(10000.0, 128), (1e6, 128), (10000.0, 16)]:
        got = family.port_rope_theta(theta, d)
        pos = torch.arange(4608)[None]
        cos, sin = llama.rope_cos_sin(pos, d, got)
        ang = pos[0, :, None].float() * decoder.rope_inv_freq(theta, d)
        assert torch.allclose(cos[0, :, :d // 2], torch.cos(ang), atol=1e-3)
        assert torch.allclose(sin[0, :, d // 2:], torch.sin(ang), atol=1e-3)
