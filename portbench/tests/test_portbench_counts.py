"""The frozen operation and byte counts against values worked out by hand at
Mistral-7B's and Mixtral-8x7B's shapes."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GEAR4 = {"compress_method": "GEAR", "quantize_bit": 4, "group_size": 64,
         "rank": 2, "prefill_rank": 4, "left": 0.02}


# Mixtral-8x7B's published config at 16 of its 32 layers (a card's half
# of two pipeline stages)
MIXTRAL_16 = {"hidden_size": 4096, "intermediate_size": 14336,
              "num_hidden_layers": 16, "num_attention_heads": 32,
              "num_key_value_heads": 8, "vocab_size": 32000,
              "num_local_experts": 8, "num_experts_per_tok": 2}


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_gear_format_at_mistral_shapes():
    fmt = counts.kv_format(GEAR4, 128)
    # int(0.02 * 64 * 128) = 163, rounded down to even
    assert fmt.outliers == 162 and fmt.v_group == 64
    # codes 2 * 128 * 4 / 8 = 128; K scale + min 2 * 128 * 2 / 64 = 8;
    # V scale + min 2 * 2 * 2 = 8; outliers 2 * 162 * 4 / 64 = 20.25;
    # Q rows 2 * 4 * 2 = 16 (prefill rank 4) or 8 (rank 2)
    assert fmt.packed_token(4) == pytest.approx(180.25)
    assert fmt.packed_token(2) == pytest.approx(172.25)
    assert fmt.raw_token == 512
    assert fmt.p_bytes(4) == 2048
    assert counts.kv_format({**GEAR4, "compress_method": "GEARL"},
                            128).outliers == 0
    assert counts.kv_format(None, 128).bits is None


def test_attended_tokens_take_the_window_and_the_padding():
    st = counts.decode_state(4352, 4352, 0, 64, raw=False)
    assert (st.comp_len, st.resid_len) == (4352, 1)
    # total 4353; the window starts at max(52, 4353 - 4096) = 257
    assert counts.attended(st, 52, 4096, raw=False) == (4095, 0, 1)
    # without a window, the padding alone
    assert counts.attended(st, 52, None, raw=False) == (4300, 0, 1)
    st = counts.decode_state(4352, 4352, 63, 64, raw=False)
    assert (st.comp_len, st.resid_len) == (4416, 0)
    # total 4416: the window would start at 320, the padding ends at 400
    assert counts.attended(st, 400, 4096, raw=False) == (3952, 64, 0)
    raw = counts.decode_state(0, 4352, 9, 64, raw=True)
    assert raw.resid_len == 4362
    assert counts.attended(raw, 52, 4096, raw=True) == (0, 0, 4096)


def test_one_attention_call_of_one_row():
    fmt = counts.kv_format(GEAR4, 128)
    st = counts.decode_state(4352, 4352, 0, 64, raw=False)
    flops, nbytes = counts.attention_call(fmt, st, [52], 32, 8, 4096)
    kv = 4095 * 180.25 + 1 * 512 + 2048
    assert nbytes == pytest.approx(8 * kv + 2 * 8 * 4 * 128 * 2)
    assert flops == pytest.approx(32 * 4096 * 4 * 128 + 32 * 4095 * 4 * 4)
    raw = counts.kv_format(None, 128)
    st = counts.decode_state(0, 4352, 0, 64, raw=True)
    _, nbytes = counts.attention_call(raw, st, [52], 32, 8, 4096)
    assert nbytes == 8 * 4096 * 512 + 2 * 8 * 4 * 128 * 2


def test_weight_bytes_and_model_flops_of_mistral():
    hf = cfg("mistral-7b")
    # a layer: q, o 4096 x 4096; k, v 4096 x 1024; 2 norms; 3 x 4096 x 14336
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 4096 + 3 * 4096 * 14336
    assert layer == 218_112_000
    params = 32 * layer + 4096 + 4096 * 32000 + 16 * 4096
    assert counts.weight_bytes(hf, rows=16) == 2 * params == 14_221_451_264
    per_token = 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024
                      + 3 * 4096 * 14336) + 4096 * 32000
    assert counts.model_flops(hf, 16) == 2 * per_token * 16


def test_weight_bytes_of_mixtral_count_the_experts_read():
    hf = MIXTRAL_16
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 4096
    layer = attn + 4 * 3 * 4096 * 14336 + 4096 * 8
    params = 16 * layer + 4096 + 4096 * 32000 + 2 * 4096
    assert counts.weight_bytes(hf, experts_read=4, rows=2) == 2 * params
    assert 2 * params == 24_154_234_880
    every = counts.weight_bytes(hf, rows=2)
    assert every == pytest.approx(2 * (params + 16 * 4 * 3 * 4096 * 14336))
    # each token multiplies its top 2 experts and the router
    per_token = 16 * (attn - 2 * 4096 + 2 * 3 * 4096 * 14336 + 4096 * 8) \
        + 4096 * 32000
    assert counts.model_flops(hf, 2) == 2 * per_token * 2


def test_the_bound_is_the_slower_of_operations_and_bytes():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
    # a decode step of Mistral binds on bytes
    hf = cfg("mistral-7b")
    fmt = counts.kv_format(GEAR4, 128)
    st = counts.decode_state(4352, 4352, 0, 64, raw=False)
    flops, nbytes = counts.decode_step(hf, fmt, st, [52] * 16)
    assert nbytes / 3.35e12 > flops / 989e12
