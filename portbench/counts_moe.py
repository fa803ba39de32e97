"""The operations and bytes of one rank's decode step of a mixture of experts
sharded over ``world`` ranks (tensor parallel heads and vocabulary, expert
parallel experts), against the card's peaks in ``counts``.

The rank's bytes are its weights read once: its query and kv heads' share
of the attention projections, the norms and the router whole, its
``num_local_experts / world`` experts (at the cell's batch every expert is
chosen by some row, so every one is read), its columns of the output head
and the embedding rows of the step's tokens; then its kv heads' attended
KV in the cell's format (``counts.attention_call``), and its share of the
logits out in float32. Its operations are the work the step needs: twice
each product's multiplies, the chosen ``num_experts_per_tok`` experts of
each token split evenly over the ranks, and its attention call. The bound
is the larger of operations over the bf16 peak and bytes over the
bandwidth; bytes bind at decode.
"""
from __future__ import annotations

from portbench import counts


def _dims(hf: dict):
    e = hf["hidden_size"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    return e, hf["intermediate_size"], hq, hkv, hf.get("head_dim") or e // hq


def rank_weight_bytes(hf: dict, world: int, rows: int,
                      elem: int = 2) -> float:
    """Bytes of the rank's weights a step of ``rows`` tokens reads once."""
    e, f, hq, hkv, d = _dims(hf)
    ne = hf["num_local_experts"]
    attn = (2 * e * hq * d + 2 * e * hkv * d) / world + 2 * e
    ffn = 3 * e * f * ne / world + e * ne
    n = hf["num_hidden_layers"] * (attn + ffn)
    n += e + e * hf["vocab_size"] / world + rows * e
    return n * elem


def rank_flops(hf: dict, world: int, rows: int) -> float:
    """Operations of the rank's weight products for ``rows`` tokens."""
    e, f, hq, hkv, d = _dims(hf)
    ne, k = hf["num_local_experts"], hf["num_experts_per_tok"]
    per_token = hf["num_hidden_layers"] * (
        (2 * e * hq * d + 2 * e * hkv * d) / world + 3 * e * f * k / world
        + e * ne) + e * hf["vocab_size"] / world
    return 2.0 * per_token * rows


def rank_step(hf: dict, fmt, state, pad_starts,
              world: int) -> tuple[float, float]:
    """(operations, bytes) of one rank's whole decode step."""
    _, _, hq, hkv, _ = _dims(hf)
    rows = len(pad_starts)
    a_flops, a_bytes = counts.attention_call(
        fmt, state, pad_starts, hq // world, hkv // world,
        hf.get("sliding_window"))
    layers = hf["num_hidden_layers"]
    flops = rank_flops(hf, world, rows) + layers * a_flops
    nbytes = (rank_weight_bytes(hf, world, rows) + layers * a_bytes
              + rows * hf["vocab_size"] / world * 4)
    return flops, nbytes
