"""The operations and bytes that decode work needs, and the card's peaks.

This is the benchmark's yardstick: the rooflines of the per-layer metrics
are computed here and nowhere in the program. It is a frozen copy of the
roofline arithmetic in ``gear_tpu_torch/profiling.py``, with three of its
faults corrected:

  * a call is charged the tokens it attends: past the row's left padding
    and inside the sliding window, not the cache's capacity ``max_len``;
  * the window is applied;
  * the compressed format's bytes are worked out from the compression
    settings (:class:`KVFormat`), not read from the program's own
    ``CacheSpec.bytes_compressed()``.

Bytes are what the inputs need, each read once: codes, their scales and
minima, the outlier entries (value and index), the low-rank bases and the
residual tier, in the layout's element sizes but without its padding (the
outlier store rounded up to 256 entries, its boundary tables). Operations
are counted against the bf16 tensor-core peak, the fastest rate any
implementation of the work could use, so a kernel rewritten onto other
units reads the same work and can never read above 100%. The bound of a
piece of work is the larger of operations / peak and bytes / bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass

# Data-sheet peaks, dense (no sparsity), at the full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def peak(kind: str | None) -> dict:
    """The peaks of the card named ``kind`` (the H100 SXM's if unknown)."""
    return PEAKS.get(kind or "", DEFAULT_PEAK)


def bound_s(flops: float, nbytes: float, kind: str | None = None) -> float:
    """Least seconds for ``flops`` operations that move ``nbytes``."""
    p = peak(kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes_s"])


@dataclass(frozen=True)
class KVFormat:
    """One kv head's cache format. ``bits`` None: the raw cache in the model
    dtype. Otherwise GEAR's two tiers: codes of ``bits`` bits (K per channel
    over ``group``-token blocks, V per token over ``v_group`` channels),
    scale and minimum per group, ``outliers`` exact entries per block and
    tensor, low-rank error bases of rank ``prefill_rank`` over the prompt
    and ``rank`` over each flushed block, and up to ``group`` raw tokens."""

    head_dim: int
    bits: int | None = None
    group: int = 64
    v_group: int = 64
    rank: int = 2
    prefill_rank: int = 4
    outliers: int = 0
    elem: int = 2    # bytes of the model dtype (raw K/V, sidebands, bases)
    index: int = 2   # bytes of one outlier index

    @property
    def raw_token(self) -> float:
        """Bytes of one raw token, K and V."""
        return 2 * self.head_dim * self.elem

    def packed_token(self, rank: int) -> float:
        """Bytes of one compressed token, K and V, with its share of the
        per-block sidebands, outliers and (rank > 0) Q rows of the bases;
        the P side of the bases is counted apart."""
        d, g = self.head_dim, self.group
        b = 2 * d * self.bits / 8                         # codes
        b += 2 * d * self.elem / g                        # K scale + min
        b += 2 * (d // self.v_group) * self.elem          # V scale + min
        b += 2 * self.outliers * (self.elem + self.index) / g
        b += 2 * rank * self.elem                         # Q rows, K and V
        return b

    def p_bytes(self, rank: int) -> float:
        """Bytes of one P side of the bases, K and V."""
        return 2 * rank * self.head_dim * self.elem


def kv_format(comp: dict | None, head_dim: int) -> KVFormat:
    """The format of a cell's ``compression`` settings (None: raw).
    Outliers as the GEAR methods keep them: ``int(left * group * D)``
    rounded down to even; GEARL and the plain methods keep none."""
    if comp is None:
        return KVFormat(head_dim=head_dim)
    method = comp.get("compress_method", "GEAR")
    g = comp.get("group_size", 64)
    ko = 0
    if method.startswith("GEAR") and not method.startswith("GEARL"):
        ko = int(comp.get("left", 0.02) * g * head_dim)
        ko -= ko % 2
    return KVFormat(head_dim=head_dim, bits=comp.get("quantize_bit", 4),
                    group=g, v_group=min(g, head_dim),
                    rank=comp.get("rank", 2),
                    prefill_rank=comp.get("prefill_rank", 4), outliers=ko)


@dataclass(frozen=True)
class CacheState:
    """The lengths of one layer's cache at a decode call, after the step's
    append (and flush): slots in the left-padded bucket's index space."""

    prefill_len: int   # tokens compressed by the prompt pass
    comp_len: int      # tokens compressed so far (prompt and flushes)
    resid_len: int     # raw tokens after them


def attended(state: CacheState, pad_start: int, window: int | None,
             raw: bool) -> tuple[int, int, int]:
    """(prompt-compressed, flushed, raw) tokens one row attends: from
    ``max(pad_start, total - window)`` to the newest. For the raw cache all
    attended tokens count as raw."""
    total = state.comp_len + state.resid_len
    lo = pad_start if window is None else max(pad_start, total - window)
    if raw:
        return 0, 0, max(0, total - lo)
    n_pre = max(0, state.prefill_len - lo)
    n_fl = max(0, state.comp_len - max(lo, state.prefill_len))
    n_raw = min(state.resid_len, max(0, total - lo))
    return n_pre, n_fl, n_raw


def attention_call(fmt: KVFormat, state: CacheState, pad_starts,
                   num_heads: int, num_kv_heads: int,
                   window: int | None) -> tuple[float, float]:
    """(operations, bytes) of one decode-attention call of one layer over
    the rows whose left padding ends at ``pad_starts``: QK and PV (and the
    low-rank terms) of every query head over the tokens each row attends;
    those tokens' K/V in ``fmt``, q in and the output out in the model
    dtype."""
    d, gq = fmt.head_dim, num_heads // num_kv_heads
    raw = fmt.bits is None
    flops = nbytes = 0.0
    for ps in pad_starts:
        n_pre, n_fl, n_raw = attended(state, ps, window, raw)
        n = n_pre + n_fl + n_raw
        flops += num_heads * n * 4 * d
        if raw:
            nbytes += num_kv_heads * n * fmt.raw_token
        else:
            flops += num_heads * (n_pre * fmt.prefill_rank
                                  + n_fl * fmt.rank) * 4
            kv = (n_pre * fmt.packed_token(fmt.prefill_rank)
                  + n_fl * fmt.packed_token(fmt.rank)
                  + n_raw * fmt.raw_token
                  + n_fl * fmt.p_bytes(fmt.rank) / fmt.group)
            if n_pre:
                kv += fmt.p_bytes(fmt.prefill_rank)
            nbytes += num_kv_heads * kv
        nbytes += 2 * num_kv_heads * gq * d * fmt.elem   # q in, out
    return flops, nbytes


def decode_state(prefill_len: int, bucket: int, step: int, group: int,
                 raw: bool) -> CacheState:
    """The cache after decode step ``step`` (0-based) of a replay that
    starts from a prompt pass over ``bucket`` slots, ``prefill_len`` of
    them compressed (the rest raw): every ``group`` raw tokens flush."""
    total = bucket + step + 1
    if raw:
        return CacheState(prefill_len=0, comp_len=0, resid_len=total)
    raw_n = total - prefill_len
    flushed = (raw_n // group) * group
    return CacheState(prefill_len=prefill_len,
                      comp_len=prefill_len + flushed,
                      resid_len=raw_n - flushed)


def weight_bytes(hf: dict, experts_read: float | None = None,
                 rows: int = 1, elem: int = 2) -> float:
    """Bytes of the weights a decode step of ``rows`` tokens reads once:
    every layer's attention projections, norms and feed-forward block (of a
    mixture, the router and ``experts_read`` experts), the final norm, the
    output head, and the embedding rows of the step's tokens."""
    e, f = hf["hidden_size"], hf["intermediate_size"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    d = hf.get("head_dim") or e // hq
    attn = e * hq * d * 2 + e * hkv * d * 2 + 2 * e
    ne = hf.get("num_local_experts")
    if ne:
        ffn = 3 * e * f * (ne if experts_read is None else experts_read)
        ffn += e * ne
    else:
        ffn = 3 * e * f
    n = hf["num_hidden_layers"] * (attn + ffn)
    n += e + e * hf["vocab_size"] + rows * e
    return n * elem


def model_flops(hf: dict, rows: int) -> float:
    """Operations of the weight products of ``rows`` tokens: twice the
    weights each token multiplies (a mixture's ``num_experts_per_tok``
    experts and its router)."""
    e, f = hf["hidden_size"], hf["intermediate_size"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    d = hf.get("head_dim") or e // hq
    attn = e * hq * d * 2 + e * hkv * d * 2
    ne = hf.get("num_local_experts")
    ffn = 3 * e * f * (hf.get("num_experts_per_tok", 2) if ne else 1)
    if ne:
        ffn += e * ne
    per_token = hf["num_hidden_layers"] * (attn + ffn) + e * hf["vocab_size"]
    return 2.0 * per_token * rows


def decode_step(hf: dict, fmt: KVFormat, state: CacheState, pad_starts,
                experts_read: float | None = None) -> tuple[float, float]:
    """(operations, bytes) of one whole decode step: the weight products
    and every layer's attention call; bytes of the weights read once (a
    mixture's selected experts only), every layer's attended KV in the
    cell's format, q and the logits (float32)."""
    rows = len(pad_starts)
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    a_flops, a_bytes = attention_call(fmt, state, pad_starts, hq, hkv,
                                      hf.get("sliding_window"))
    layers = hf["num_hidden_layers"]
    flops = model_flops(hf, rows) + layers * a_flops
    nbytes = (weight_bytes(hf, experts_read, rows) + layers * a_bytes
              + rows * hf["vocab_size"] * 4)
    return flops, nbytes
