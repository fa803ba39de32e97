"""Compression configuration.

Behavioral reference (semantics only):
  - reference: GenerationBench/GenerationTest/GEARLM/Simulated/compress_config.py:1-181
    (CompressionConfig with per-layer broadcast via copy_for_all_attention and
    analytic compression-ratio calculators)
  - reference: cuda_supported_gear/test.py:30-37 (fused-path config dict:
    k_bits/v_bits/group_size/residual_length)

A frozen dataclass of scalar knobs plus an explicit ``per_layer`` broadcast
producing a list of LayerCompressionConfig, enabling heterogeneous per-layer
policies. This module is a copy of ``gear_tpu/config.py`` (a pure dataclass
module): the PyTorch port keeps its own so that it imports nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


METHODS = (
    "NONE",        # no compression
    "UNIFORM",     # plain group quant, K per-channel / V per-token (KIVI_V2)
    "KIVI_V2",     # alias of UNIFORM (reference name)
    "KCVT",        # K per-channel group=seq_len, V per-token group=h*d
    "GEAR",        # outliers + quant + low-rank error
    "GEAR-KCVT",
    "GEARL",       # quant + low-rank error (no outliers)
    "GEARL-KCVT",
    "OUTLIER",     # outliers + quant (no low-rank)
)


@dataclass(frozen=True)
class LayerCompressionConfig:
    """Per-layer compression policy (static knobs)."""

    compress_method: str = "GEAR"
    quantize_bit: int = 4
    group_size: int = 64
    # Low-rank error approximation.
    rank: int = 2           # decode/stream rank
    rankv: int = 2
    prefill_rank: int = 4   # rank used on the prefill block
    prefill_rankv: int = 4
    loop: int = 3           # power-iteration count
    # Sparse outliers: fraction of entries stored exactly (half min, half max).
    left: float = 0.02
    # Streaming / two-tier cache.
    streaming: bool = True
    streaming_gap: int = 64      # recompression period (simulated path)
    residual_length: int = 64    # fp16 residual ring length (fused path)
    stream_grouping: bool = False
    # Token preservation (skip compressing a prefix/suffix of the sequence).
    token_preserving: bool = False
    start_saving: float = 0.0
    locality_saving: float = 0.0
    # H2O eviction budgets (reference carries these knobs in its config —
    # compress_config.py h2o sizes — but its H2OCache class never existed;
    # gear_tpu/h2o.py implements it and engine mode="h2o" uses these).
    important_size: int = 64     # heavy-hitter slots
    recent_size: int = 192       # recent window (budget = important + recent)
    # StreamingLLM sink cache sizes (reference ships SinkCache unused,
    # cache_utils.py:201-363; engine mode="sink" uses these).
    sink_size: int = 4
    window_size: int = 252

    def rank_for(self, prefill: bool) -> tuple[int, int]:
        if prefill:
            return self.prefill_rank, self.prefill_rankv
        return self.rank, self.rankv


@dataclass(frozen=True)
class CompressionConfig(LayerCompressionConfig):
    """Model-wide config; broadcast to per-layer via :meth:`per_layer`.

    Scalar fields mirror LayerCompressionConfig; ``overrides`` maps layer
    index -> field dict for heterogeneous policies.
    """

    num_layers: int = 32
    overrides: tuple = field(default_factory=tuple)  # ((layer_idx, {field: val}), ...)

    def per_layer(self) -> list[LayerCompressionConfig]:
        base_fields = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(LayerCompressionConfig)
        }
        layers = [LayerCompressionConfig(**base_fields) for _ in range(self.num_layers)]
        for idx, over in self.overrides:
            layers[idx] = dataclasses.replace(layers[idx], **dict(over))
        return layers

    def layer(self, idx: int) -> LayerCompressionConfig:
        return self.per_layer()[idx]

    # -- analytic compression ratios ------------------------------------
    # reference: Simulated/compress_config.py:87-181 (compress_ratio); ratios
    # are fp16-baseline-bytes / compressed-bytes for one [b,h,s,d] KV tensor.

    def quant_ratio(self) -> float:
        """Pure group-quant ratio ignoring scale/zero sideband: 16 / bits."""
        return 16.0 / self.quantize_bit

    def ratio(self, seq_len: int, num_heads: int, head_dim: int, batch: int = 1) -> float:
        """Analytic ratio for the configured method on a [b,h,s,d] tensor.

        Accounts for packed codes, per-group scale+min sideband (fp16),
        rank-r P/Q bases (fp16), and outlier values+indices (fp16+int32-ish
        treated as 2 bytes index to match the reference's accounting).
        """
        b, h, s, d = batch, num_heads, seq_len, head_dim
        total = b * h * s * d  # elements
        baseline_bytes = total * 2.0
        bits = self.quantize_bit
        g = self.group_size
        method = self.compress_method

        code_bytes = total * bits / 8.0
        n_groups = total / max(g, 1)
        sideband_bytes = n_groups * 2 * 2.0  # scale + min, fp16
        comp = code_bytes + sideband_bytes

        if method in ("GEAR", "GEAR-KCVT", "OUTLIER"):
            n_outliers = int(total * self.left)
            comp += n_outliers * (2.0 + 2.0)  # value fp16 + index
        if method in ("GEAR", "GEAR-KCVT", "GEARL", "GEARL-KCVT"):
            r = self.prefill_rank
            comp += b * h * (s + d) * r * 2.0  # P + Q fp16
        if method == "NONE":
            return 1.0
        return baseline_bytes / comp

    def describe(self, seq_len: int = 4096, num_heads: int = 32, head_dim: int = 128) -> str:
        return (
            f"CompressionConfig(method={self.compress_method}, bits={self.quantize_bit}, "
            f"group={self.group_size}, rank={self.rank}/{self.prefill_rank}, "
            f"left={self.left}, gap={self.streaming_gap}) "
            f"analytic ratio @ s={seq_len}: {self.ratio(seq_len, num_heads, head_dim):.2f}x"
        )
