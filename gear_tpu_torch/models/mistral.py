"""Mistral support: an architecture delta of the functional Llama.

PyTorch port of ``gear_tpu/models/mistral.py``. ``models.llama`` implements
GQA and sliding-window prefill natively, so Mistral is a ModelConfig plus
the shared forward passes and caches.

Decode applies the sliding window as a mask over the cache
(``forward_decode`` hands ``cfg.sliding_window`` to ``attend_fused`` /
``raw_attend_flash``). The cache never evicts by window: the window is a
mask, bounded by ``max_len`` storage. The kernels fold the window into
their ``pad_start`` masking; over the compressed cache that needs
``window >= group`` (true of any real config: 4096 against 64).
"""
from __future__ import annotations

from .llama import ModelConfig, forward_decode, forward_prefill, init_params  # noqa: F401


def mistral_7b() -> ModelConfig:
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=10000.0, max_position_embeddings=32768,
        sliding_window=4096,
    )


def tiny(**kw) -> ModelConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                sliding_window=32, max_position_embeddings=512)
    base.update(kw)
    return ModelConfig(**base)
