"""gear_tpu_torch: the PyTorch/CUDA port of gear_tpu for NVIDIA Hopper.

The GEAR recipe (group-wise KV quantization, per-channel keys / per-token
values, sparse outliers, low-rank error bases) over a two-tier compressed
cache, for Llama and Mistral models, static batches (``InferenceEngine``) and
continuous batching over dense per-slot caches or a shared page pool
(``ServingEngine``, ``PagedServingEngine``), with hand-written CUDA kernels
for the prefill pack, the fused decode attention over the compressed cache
(dense and paged) and the flash decode over the raw bf16 cache. It imports
torch and numpy, never JAX and nothing of gear_tpu.
"""
from .config import CompressionConfig, LayerCompressionConfig  # noqa: F401


def __getattr__(name):
    # lazy top-level API, as in gear_tpu
    import importlib

    lazy = {
        "GearLM": ("gear_tpu_torch.api", "GearLM"),
        "InferenceEngine": ("gear_tpu_torch.engine", "InferenceEngine"),
        "EngineConfig": ("gear_tpu_torch.engine", "EngineConfig"),
        "CacheSpec": ("gear_tpu_torch.cache", "CacheSpec"),
        "LayerCache": ("gear_tpu_torch.cache", "LayerCache"),
        "ModelConfig": ("gear_tpu_torch.models.llama", "ModelConfig"),
        "ServingEngine": ("gear_tpu_torch.serving", "ServingEngine"),
        "PagedServingEngine": ("gear_tpu_torch.serving",
                               "PagedServingEngine"),
        "PagedSpec": ("gear_tpu_torch.paged", "PagedSpec"),
        "PageAllocator": ("gear_tpu_torch.paged", "PageAllocator"),
    }
    if name in lazy:
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'gear_tpu_torch' has no attribute {name!r}")
