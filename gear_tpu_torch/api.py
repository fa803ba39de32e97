"""Top-level API: load a HF checkpoint, generate with compression.

PyTorch port of ``gear_tpu/api.py``::

    from gear_tpu_torch import GearLM, CompressionConfig

    lm = GearLM.from_pretrained(
        "/path/to/llama-checkpoint",
        CompressionConfig(compress_method="GEAR", quantize_bit=4, rank=2,
                          prefill_rank=4, num_layers=32),
        max_len=4096, batch_size=8)            # runs on the CUDA device
    out_ids = lm.generate(prompt_ids, max_new_tokens=256)

Sharded over the ranks of a ``torch.distributed`` process group (one card
each under ``torchrun --nproc-per-node N`` with ``nccl``)::

    from gear_tpu_torch.parallel import distributed, sharding

    distributed.initialize_from_env("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    lm = GearLM.from_pretrained(...).shard(sharding.make_mesh(model=N))
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

from .config import CompressionConfig
from .engine import EngineConfig, InferenceEngine
from .models import llama, loader


@dataclass
class GearLM:
    """Weights + engine behind an HF-style generate API. ``device`` defaults
    to ``cuda`` and raises without a CUDA device."""

    cfg: llama.ModelConfig
    params: dict
    comp: CompressionConfig
    engine_cfg: EngineConfig = field(default_factory=EngineConfig)
    batch_size: int = 1
    device: object = None
    _engine: InferenceEngine | None = None

    @classmethod
    def from_pretrained(cls, model_dir: str,
                        compression_config: CompressionConfig | None = None,
                        *, max_len: int = 2048, batch_size: int = 1,
                        mode: str | None = None,
                        eos_token_id: int | None = None,
                        pad_token_id: int = 0, temperature: float = 0.0,
                        dtype=None, device=None) -> "GearLM":
        """Load a local HF Llama-family checkpoint (safetensors or torch
        .bin, models/loader.py) onto ``device`` and build the engine.

        ``mode`` defaults to ``fused`` (true compression) unless the method
        is ``NONE``, which runs ``raw``.
        """
        cfg = loader.load_config(model_dir)
        if dtype is not None:
            cfg = replace(cfg, dtype=dtype)
        cfg, params = loader.load_params(model_dir, cfg, dtype=cfg.dtype,
                                         device=device)
        comp = compression_config or CompressionConfig(
            num_layers=cfg.num_layers)
        if mode is None:
            mode = "fused" if comp.compress_method != "NONE" else "raw"
        ecfg = EngineConfig(max_len=max_len, mode=mode,
                            eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id, temperature=temperature)
        return cls(cfg=cfg, params=params, comp=comp, engine_cfg=ecfg,
                   batch_size=batch_size, device=device)

    @property
    def engine(self) -> InferenceEngine:
        if self._engine is None:
            self._engine = InferenceEngine(
                self.cfg, self.params, self.comp, self.engine_cfg,
                batch_size=self.batch_size, device=self.device)
        return self._engine

    def shard(self, mesh) -> "GearLM":
        """Tensor and data parallelism over ``mesh``'s ``model`` and
        ``data`` axes (``InferenceEngine.shard``): every rank of the process
        group builds the same GearLM, shards it, and generates from the same
        prompts. Afterwards ``params`` holds this rank's slices, so that the
        whole weights can be freed."""
        self.params = self.engine.shard(mesh).params
        return self

    def generate(self, input_ids: Sequence[Sequence[int]] | Sequence[int],
                 max_new_tokens: int = 128, *, seed: int = 0,
                 echo_prompt: bool = False) -> list:
        """Batch greedy/sampled generation (HF ``generate`` analog). Accepts
        one prompt (list of ints) or a batch; pads left."""
        one = bool(input_ids) and isinstance(input_ids[0], int)
        batch = [list(input_ids)] if one else [list(t) for t in input_ids]
        if len(batch) != self.batch_size:
            raise ValueError(f"engine built for batch {self.batch_size}, "
                             f"got {len(batch)} prompts")
        out = self.engine.generate(batch, max_new_tokens, seed=seed,
                                   echo_prompt=echo_prompt)
        return out[0] if one else out
