"""Load HF Llama-family checkpoints into gear_tpu_torch param dicts.

Port of ``gear_tpu/models/loader.py``: safetensors (through the
``safetensors`` package when present, else a numpy reader of the format) or
torch ``.bin`` shards from a local directory, mapped to the functional layout
of ``gear_tpu_torch.models.llama`` (no network access).

Name mapping (HF -> ours), per layer i:
  model.embed_tokens.weight                 -> embed
  model.layers.i.input_layernorm.weight     -> layers.attn_norm[i]
  model.layers.i.self_attn.{q,k,v}_proj.weight -> layers.w{q,k,v}[i] (transposed)
  model.layers.i.self_attn.o_proj.weight    -> layers.wo[i] (transposed)
  model.layers.i.post_attention_layernorm.weight -> layers.mlp_norm[i]
  model.layers.i.mlp.{gate,up,down}_proj.weight -> layers.w{g,u,d}[i] (transposed)
  model.norm.weight                         -> final_norm
  lm_head.weight                            -> lm_head (transposed)
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .llama import ModelConfig


def _iter_tensors(model_dir: Path):
    """Yield (name, float32 numpy array) from safetensors or .bin shards."""
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        try:
            from safetensors import safe_open  # type: ignore
        except ImportError:
            safe_open = None
        for f in st_files:
            if safe_open is None:
                yield from _read_safetensors_manual(f)
                continue
            with safe_open(str(f), framework="pt") as sf:
                for name in sf.keys():
                    yield name, sf.get_tensor(name).float().numpy()
        return
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin shards in {model_dir}")
    for f in bin_files:
        state = torch.load(str(f), map_location="cpu", weights_only=True)
        for name, t in state.items():
            yield name, t.float().numpy()


_ST_DTYPES = {
    "F32": np.float32, "F16": np.float16,
    "I32": np.int32, "I64": np.int64, "U8": np.uint8,
}


def _read_safetensors_manual(path: Path):
    """The safetensors format with numpy alone: an 8-byte little-endian
    header length, a JSON header, then the raw tensors."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
        base = 8 + header_len
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            f.seek(base + start)
            raw = f.read(end - start)
            if meta["dtype"] == "BF16":
                bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
                arr = bits.view(np.float32)
            else:
                arr = np.frombuffer(raw, _ST_DTYPES[meta["dtype"]]).astype(
                    np.float32)
            yield name, arr.reshape(meta["shape"])


def load_config(model_dir: str | os.PathLike) -> ModelConfig:
    with open(Path(model_dir) / "config.json") as f:
        return ModelConfig.from_hf(json.load(f))


_NAME_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("wg", True),
    "mlp.up_proj.weight": ("wu", True),
    "mlp.down_proj.weight": ("wd", True),
}


def load_params(model_dir: str | os.PathLike, cfg: ModelConfig | None = None,
                dtype=torch.bfloat16, device=None) -> tuple[ModelConfig, dict]:
    """Read a local HF checkpoint directory -> (ModelConfig, params) with the
    params on ``device`` (default ``cuda``, raising without one)."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    if cfg is None:
        cfg = load_config(model_dir)
    l = cfg.num_layers
    layers: dict[str, list] = {k: [None] * l for k, _ in _NAME_MAP.values()}
    top: dict[str, np.ndarray] = {}

    for name, arr in _iter_tensors(model_dir):
        if name == "model.embed_tokens.weight":
            top["embed"] = arr
        elif name == "model.norm.weight":
            top["final_norm"] = arr
        elif name == "lm_head.weight":
            top["lm_head"] = arr.T
        elif name.startswith("model.layers."):
            idx_s, _, tail = name[len("model.layers."):].partition(".")
            if tail in _NAME_MAP:
                key, transpose = _NAME_MAP[tail]
                layers[key][int(idx_s)] = arr.T if transpose else arr

    for key, vals in layers.items():
        missing = [i for i, v in enumerate(vals) if v is None]
        if missing:
            raise ValueError(f"missing layer tensors for {key}: {missing}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev,
                                                            dtype=dtype)

    params = {
        "embed": t(top["embed"]),
        "layers": {k: t(np.stack(v)) for k, v in layers.items()},
        "final_norm": t(top["final_norm"]),
    }
    if "lm_head" in top and not cfg.tie_word_embeddings:
        params["lm_head"] = t(top["lm_head"])
    elif not cfg.tie_word_embeddings:
        raise ValueError("checkpoint has no lm_head and config does not tie")
    return cfg, params
