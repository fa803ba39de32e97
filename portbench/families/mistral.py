"""The program's entries for a Mistral (or Llama) configuration: the port's
``engine.InferenceEngine`` in the cell's mode, its ``prefill`` and
``decode_step`` driven as the window drives them."""
from __future__ import annotations

import dataclasses
import math

import torch

from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine
from gear_tpu_torch.models import llama
from portbench.weights import dtype_of


def port_rope_theta(theta: float, head_dim: int) -> float:
    """The ``rope_theta`` to hand the port so that it rotates at the
    published frequencies, theta ** (-2i / D) for i < D / 2.

    The port's ``llama.rope_cos_sin`` rotates at theta ** (-4i / D), so the
    published model is the port at sqrt(theta). Which parameter the port
    wants is read from the port itself, at positions 1-3, so a port that
    takes the published one is handed it unchanged. If neither candidate
    rotates as published, ``theta`` is handed on and the check reads the
    difference."""
    pos = torch.tensor([[1, 2, 3]])
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                        dtype=torch.float32) / head_dim))
    ang = pos[..., None].float() * inv
    want = torch.cos(torch.cat([ang, ang], -1)), \
        torch.sin(torch.cat([ang, ang], -1))
    for cand in (theta, math.sqrt(theta)):
        got = llama.rope_cos_sin(pos, head_dim, cand)
        if all(torch.allclose(g, w, rtol=0, atol=1e-5)
               for g, w in zip(got, want)):
            return cand
    return theta


def model_config(hf: dict) -> llama.ModelConfig:
    cfg = llama.ModelConfig.from_hf(hf)
    return dataclasses.replace(
        cfg, dtype=dtype_of(hf),
        rope_theta=port_rope_theta(cfg.rope_theta, cfg.head_dim))


class Program:
    def __init__(self, hf: dict, params: dict, comp: dict | None, mode: str,
                 max_len: int, batch: int, device):
        cfg = model_config(hf)
        self.rope = {"published_theta": hf.get("rope_theta", 10000.0),
                     "port_theta": cfg.rope_theta}
        ccfg = CompressionConfig(num_layers=cfg.num_layers, **(comp or {}))
        self.eng = InferenceEngine(cfg, params, ccfg,
                                   EngineConfig(max_len=max_len, mode=mode),
                                   batch_size=batch, device=device)

    def prefill(self, tokens, mask, init):
        """-> (next-token logits [B, V] of the prompts, the caches)."""
        logits, caches = self.eng.prefill(tokens, mask, init=init)
        last = logits[:, -1].clone()
        del logits
        return last, caches

    def decode(self, caches, token, position, pad_start, step, init):
        """One greedy decode step -> (tokens [B], caches)."""
        nxt, _, caches = self.eng.decode_step(caches, token, position,
                                              pad_start, step=step, init=init)
        return nxt, caches
