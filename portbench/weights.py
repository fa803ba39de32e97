"""Random weights of a configuration, made on the device from the seed.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference. They are drawn by one ``torch.Generator`` on
the device, one call per stacked tensor, directly in the type they are
served in (the configuration's ``torch_dtype``), in the port's parameter
layout: ``x @ W`` matrices stacked over the layers, ``embed``,
``final_norm``, ``lm_head``.
Each matrix is N(0, 1/fan_in), the embedding N(0, 0.02^2), the norms ones.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(hf: dict) -> torch.dtype:
    """The dtype the configuration is served in (``torch_dtype``)."""
    return DTYPES[hf.get("torch_dtype", "bfloat16")]


def make(hf: dict, seed: int, device) -> dict:
    e, f = hf["hidden_size"], hf["intermediate_size"]
    n_layers, vocab = hf["num_hidden_layers"], hf["vocab_size"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    d = hf.get("head_dim") or e // hq
    dt = dtype_of(hf)
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, std):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(n_layers, e),
        "mlp_norm": ones(n_layers, e),
        "wq": draw(n_layers, e, hq * d, std=e ** -0.5),
        "wk": draw(n_layers, e, hkv * d, std=e ** -0.5),
        "wv": draw(n_layers, e, hkv * d, std=e ** -0.5),
        "wo": draw(n_layers, hq * d, e, std=(hq * d) ** -0.5),
    }
    layers["wg"] = draw(n_layers, e, f, std=e ** -0.5)
    layers["wu"] = draw(n_layers, e, f, std=e ** -0.5)
    layers["wd"] = draw(n_layers, f, e, std=f ** -0.5)
    return {"embed": draw(vocab, e, std=0.02), "layers": layers,
            "final_norm": ones(e), "lm_head": draw(e, vocab, std=e ** -0.5)}
