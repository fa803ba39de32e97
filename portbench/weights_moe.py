"""Seeded weights of a mixture of experts, drawn a piece at a time, so that a
rank draws only its share and the reference one layer at a time.

The model is too large for one card, so no process ever holds it whole.
Every piece has a generator of its own, seeded from the run's seed and the
piece's name, layer and expert: a layer's attention matrix, its router, one
expert's matrix of a layer, the embedding, the output head. A piece is
always drawn whole, on the device, in the type it is served in (the
configuration's ``torch_dtype``), and a rank keeps its slice of it, so the
values do not depend on who draws them. The distributions are
``weights.make``'s: each matrix N(0, 1/fan_in), the embedding N(0,
0.02^2), the norms ones.

:func:`rank_share` is one rank's parameters in the port's layout, sharded
as ``gear_tpu_torch.parallel.sharding`` shards them over ``world`` ranks:
its query and kv heads (``wq``/``wk``/``wv`` columns, ``wo`` rows), its
``num_local_experts / world`` experts whole, the router and the norms
whole, its columns of ``lm_head`` and the whole embedding. :func:`layer`
and :func:`outer` are the reference's: a whole layer, and the pieces
outside the layers.
"""
from __future__ import annotations

import hashlib

import torch

from portbench.weights import dtype_of


def _dims(hf: dict):
    e = hf["hidden_size"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    d = hf.get("head_dim") or e // hq
    return e, hf["intermediate_size"], hq, hkv, d


def piece(hf: dict, seed: int, device, name: str, shape: tuple, std: float,
          layer: int = -1, expert: int = -1) -> torch.Tensor:
    """The piece ``name`` of ``layer`` and ``expert``, drawn whole."""
    h = hashlib.sha256(repr((seed, name, layer, expert)).encode()).digest()
    gen = torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)
    return torch.empty(shape, dtype=dtype_of(hf), device=device).normal_(
        0.0, std, generator=gen)


def _attn(hf, seed, device, i):
    e, _, hq, hkv, d = _dims(hf)
    return {
        "wq": piece(hf, seed, device, "wq", (e, hq * d), e ** -0.5, i),
        "wk": piece(hf, seed, device, "wk", (e, hkv * d), e ** -0.5, i),
        "wv": piece(hf, seed, device, "wv", (e, hkv * d), e ** -0.5, i),
        "wo": piece(hf, seed, device, "wo", (hq * d, e), (hq * d) ** -0.5, i),
        "router": piece(hf, seed, device, "router",
                        (e, hf["num_local_experts"]), e ** -0.5, i),
    }


def _expert(hf, seed, device, i, x):
    e, f = hf["hidden_size"], hf["intermediate_size"]
    return {"wg": piece(hf, seed, device, "wg", (e, f), e ** -0.5, i, x),
            "wu": piece(hf, seed, device, "wu", (e, f), e ** -0.5, i, x),
            "wd": piece(hf, seed, device, "wd", (f, e), f ** -0.5, i, x)}


def layer(hf: dict, seed: int, i: int, device) -> dict:
    """Layer ``i`` whole: norms, attention, router, and ``wg``/``wu``/``wd``
    stacked over the experts [NE, ...]."""
    e = hf["hidden_size"]
    ones = torch.ones(e, dtype=dtype_of(hf), device=device)
    out = {"attn_norm": ones, "mlp_norm": ones, **_attn(hf, seed, device, i)}
    experts = [_expert(hf, seed, device, i, x)
               for x in range(hf["num_local_experts"])]
    for w in ("wg", "wu", "wd"):
        out[w] = torch.stack([x[w] for x in experts])
    return out


def outer(hf: dict, seed: int, device) -> dict:
    """The embedding, the final norm and the output head, whole."""
    e, v = hf["hidden_size"], hf["vocab_size"]
    return {"embed": piece(hf, seed, device, "embed", (v, e), 0.02),
            "final_norm": torch.ones(e, dtype=dtype_of(hf), device=device),
            "lm_head": piece(hf, seed, device, "lm_head", (e, v), e ** -0.5)}


def rank_share(hf: dict, seed: int, device, rank: int, world: int) -> dict:
    """Rank ``rank`` of ``world``'s parameters (see the module's
    docstring), the layers stacked on a leading axis."""
    e, f, hq, hkv, d = _dims(hf)
    n_layers, ne = hf["num_hidden_layers"], hf["num_local_experts"]
    for name, n in (("heads", hq), ("kv heads", hkv), ("experts", ne),
                    ("vocabulary", hf["vocab_size"])):
        if n % world:
            raise ValueError(f"{n} {name} do not split over {world} ranks")
    dt = dtype_of(hf)

    def cols(x):   # this rank's share of the last axis
        w = x.shape[-1] // world
        return x[..., rank * w:(rank + 1) * w]

    nel = ne // world
    shapes = {"wq": (e, hq * d // world), "wk": (e, hkv * d // world),
              "wv": (e, hkv * d // world), "wo": (hq * d // world, e),
              "router": (e, ne), "wg": (nel, e, f), "wu": (nel, e, f),
              "wd": (nel, f, e)}
    layers = {k: torch.empty((n_layers, *s), dtype=dt, device=device)
              for k, s in shapes.items()}
    for i in range(n_layers):
        a = _attn(hf, seed, device, i)
        for k in ("wq", "wk", "wv"):
            layers[k][i] = cols(a[k])
        rows = a["wo"].shape[0] // world
        layers["wo"][i] = a["wo"][rank * rows:(rank + 1) * rows]
        layers["router"][i] = a["router"]
        for j in range(nel):
            x = _expert(hf, seed, device, i, rank * nel + j)
            for k in ("wg", "wu", "wd"):
                layers[k][i, j] = x[k]
    ones = torch.ones((n_layers, e), dtype=dt, device=device)
    layers["attn_norm"], layers["mlp_norm"] = ones, ones.clone()
    out = outer(hf, seed, device)
    out["lm_head"] = cols(out["lm_head"]).contiguous()
    return {**out, "layers": layers}
