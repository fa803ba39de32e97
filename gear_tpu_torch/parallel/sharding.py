"""Tensor and data parallelism: which axis of each weight and cache leaf is
split over the mesh, and this rank's slices; the counterpart of
``gear_tpu/parallel/sharding.py``.

Axes:
  * ``data``  — the batch of activations and of every cache leaf;
  * ``model`` — tensor parallelism: ``wq``/``wk``/``wv`` (heads), ``wg``/``wu``
    (the FFN hidden dim) and ``lm_head`` (the vocabulary) split on their
    columns, ``wo``/``wd`` on their rows, so that each layer's attention
    output and FFN output are partial sums that one ``all_reduce`` completes
    (:class:`TensorParallel`). Every compressed-cache leaf is split on its
    kv-head axis: each rank prefills, packs and attends its own kv heads
    with the same kernels at ``num_kv_heads / model``. In a mixture of
    experts (a ``router`` among the layer weights) the ``model`` axis splits
    the experts instead of their hidden dim: each rank keeps whole experts
    (``wg``/``wu``/``wd`` [L, NE, ...] on their expert axis) and the router
    whole, so that attention runs tensor parallel and the experts expert
    parallel on the same ranks.

A spec is a tuple naming, per dimension of a leaf, the mesh axis it is split
over (None: whole), as ``jax.sharding.PartitionSpec`` does. Where JAX places
a global array and lets XLA insert the collectives, a rank here holds only
its slice (:func:`shard_params`, :func:`shard_cache`) and the layer loop
calls the collectives itself.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cache import LENGTH_FIELDS, TENSOR_FIELDS, LayerCache
from ..models.llama import ModelConfig, RawLayerCache
from .distributed import Mesh, all_reduce, gather


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh; the process group must hold data * model
    ranks."""
    return Mesh({"data": data, "model": model})


def param_pspecs(params: dict) -> dict:
    """The spec of every leaf of a ``models.llama`` parameter dict. Layer
    weights carry a leading stacked-layer axis (never split)."""
    specs = {
        "embed": (None, None),            # replicated (vocab gathers are rare)
        "layers": {
            "attn_norm": (None, None),
            "mlp_norm": (None, None),
            "wq": (None, None, "model"),  # column-parallel (heads)
            "wk": (None, None, "model"),
            "wv": (None, None, "model"),
            "wo": (None, "model", None),  # row-parallel -> all_reduce
            "wg": (None, None, "model"),
            "wu": (None, None, "model"),
            "wd": (None, "model", None),
        },
        "final_norm": (None,),
    }
    if "router" in params.get("layers", {}):   # experts [L, NE, ...]
        specs["layers"].update(router=(None, None, None),
                               **{w: (None, "model", None, None)
                                  for w in ("wg", "wu", "wd")})
    if "lm_head" in params:
        specs["lm_head"] = (None, "model")
    return specs


def cache_pspecs(stacked: bool = True) -> dict:
    """The spec of every ``LayerCache`` field: batch on ``data``, kv heads on
    ``model``; the lengths replicated."""
    lead = (None,) if stacked else ()
    specs = {f: (*lead, "data", "model", None, None) for f in TENSOR_FIELDS}
    specs["kpt"] = specs["vpt"] = (*lead, "data", "model", None, None, None)
    specs.update({f: lead for f in LENGTH_FIELDS})
    return specs


def raw_cache_pspecs(stacked: bool = True) -> dict:
    lead = (None,) if stacked else ()
    return {"k": (*lead, "data", "model", None, None),
            "v": (*lead, "data", "model", None, None), "length": lead}


def local_slice(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec``, contiguous (the tensor
    itself where nothing is split). Raises unless every split dimension
    divides evenly."""
    for dim, axis in enumerate(spec):
        n = 1 if axis is None else mesh.axis_size(axis)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {tuple(x.shape)} leaf "
                             f"does not split evenly over {axis}={n}")
        part = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * part, part)
    return x.contiguous()


def shard_params(mesh: Mesh, params: dict) -> dict:
    """This rank's slices of a ``models.llama`` parameter dict."""
    def walk(tree, specs):
        return {k: walk(v, specs[k]) if isinstance(v, dict)
                else local_slice(v, specs[k], mesh) for k, v in tree.items()}
    return walk(params, param_pspecs(params))


def shard_cache(mesh: Mesh, cache, stacked: bool = True):
    """This rank's slice of a whole ``LayerCache`` or ``RawLayerCache``
    (stacked layers, or one with ``stacked=False``), as contiguous copies:
    the kernels take dense leaves."""
    if isinstance(cache, RawLayerCache):
        specs = raw_cache_pspecs(stacked)
        return RawLayerCache(k=local_slice(cache.k, specs["k"], mesh).clone(),
                             v=local_slice(cache.v, specs["v"], mesh).clone(),
                             length=cache.length)
    specs = cache_pspecs(stacked)
    return LayerCache(
        **{f: local_slice(getattr(cache, f), specs[f], mesh).clone()
           for f in TENSOR_FIELDS},
        **{f: getattr(cache, f) for f in LENGTH_FIELDS})


def local_config(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The model as one rank of ``model`` runs it: its share of the query
    and kv heads and of the FFN hidden dim (the vocabulary stays whole: the
    logits are gathered). A mixture of experts (``num_experts``) keeps its
    experts' hidden dim, its expert count and its routing: the rank holds
    ``num_experts / model`` whole experts. Raises unless each divides
    evenly."""
    m = mesh.axis_size("model")
    moe = hasattr(cfg, "num_experts")
    sizes = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    sizes["num_experts" if moe else "intermediate_size"] = (
        cfg.num_experts if moe else cfg.intermediate_size)
    if not cfg.tie_word_embeddings:  # lm_head is split on the vocabulary
        sizes["vocab_size"] = cfg.vocab_size
    for name, n in sizes.items():
        if n % m:
            raise ValueError(f"{name} {n} does not split evenly over "
                             f"model={m}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // m, num_kv_heads=cfg.num_kv_heads // m,
        intermediate_size=cfg.intermediate_size // (1 if moe else m))


class TensorParallel:
    """The collectives of the ``model`` axis that ``models.llama``'s layer
    loop calls: the row-parallel partial sums (attention out, FFN out)
    summed in float32 before the residual add, and the vocabulary-split
    logits gathered."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        self.mesh, self.axis = mesh, axis

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.float(), self.mesh, self.axis).to(x.dtype)

    def vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return gather(logits, self.mesh, self.axis, -1)


def sharded_inits(mesh: Mesh, init, generator: torch.Generator | None,
                  device):
    """``init(site, shape)`` for one rank of a (data, model) mesh. The
    power-iteration inits are asked for at the local shape [b, h, ...]; each
    comes from the whole batch's and heads' draw [b * data, h * model, ...]
    (``init``'s, or uniform [0, 1) from ``generator``, as the unsharded run
    draws it), of which the rank keeps its rows and heads. So the ranks
    together take the unsharded run's inits, and every rank's generator
    stays in step with the others'."""
    nd, nm = mesh.axis_size("data"), mesh.axis_size("model")
    di, mi = mesh.index("data"), mesh.index("model")

    def draw(site, shape):
        b, h, *rest = shape
        whole = (b * nd, h * nm, *rest)
        x = (init(site, whole) if init is not None else
             torch.rand(whole, generator=generator, device=device,
                        dtype=torch.float32))
        return x[di * b:(di + 1) * b, mi * h:(mi + 1) * h]
    return draw
