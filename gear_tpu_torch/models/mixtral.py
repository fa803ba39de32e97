"""Mixtral (sparse mixture of experts) over the compressed KV cache,
PyTorch port of ``gear_tpu/models/mixtral.py``.

The attention, the caches and the layer loop are Llama's: the forward
passes are :func:`models.llama.forward_prefill` / ``forward_decode`` with
this module's expert mixture as each layer's feed-forward block, so every
engine mode's cache step and the kernels behind it (``attend_fused`` over
the compressed cache, ``raw_attend_flash`` over the raw one, the pack
kernels in the prefill) serve Mixtral unchanged.

The mixture is the reference's: top-k routing with a DENSE weighted sum,
where every expert runs and the renormalised top-k gates (zero for the
others) weight the results. Experts are read without copying: the rows of
the batch are folded into one ``[1, rows, E] @ [NE, E, F]`` product, and
long prompts run the mixture over chunks of :data:`MOE_ROWS` rows, so the
``[NE, rows, F]`` intermediates stay bounded. :func:`moe_block_ep` runs
the experts sharded over the ranks of an ``expert`` mesh axis
(``parallel.distributed``). The engine runs Mixtral through the same
passes with :func:`engine_ffn` as the ``ffn``: under its tensor
parallelism the ``model`` axis holds whole experts (``parallel.sharding``),
every rank routes over all of them, runs its own and hands the layer loop
the float32 partial sum that its ``all_reduce`` completes. Nothing in the
mixture syncs with the host, so a CUDA graph holds it. Each call is a
``moe.block`` span (attributes ``rows``, ``experts_local``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import profiling
from ..device import resolve_device
from ..parallel import distributed, sharding
from . import llama
from .llama import ModelConfig

MOE_ROWS = 4096  # rows of the mixture at a time ([8, 4096, 14336] bf16: 0.9 GB)


@dataclass(frozen=True)
class MixtralConfig(ModelConfig):
    num_experts: int = 8
    experts_per_token: int = 2

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    num_experts=4, experts_per_token=2,
                    max_position_embeddings=512)
        base.update(kw)
        return cls(**base)

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        return cls(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, head_dim=128, rope_theta=1000000.0,
                   max_position_embeddings=32768, num_experts=8,
                   experts_per_token=2)

    @classmethod
    def from_hf(cls, cfg: dict) -> "MixtralConfig":
        """From a HF MixtralConfig dict (``num_local_experts``,
        ``num_experts_per_tok`` beside the Llama keys)."""
        base = ModelConfig.from_hf(cfg)
        return cls(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(base)},
                   num_experts=cfg.get("num_local_experts", 8),
                   experts_per_token=cfg.get("num_experts_per_tok", 2))


def init_params(cfg: MixtralConfig, *, seed: int = 0, device=None) -> dict:
    """Random init from a seeded ``torch.Generator`` on ``device``, in the
    layout of ``gear_tpu.models.mixtral.init_params`` (``lm_head`` always
    present). Every stacked tensor is drawn a layer (and an expert) at a
    time in float32 and cast, so the float32 draws never hold more than one
    [E, F] matrix."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e, f, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    ne = cfg.num_experts
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def draw(*shape, scale):
        # the leading axes are drawn one matrix at a time
        out = torch.empty(shape, dtype=dt, device=dev)
        for m in out.view(-1, *shape[-2:]):
            m.copy_(torch.randn(shape[-2:], generator=gen, device=dev,
                                dtype=torch.float32).mul_(scale))
        return out

    return {
        "embed": draw(cfg.vocab_size, e, scale=0.02),
        "layers": {
            "attn_norm": torch.ones((l, e), dtype=dt, device=dev),
            "mlp_norm": torch.ones((l, e), dtype=dt, device=dev),
            "wq": draw(l, e, hq * dh, scale=e ** -0.5),
            "wk": draw(l, e, hkv * dh, scale=e ** -0.5),
            "wv": draw(l, e, hkv * dh, scale=e ** -0.5),
            "wo": draw(l, hq * dh, e, scale=(hq * dh) ** -0.5),
            "router": draw(l, e, ne, scale=e ** -0.5),
            "wg": draw(l, ne, e, f, scale=e ** -0.5),
            "wu": draw(l, ne, e, f, scale=e ** -0.5),
            "wd": draw(l, ne, f, e, scale=f ** -0.5),
        },
        "final_norm": torch.ones((e,), dtype=dt, device=dev),
        "lm_head": draw(e, cfg.vocab_size, scale=e ** -0.5),
    }


class RouterLog:
    """The router's probabilities in an engine's passes, kept for a check
    that follows the program's choice of experts: ``take_prompt()`` [L, B,
    S, NE] of the last prompt pass, and ``step`` [L, B, NE] of the last decode
    step, a buffer every decode step writes in place (a replayed CUDA graph
    included: the capture holds the copies)."""

    def __init__(self, num_layers: int, batch: int, num_experts: int,
                 device):
        self.step = torch.zeros((num_layers, batch, num_experts),
                                dtype=torch.float32, device=device)
        self._prompt: list[torch.Tensor] = []
        self._layer: int | None = None   # the decode step's next layer

    def begin(self, prompt: bool) -> None:
        """Before a pass: a prompt pass or a decode step."""
        if prompt:
            self._prompt = []
        self._layer = None if prompt else 0

    def put(self, probs: torch.Tensor) -> None:
        """One layer's probabilities [B, S, NE], in layer order."""
        if self._layer is None:
            self._prompt.append(probs.clone())
        else:
            self.step[self._layer].copy_(probs[:, -1])
            self._layer += 1

    def take_prompt(self) -> torch.Tensor:
        """The last prompt pass's probabilities [L, B, S, NE], let go of."""
        out, self._prompt = torch.stack(self._prompt), []
        return out


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int,
           log: RouterLog | None = None):
    """The gates [B*S, NE] f32 of x [B,S,E]: float32 logits, softmax over the
    experts, every expert whose probability reaches the k-th largest kept
    (so ties keep more than k), the kept renormalised. ``log`` keeps the
    probabilities."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)   # [B,S,NE]
    if log is not None:
        log.put(probs)
    thresh = probs.topk(top_k, dim=-1).values[..., -1:]
    gate = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
    return (gate / gate.sum(dim=-1, keepdim=True)).reshape(-1, gate.shape[-1])


def _mixture(x: torch.Tensor, gate: torch.Tensor, wg: torch.Tensor,
             wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Sum over the experts of ``wg``/``wu``/``wd`` (the leading axis) of
    their outputs for x [B,S,E], weighted by ``gate`` [B*S, n] ->
    [B*S, E] f32, in chunks of :data:`MOE_ROWS` rows."""
    b, s, e = x.shape
    gate = gate.T
    xr = x.reshape(1, b * s, e)
    out = torch.empty((b * s, e), dtype=torch.float32, device=x.device)
    rows = MOE_ROWS
    for r in range(0, b * s, rows):
        xc = xr[:, r:r + rows]
        h = F.silu(xc @ wg) * (xc @ wu)                         # [n,rows,F]
        y = (h @ wd).float()                                    # [n,rows,E]
        out[r:r + rows] = (y * gate[:, r:r + rows, None]).sum(dim=0)
    return out


def moe_partial(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, top_k: int,
                first: int = 0, log: RouterLog | None = None) -> torch.Tensor:
    """The weighted sum [B,S,E] f32 of the outputs of the experts that
    ``wg``/``wu``/``wd`` hold, experts ``first`` .. ``first + n`` of the
    router's NE, routed over all NE (:func:`_route`)."""
    n = wg.shape[0]
    with profiling.span("moe.block", rows=x.shape[0] * x.shape[1],
                        experts_local=n):
        gate = _route(x, router, top_k, log)[:, first:first + n]
        return _mixture(x, gate, wg, wu, wd).reshape(x.shape)


def moe_block(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, top_k: int) -> torch.Tensor:
    """Sparse-MoE FFN as a dense weighted mixture.

    x [B,S,E]; router [E,NE]; wg / wu [NE,E,F]; wd [NE,F,E]. Routing as the
    reference (HF Mixtral; :func:`_route`). The expert products, ``silu``
    and ``h_g * h_u`` run in the model dtype, the weighted sum over the
    experts in float32, cast back at the end.
    """
    return moe_partial(x, router, wg, wu, wd, top_k).to(x.dtype)


def moe_block_ep(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor, top_k: int, mesh,
                 axis: str = "expert") -> torch.Tensor:
    """EXPERT-PARALLEL :func:`moe_block` on one rank of ``mesh``'s ``axis``
    of n ranks: every rank routes identically (the router and x are the
    same on all), runs only its NE / n experts, and one float32
    ``all_reduce`` sums the weighted partial outputs.

    ``wg`` / ``wu`` / ``wd`` hold only this rank's experts, as
    :func:`shard_experts` leaves them.
    """
    ne, n = router.shape[-1], mesh.axis_size(axis)
    if ne % n:
        raise ValueError(f"{ne} experts do not split evenly over {axis}={n}")
    part = moe_partial(x, router, wg, wu, wd, top_k,
                       first=mesh.index(axis) * (ne // n))
    return distributed.all_reduce(part, mesh, axis).to(x.dtype)


def shard_experts(mesh, params: dict, axis: str = "expert") -> dict:
    """``params`` with each layer stack of expert weights cut to this rank's
    experts of ``axis`` (contiguous copies, so the whole stacks can be
    freed); everything else shared with ``params``."""
    layers = dict(params["layers"])
    for name in ("wg", "wu", "wd"):
        layers[name] = sharding.local_slice(layers[name], (None, axis), mesh)
    return {**params, "layers": layers}


def engine_ffn(cfg: MixtralConfig, tp=None, log: RouterLog | None = None):
    """The ``ffn(lp, x)`` the engine runs: :func:`moe_block`; under tensor
    parallelism (``tp``, a ``parallel.sharding.TensorParallel`` whose axis
    holds this rank's experts) :func:`moe_partial` over them, a partial sum
    that the layer loop reduces in float32 as it does ``wo``'s. ``log``
    keeps the router's probabilities."""
    if tp is None and log is None:
        return _moe_ffn(cfg)
    index = 0 if tp is None else tp.mesh.index(tp.axis)

    def ffn(lp: dict, x: torch.Tensor) -> torch.Tensor:
        part = moe_partial(x, lp["router"], lp["wg"], lp["wu"], lp["wd"],
                           cfg.experts_per_token,
                           first=index * lp["wg"].shape[0], log=log)
        return part if tp is not None else part.to(x.dtype)
    return ffn


def _moe_ffn(cfg: MixtralConfig, ep_mesh=None, ep_axis: str = "expert"):
    def ffn(lp: dict, x: torch.Tensor) -> torch.Tensor:
        if ep_mesh is not None:
            return moe_block_ep(x, lp["router"], lp["wg"], lp["wu"],
                                lp["wd"], cfg.experts_per_token, ep_mesh,
                                ep_axis)
        return moe_block(x, lp["router"], lp["wg"], lp["wu"], lp["wd"],
                         cfg.experts_per_token)
    return ffn


def forward_prefill(params: dict, cfg: MixtralConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, attn_mask: torch.Tensor,
                    spec, *, compress: bool = True, init=None,
                    generator: torch.Generator | None = None,
                    ep_mesh=None, ep_axis: str = "expert"):
    """The prompt pass -> (logits [B,S,V] f32, stacked caches): compressed
    with ``spec`` and ``compress``, raw with ``compress=False``, the stacked
    (k, v) without ``spec``. Inits as :func:`models.llama.forward_prefill`.
    With ``ep_mesh`` the experts run expert-parallel over its ``ep_axis``
    (:func:`moe_block_ep`)."""
    return llama.forward_prefill(
        params, cfg, tokens, positions, attn_mask, spec, compress=compress,
        init=init, generator=generator, ffn=_moe_ffn(cfg, ep_mesh, ep_axis))


def forward_decode(params: dict, cfg: MixtralConfig, token: torch.Tensor,
                   position: torch.Tensor, caches, *, spec,
                   compress: bool = True,
                   pad_start: torch.Tensor | None = None, init=None,
                   generator: torch.Generator | None = None, step: int = 0,
                   ep_mesh=None, ep_axis: str = "expert"):
    """One decode step over the stacked caches (updated in place) ->
    (logits [B, V] f32, caches), as :func:`models.llama.forward_decode`;
    ``ep_mesh`` as :func:`forward_prefill`."""
    return llama.forward_decode(
        params, cfg, token, position, caches, spec=spec, compress=compress,
        pad_start=pad_start, init=init, generator=generator, step=step,
        ffn=_moe_ffn(cfg, ep_mesh, ep_axis))
