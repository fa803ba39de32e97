"""Sequence (context) parallelism over the compressed cache; the
counterpart of ``gear_tpu/parallel/context.py``.

The compressed prefix is split along time over a ``seq`` mesh axis: each
rank holds T/n of the packed codes, sidebands and low-rank bases, computes
a partial flash-attention state against its shard, and the states merge
with one ``all_reduce`` of their maxima and one of their weighted sums
(the online-softmax merge). What crosses between ranks each layer is
O(B * Hq * D) floats: the KV never moves.

The residual tier lives on the LAST shard, which alone takes the appended
tokens and flushes them into its own prefix. Lengths are host integers, so
every rank knows every shard's lengths (:func:`split_cache` returns them
all) and how many tokens the cache holds: the flush's init site takes the
global ``comp_len`` with no collective. Attention here is the plain
``cache.attend_partial``, as the reference's is plain XLA.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import cache as kvcache
from ..cache import CacheSpec, LayerCache
from .distributed import Mesh, all_reduce


def shard_spec(spec: CacheSpec, n_shards: int) -> CacheSpec:
    """The per-rank CacheSpec of a seq-sharded cache."""
    if spec.max_len % (n_shards * spec.group):
        raise ValueError("max_len must divide evenly into seq shards of "
                         "whole groups")
    return dataclasses.replace(spec, max_len=spec.max_len // n_shards)


# the axis, counted from the end, along which each leaf is split: time for
# the codes, V sidebands and Q bases; quant blocks for the K sidebands, P
# bases, outliers and base scales. The residual tier goes whole to the last
# shard.
_TIME_AXIS = {
    "k_codes": -1, "v_codes": -1, "v_scale": -1, "v_mn": -1,
    "kqt": -1, "vqt": -1, "kqt_scale": -1, "vqt_scale": -1,
    "k_scale": -2, "k_mn": -2, "kpt_scale": -2, "vpt_scale": -2,
    "k_out_idx": -2, "k_out_val": -2, "v_out_idx": -2, "v_out_val": -2,
    "k_out_bnd": -2, "v_out_bnd": -2, "kpt": -3, "vpt": -3,
}


def split_cache(spec: CacheSpec, cache: LayerCache,
                n_shards: int) -> list[LayerCache]:
    """Split a whole LayerCache (one layer, or stacked layers) into its
    ``n_shards`` time shards, as contiguous copies; rank ``i`` of the
    ``seq`` axis keeps entry ``i``. The residual tier and ``resid_len`` go
    to the last shard (the others get zeros); ``comp_len`` and
    ``prefill_len`` become each shard's own."""
    ls = shard_spec(spec, n_shards).max_len
    shards = []
    for i in range(n_shards):
        last = i == n_shards - 1
        fields = {}
        for f, axis in _TIME_AXIS.items():
            x = getattr(cache, f)
            part = x.shape[axis] // n_shards
            fields[f] = x.narrow(axis, i * part, part).clone()
        for f in ("k_resid", "v_resid"):
            x = getattr(cache, f)
            fields[f] = x.clone() if last else torch.zeros_like(x)
        shards.append(LayerCache(
            **fields,
            comp_len=min(max(cache.comp_len - i * ls, 0), ls),
            resid_len=cache.resid_len if last else 0,
            prefill_len=min(max(cache.prefill_len - i * ls, 0), ls)))
    return shards


def _merge(acc, m, l, mesh: Mesh, axis: str) -> torch.Tensor:
    """The online-softmax merge of every rank's partial state: the maximum
    over the ranks, then one sum of the rescaled numerators and
    denominators."""
    m_tot = all_reduce(m.clone(), mesh, axis, "max")
    a = torch.where(m > -1e29, torch.exp(m - m_tot), torch.zeros_like(m))
    d = acc.shape[-1]
    both = torch.cat([acc * a[..., None], (l * a)[..., None]], dim=-1)
    both = all_reduce(both, mesh, axis)
    return both[..., :d] / both[..., d:]


def seq_sharded_attend(spec: CacheSpec, local: LayerCache, q: torch.Tensor,
                       mesh: Mesh, *, axis: str = "seq",
                       sm_scale: float | None = None,
                       pad_start: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention of q [B,Hq,Qn,D] (the same on every rank) over a
    seq-sharded cache, of which ``local`` is this rank's shard (one layer).
    Returns the output, the same on every rank."""
    lspec = shard_spec(spec, mesh.axis_size(axis))
    acc, m, l = kvcache.attend_partial(
        lspec, local, q, sm_scale=sm_scale, pad_start=pad_start,
        token_offset=mesh.index(axis) * lspec.max_len)
    return _merge(acc, m, l, mesh, axis).to(q.dtype)


def _flush_draws(spec: CacheSpec, shape_bh: tuple, p0, generator, device,
                 use_lowrank: bool) -> None:
    """Draw what ``cache._flush`` draws, in its order, and drop it: a rank
    whose shard does not flush keeps its generator in step with the last
    shard's."""
    if not use_lowrank:
        return
    for which, rank in (("k", spec.rank), ("v", spec.rank_v_eff)):
        if rank > 0:
            shape = (*shape_bh, spec.head_dim, rank)
            if p0 is not None:
                p0(which, shape)
            else:
                torch.rand(shape, generator=generator, device=device,
                           dtype=torch.float32)


def seq_sharded_append_attend(spec: CacheSpec, local: LayerCache,
                              k_new: torch.Tensor, v_new: torch.Tensor,
                              q: torch.Tensor, mesh: Mesh, *, n_tokens: int,
                              axis: str = "seq", p0=None,
                              generator: torch.Generator | None = None,
                              use_lowrank: bool = True,
                              sm_scale: float | None = None,
                              pad_start: torch.Tensor | None = None):
    """One decode step over a seq-sharded cache (this rank's shard
    ``local``, one layer, updated in place): append k_new / v_new [B,H,1,D]
    on the LAST shard (its residual tier, and its flush into its own
    prefix), then the partial attention of every shard, merged.

    ``n_tokens`` is the number of tokens the whole cache held before this
    append: the cache compresses every whole group, so it holds
    ``n_tokens // group * group`` of them compressed, and the flush's
    ``p0(which, shape, comp_len)`` sees that global length, as the
    unsharded ``cache.append`` would. Every rank draws the flush's inits, so
    that generators stay in step. Returns the output [B,Hq,Qn,D], the same
    on every rank.
    """
    n = mesh.axis_size(axis)
    lspec = shard_spec(spec, n)
    g = spec.group
    last = mesh.index(axis) == n - 1
    if last and local.resid_len != n_tokens % g:
        raise ValueError(f"the last shard holds {local.resid_len} residual "
                         f"tokens, the cache's {n_tokens} tokens leave "
                         f"{n_tokens % g}")
    flush = n_tokens % g == g - 1
    site_p0 = None if p0 is None else (
        lambda which, shape: p0(which, shape, n_tokens - n_tokens % g))
    if last:
        kvcache.append(lspec, local, k_new, v_new, p0=site_p0,
                       generator=generator, use_lowrank=use_lowrank)
    elif flush:
        _flush_draws(spec, k_new.shape[:2], site_p0, generator, k_new.device,
                     use_lowrank)
    return seq_sharded_attend(spec, local, q, mesh, axis=axis,
                              sm_scale=sm_scale, pad_start=pad_start)
