"""The cache's flush as one kernel launch a layer (CUDA, sm_90a).

``csrc/flush.cu`` replaces no Pallas kernel: the reference's flush
(``gear_tpu/cache.py:_flush``) is jitted XLA. The plain version,
:func:`flush_plain`, runs it operation by operation, some 340 launches a
layer on the card; the kernel does a layer's whole flush, K and V, in one:
outliers, quantize and pack, the outliers' sorted entries, and the low-rank
error bases, written in place at block ``comp_len // group`` of the cache's
storages (no leaf is reallocated, so a CUDA graph keyed on them stays
valid). Its design and bound are in the source's note.

:func:`route` picks the version from the cache's device, once a flush:
the plain one on the CPU, the kernel on a CUDA device. :func:`flush`, the
kernel's wrapper, launches it, or raises for a spec it does not take: bf16
cache and sidebands, head_dim <= 128 and a multiple of 4, group <= 128,
ranks and ``r_store`` <= 8, or for a cache off the card. The power
iteration's starts are drawn before the launch exactly as the plain version
draws them (K's, then V's, from ``p0`` or as uniform draws from
``generator``), so both routes start alike. The wrapper counts its launches
in ``flush.launches``.
"""
from __future__ import annotations

import torch

from .. import cache as kvcache
from . import _build
from .decode import check_operands

MAX_RANK = 8  # csrc/flush.cu kMaxRank


def flush_plain(spec: kvcache.CacheSpec, cache: kvcache.LayerCache, p0,
                generator: torch.Generator | None,
                use_lowrank: bool = True) -> None:
    """Quantize the full residual tier into the packed prefix at
    ``comp_len``, in place, with plain PyTorch operations (the reference's
    steps). Leaves the lengths to the caller."""
    g = spec.group
    c0 = cache.comp_len
    kb = cache.k_resid.float()
    vb = cache.v_resid.float()
    k_pack, k_scale, k_mn, ko_i, ko_v, ko_b = kvcache._compress_k_block(
        spec, kb)
    v_pack, v_scale, v_mn, vo_i, vo_v, vo_b = kvcache._compress_v_block(
        spec, vb)
    blk = c0 // g
    cache.k_codes[:, :, :, c0:c0 + g] = k_pack
    cache.k_scale[:, :, blk] = k_scale[:, :, 0]
    cache.k_mn[:, :, blk] = k_mn[:, :, 0]
    cache.v_codes[:, :, :, c0:c0 + g] = v_pack
    cache.v_scale[:, :, :, c0:c0 + g] = v_scale
    cache.v_mn[:, :, :, c0:c0 + g] = v_mn
    if spec.outliers_per_block:
        cache.k_out_idx[:, :, blk] = ko_i[:, :, 0]
        cache.k_out_val[:, :, blk] = ko_v[:, :, 0]
        cache.v_out_idx[:, :, blk] = vo_i[:, :, 0]
        cache.v_out_val[:, :, blk] = vo_v[:, :, 0]
        cache.k_out_bnd[:, :, blk] = ko_b[:, :, 0]
        cache.v_out_bnd[:, :, blk] = vo_b[:, :, 0]
    if use_lowrank and max(spec.rank, spec.rank_v_eff) > 0:
        k_hat = kvcache._dequant_k_block(spec, k_pack, k_scale, k_mn, ko_i,
                                         ko_v)
        v_hat = kvcache._dequant_v_block(spec, v_pack, v_scale, v_mn, vo_i,
                                         vo_v)
        kp, kqt, kps, kqs = kvcache._error_bases(spec, kb, k_hat, spec.rank,
                                                 "k", p0, generator)
        vp, vqt, vps, vqs = kvcache._error_bases(spec, vb, v_hat,
                                                 spec.rank_v_eff, "v", p0,
                                                 generator)
        cache.kpt[:, :, blk] = kp.transpose(-1, -2)
        cache.kqt[:, :, :, c0:c0 + g] = kqt
        cache.vpt[:, :, blk] = vp.transpose(-1, -2)
        cache.vqt[:, :, :, c0:c0 + g] = vqt
        cache.kpt_scale[:, :, blk] = kps
        cache.kqt_scale[:, :, :, blk] = kqs
        cache.vpt_scale[:, :, blk] = vps
        cache.vqt_scale[:, :, :, blk] = vqs


def route(device: torch.device) -> str:
    """The version a flush takes on ``device``: ``plain`` on the CPU,
    ``kernel`` on a CUDA device; raises for any other."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"unsupported device {device}")


def check_spec(spec: kvcache.CacheSpec) -> None:
    """Raise unless the kernel takes ``spec``."""
    if spec.dtype != torch.bfloat16 or spec.sideband_dtype != torch.bfloat16:
        raise TypeError(f"the flush kernel takes a bf16 cache and bf16 "
                        f"sidebands, got {spec.dtype} / {spec.sideband_dtype}")
    if spec.head_dim > 128 or spec.head_dim % 4:
        raise ValueError(f"head_dim {spec.head_dim}: the flush kernel takes "
                         "multiples of 4 up to 128")
    if spec.group > 128:
        raise ValueError(f"group {spec.group} > 128")
    if max(spec.r_store, spec.rank, spec.rank_v_eff) > MAX_RANK:
        raise ValueError(f"ranks up to {MAX_RANK}: r_store {spec.r_store}")


def _starts(spec, device, p0, generator) -> dict:
    """The power iteration's starts [B, H, D, rank] f32, K's then V's, as
    ``cache._error_bases`` draws them."""
    b, h, d = spec.batch, spec.num_kv_heads, spec.head_dim
    starts = {}
    for which, rank in (("k", spec.rank), ("v", spec.rank_v_eff)):
        if rank <= 0:
            continue
        if spec.lowrank_loop <= 0:
            raise ValueError("rank and n_iter must be positive")
        shape = (b, h, d, rank)
        init = p0(which, shape) if p0 is not None else torch.rand(
            shape, generator=generator, device=device, dtype=torch.float32)
        starts[which] = init.to(device=device, dtype=torch.float32).expand(
            shape).contiguous()
    return starts


def launch_args(spec: kvcache.CacheSpec, cache: kvcache.LayerCache,
                starts: dict, lowrank: bool) -> list[int]:
    """``gear_flush``'s arguments but the stream, after checking every leaf:
    each tensor's pointers (residual tier, codes, sidebands, outlier index,
    delta and boundary table, P^T, Q^T, their scales, the start), then the
    sizes."""
    b, h, d = spec.batch, spec.num_kv_heads, spec.head_dim
    g, t, nb, r = spec.group, spec.max_len, spec.n_blocks, spec.r_store
    ks, ngv = spec.ko_store, spec.v_groups_per_token
    sb, dt, bdt = spec.sideband_dtype, spec.dtype, spec.base_dtype
    i32, f32 = torch.int32, torch.float32
    lead = (b, h)
    expect = {}
    for x in ("k", "v"):
        side = (nb, d) if x == "k" else (ngv, t)
        expect.update({
            f"{x}_resid": (getattr(cache, f"{x}_resid"), dt, (*lead, g, d)),
            f"{x}_codes": (getattr(cache, f"{x}_codes"), i32,
                           (*lead, spec.v_words, t)),
            f"{x}_scale": (getattr(cache, f"{x}_scale"), sb, (*lead, *side)),
            f"{x}_mn": (getattr(cache, f"{x}_mn"), sb, (*lead, *side)),
            f"{x}_out_idx": (getattr(cache, f"{x}_out_idx"), i32,
                             (*lead, nb, ks // 2)),
            f"{x}_out_val": (getattr(cache, f"{x}_out_val"), dt,
                             (*lead, nb, ks)),
            f"{x}_out_bnd": (getattr(cache, f"{x}_out_bnd"), i32,
                             (*lead, nb, spec.bnd_lanes)),
            f"{x}pt": (getattr(cache, f"{x}pt"), bdt, (*lead, nb, r, d)),
            f"{x}qt": (getattr(cache, f"{x}qt"), bdt, (*lead, r, t)),
            f"{x}pt_scale": (getattr(cache, f"{x}pt_scale"), f32,
                             (*lead, nb, r)),
            f"{x}qt_scale": (getattr(cache, f"{x}qt_scale"), f32,
                             (*lead, r, nb)),
        })
    check_operands(cache.k_resid.device, expect)
    ptrs = []
    for x in ("k", "v"):
        ptrs += [expect[f"{x}{f}"][0].data_ptr() for f in (
            "_resid", "_codes", "_scale", "_mn", "_out_idx", "_out_val",
            "_out_bnd", "pt", "qt", "pt_scale", "qt_scale")]
        ptrs.append(starts[x].data_ptr() if x in starts else 0)
    return ptrs + [b, h, d, g, t, cache.comp_len, spec.bits,
                   spec.outliers_per_block, ks, r, spec.rank,
                   spec.rank_v_eff, spec.lowrank_loop, spec.v_group,
                   int(lowrank), int(spec.base_bits == 8)]


def flush(spec: kvcache.CacheSpec, cache: kvcache.LayerCache, p0=None,
          generator: torch.Generator | None = None,
          use_lowrank: bool = True) -> None:
    """:func:`flush_plain`'s writes as one launch of the kernel, in place
    on the current stream of the cache's CUDA device. Leaves the lengths to
    the caller."""
    dev = cache.k_resid.device
    if route(dev) != "kernel":
        raise ValueError(f"the flush kernel runs on a CUDA device, not {dev}")
    check_spec(spec)
    lowrank_on = use_lowrank and max(spec.rank, spec.rank_v_eff) > 0
    starts = _starts(spec, dev, p0, generator) if lowrank_on else {}
    args = launch_args(spec, cache, starts, lowrank_on)
    lib = _build.library()
    err = lib.gear_flush(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gear_flush")
    flush.launches += 1


flush.launches = 0
