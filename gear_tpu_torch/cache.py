"""Two-tier compressed KV cache, PyTorch port of ``gear_tpu/cache.py``.

A packed, quantized prefix (K per-channel over ``group``-token blocks, V per
token over ``v_group`` channels, both byte-strided along the head dim and
stored word-major transposed ``[D/fpi, T]``) plus a residual tier of up to
``group`` uncompressed tokens, flushed through quantize + pack + low-rank
error bases when full. The layout is the JAX package's, field for field, so
state carries across one to one (``gear_tpu_torch.convert``).

What differs from the JAX package:

  * In-place updates. ``prefill`` allocates a cache; ``append`` (and its
    flush) write into the preallocated tensors of the cache it is given and
    return that same object. This takes the place of JAX's purity plus
    buffer donation.
  * Lengths are host integers, which every row shares (``comp_len`` /
    ``resid_len`` / ``prefill_len``, scalars in the JAX cache): the flush
    is a Python ``if`` on them instead of ``lax.cond``, and no step syncs
    to read them. What a decode step launches reads a copy staged in
    device memory before it (:class:`StepLens`), so that a CUDA graph
    replays the launches with each step's; :func:`advance` moves the host
    integers on after the step.
  * Randomness. The power-iteration init comes from an optional provider
    ``p0(which, shape) -> Tensor`` (``which`` is ``"k"`` or ``"v"``), else
    uniform [0, 1) draws from a ``torch.Generator``.

  * Outlier selection breaks ties on the index explicitly (a stable sort:
    the lower index first, as ``jax.lax.top_k`` does), and duplicates between
    the largest and the smallest set are found by comparing the two sets,
    not with a [KO, KO] mask; the outputs are the reference's.

The whole GEAR recipe is here: group quantization, COO outliers
(``outliers_per_block``), low-rank error bases in bf16 or int8
(``base_bits``), whole-span K scales for the prefill (``kcvt_prefill``), the
sliding-window mask in :func:`attend`, and the partial-state attention
(:func:`attend_partial`, :func:`merge_partials`) for sequence-sharded decode.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import profiling
from .core import lowrank, outliers, quant

P0Fn = Callable[[str, tuple], torch.Tensor]


@dataclass(frozen=True)
class CacheSpec:
    """Static description of one layer's compressed cache."""

    batch: int
    num_kv_heads: int
    head_dim: int
    max_len: int          # capacity in tokens; multiple of group
    bits: int = 4         # 2 | 4 | 8
    group: int = 64       # time-group for K == residual length
    rank: int = 2         # decode-flush rank for the low-rank error bases
    prefill_rank: int = 4
    rank_v: int = -1      # V-side ranks; -1 = same as K
    prefill_rank_v: int = -1
    lowrank_loop: int = 3
    base_bits: int = 16   # 16 = P/Q bases in the cache dtype; 8 = int8
                          # codes with f32 scales per (block, rank)
    outliers_per_block: int = 0
                          # exact entries kept per (head, quant block) per
                          # tensor, half largest / half smallest by value,
                          # as fixed-size COO (flat index + delta); 0 = GEARL
    kcvt_prefill: bool = False
                          # quantize the prefill's K with one per-channel
                          # min/max over the whole prompt, stored replicated
                          # over its block rows; flushed blocks keep their own
    v_group_size: int = 0  # V quant group along the head dim; 0 = min(group, D)
    dtype: torch.dtype = torch.bfloat16
    sideband_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.max_len % self.group != 0:
            raise ValueError("max_len must be a multiple of group")
        if self.v_group_size and self.head_dim % self.v_group_size:
            raise ValueError("head_dim must be a multiple of v_group_size")
        if 32 % self.bits != 0:
            raise ValueError("bits must divide 32")
        if self.group % (32 // self.bits) != 0:
            raise ValueError("group must be a multiple of feats-per-int32")
        if self.base_bits not in (8, 16):
            raise ValueError("base_bits must be 8 or 16")
        if self.outliers_per_block < 0 or self.outliers_per_block % 2:
            raise ValueError("outliers_per_block must be even and >= 0")
        if self.outliers_per_block > self.group * self.head_dim // 2:
            raise ValueError("outliers_per_block too large")
        if self.outliers_per_block and self.group * self.head_dim > 65536:
            raise ValueError(
                "outlier indices are 16-bit (packed 2/int32): "
                "group * head_dim must be <= 65536")

    @property
    def fpi(self) -> int:
        return 32 // self.bits

    @property
    def n_blocks(self) -> int:
        return self.max_len // self.group

    @property
    def v_group(self) -> int:
        return self.v_group_size or min(self.group, self.head_dim)

    @property
    def v_groups_per_token(self) -> int:
        return self.head_dim // self.v_group

    @property
    def rank_v_eff(self) -> int:
        return self.rank if self.rank_v < 0 else self.rank_v

    @property
    def prefill_rank_v_eff(self) -> int:
        return self.prefill_rank if self.prefill_rank_v < 0 \
            else self.prefill_rank_v

    @property
    def ko_store(self) -> int:
        """Stored outlier entries per block: ``outliers_per_block`` rounded
        up to a multiple of 128 when head_dim == 128 (the reference's
        layout, kept for state parity). Padding entries are (idx 0, delta
        0): adding them changes nothing."""
        ko = self.outliers_per_block
        if ko and self.head_dim == 128:
            return -(-ko // 128) * 128
        return ko

    @property
    def base_dtype(self) -> torch.dtype:
        return torch.int8 if self.base_bits == 8 else self.dtype

    @property
    def bnd_lanes(self) -> int:
        return 128 if self.outliers_per_block else 0

    @property
    def r_store(self) -> int:
        return max(self.rank, self.prefill_rank, self.rank_v_eff,
                   self.prefill_rank_v_eff, 1)

    @property
    def k_words(self) -> int:
        return self.max_len // self.fpi

    @property
    def v_words(self) -> int:
        return self.head_dim // self.fpi

    def bytes_compressed(self) -> int:
        """Device bytes of one layer's cache at full capacity (for reporting)."""
        b, h, d, t = self.batch, self.num_kv_heads, self.head_dim, self.max_len
        el = self.sideband_dtype.itemsize
        total = 2 * b * h * t * self.v_words * 4          # K and V codes
        total += 2 * b * h * d * self.n_blocks * el        # K scale + mn
        total += 2 * b * h * t * self.v_groups_per_token * el  # V scale + mn
        total += 2 * b * h * self.group * d * self.dtype.itemsize  # residual
        base_el = 1 if self.base_bits == 8 else 2
        total += 2 * b * h * self.n_blocks * d * self.r_store * base_el
        total += 2 * b * h * t * self.r_store * base_el
        if self.base_bits == 8:  # f32 scales per (block, rank)
            total += 4 * b * h * self.n_blocks * self.r_store * 4
        ko = self.ko_store
        if ko:  # COO outliers: 16-bit index + delta, per tensor
            total += 2 * b * h * self.n_blocks * ko * (
                2 + self.dtype.itemsize)
        return total

    def bytes_fp16_baseline(self) -> int:
        b, h, d, t = self.batch, self.num_kv_heads, self.head_dim, self.max_len
        return 2 * b * h * t * d * 2


TENSOR_FIELDS = (
    "k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
    "k_resid", "v_resid", "kpt", "kqt", "vpt", "vqt",
    "k_out_idx", "k_out_val", "v_out_idx", "v_out_val",
    "k_out_bnd", "v_out_bnd",
    "kpt_scale", "kqt_scale", "vpt_scale", "vqt_scale",
)
LENGTH_FIELDS = ("comp_len", "resid_len", "prefill_len")


@dataclass
class LayerCache:
    """One layer's compressed KV state (or, after :func:`stack_layers`, all
    layers' with a leading layer axis on every tensor). Shapes as in
    ``gear_tpu.cache.LayerCache``; lengths are host ints."""

    k_codes: torch.Tensor   # int32 [B, H, D // fpi, max_len]
    k_scale: torch.Tensor   # [B, H, n_blocks, D]
    k_mn: torch.Tensor      # [B, H, n_blocks, D]
    v_codes: torch.Tensor   # int32 [B, H, D // fpi, max_len]
    v_scale: torch.Tensor   # [B, H, v_groups_per_token, max_len]
    v_mn: torch.Tensor      # [B, H, v_groups_per_token, max_len]
    k_resid: torch.Tensor   # [B, H, group, D]
    v_resid: torch.Tensor   # [B, H, group, D]
    kpt: torch.Tensor       # [B, H, n_blocks, r_store, D] (int8 at base_bits 8)
    kqt: torch.Tensor       # [B, H, r_store, max_len]
    vpt: torch.Tensor       # [B, H, n_blocks, r_store, D]
    vqt: torch.Tensor       # [B, H, r_store, max_len]
    # COO outliers per quant block: flat idx = t_loc * D + d, two 16-bit
    # indices per int32 word (word j = idx[j] | idx[j + KO/2] << 16), values
    # are deltas (exact - dequantized); entries sorted by token (K) or by
    # channel (V), bnd[..., t] = (entries with key <= t) - 1.
    k_out_idx: torch.Tensor  # int32 [B, H, n_blocks, ko_store // 2]
    k_out_val: torch.Tensor  # [B, H, n_blocks, ko_store]
    v_out_idx: torch.Tensor
    v_out_val: torch.Tensor
    k_out_bnd: torch.Tensor  # int32 [B, H, n_blocks, 128] (0 wide: no outliers)
    v_out_bnd: torch.Tensor
    kpt_scale: torch.Tensor  # f32 [B, H, n_blocks, r_store] (ones at 16 bits)
    kqt_scale: torch.Tensor  # f32 [B, H, r_store, n_blocks]
    vpt_scale: torch.Tensor
    vqt_scale: torch.Tensor
    comp_len: int = 0
    resid_len: int = 0
    prefill_len: int = 0

    @property
    def total_len(self) -> int:
        return self.comp_len + self.resid_len

    def layer(self, i: int) -> "LayerCache":
        """Layer ``i`` of a stacked cache, as views: in-place updates of the
        returned cache write into the stack."""
        return LayerCache(**{f: getattr(self, f)[i] for f in TENSOR_FIELDS},
                          comp_len=self.comp_len, resid_len=self.resid_len,
                          prefill_len=self.prefill_len)

    def set_lengths(self, other: "LayerCache") -> None:
        for f in LENGTH_FIELDS:
            setattr(self, f, getattr(other, f))


class StepLens:
    """One decode step's lengths in device memory, one buffer of three
    int64 words (zeros until :meth:`stage` writes them). Every launch of a
    step reads its lengths here and none holds one, so that a CUDA graph
    replays the step with each step's.

    ``index``: int64 [1], the slot the step's append writes: the residual
    tier's ``resid_len``, or the raw cache's ``length``, before the step.
    ``lens``: int32 [3], ``comp_len``, ``resid_len`` and ``prefill_len``
    after the append (and its flush); for the raw cache its ``length``
    first. ``window_lo``: int32 [1], the total length after the append less
    the sliding window: the first position the window keeps.
    """

    def __init__(self, device=None):
        self.meta = torch.zeros(3, dtype=torch.int64, device=device)
        m32 = self.meta.view(torch.int32)
        self.index, self.lens, self.window_lo = (self.meta[:1], m32[2:5],
                                                 m32[5:6])

    @staticmethod
    def stage(spec: CacheSpec, cache, window: int | None,
              into: "StepLens | None" = None, *, new: int = 1) -> "StepLens":
        """The lengths of a step that appends ``new`` tokens (0: attends
        the cache as it stands) to ``cache``, a :class:`LayerCache` or
        ``models.llama``'s raw cache, from its host integers, checked here;
        written into ``into`` (a graph's buffer) or a new buffer on the
        cache's device in one copy from pinned host memory on the current
        stream (the caching host allocator keeps the staging block until
        the copy is done)."""
        g = spec.group
        if isinstance(cache, LayerCache):
            c0, n, pre = cache.comp_len, cache.resid_len, cache.prefill_len
            lens = ((c0 + g, 0, pre) if new and n + new == g   # a flush
                    else (c0, n + new, pre))
            ok = c0 % g == pre % g == 0 and 0 <= pre <= c0 and n + new <= g
            device = cache.k_resid.device
        else:
            n = cache.length
            lens, ok, device = (n + new, 0, 0), True, cache.k.device
        if not (ok and 0 <= min(lens[:2]) and lens[0] <= spec.max_len):
            raise ValueError(f"lengths {lens} after {new} appended token(s) "
                             f"do not fit a cache of {spec.max_len}")
        into = StepLens(device) if into is None else into
        lo = 0 if window is None else lens[0] + lens[1] - window
        host = torch.empty(3, dtype=torch.int64, pin_memory=into.meta.is_cuda)
        h = host.numpy()
        h[0] = n
        h.view(np.int32)[2:] = (*lens, lo)
        into.meta.copy_(host, non_blocking=True)
        return into

    def host_view(self, cache):
        """``cache`` (a :class:`LayerCache` or ``models.llama``'s raw cache)
        with the lengths read back from device memory: the CPU's path."""
        comp, resid, prefill = self.lens.tolist()
        if isinstance(cache, LayerCache):
            return dataclasses.replace(cache, comp_len=comp, resid_len=resid,
                                       prefill_len=prefill)
        return dataclasses.replace(cache, length=comp)


def advance(spec: CacheSpec, caches) -> None:
    """The host lengths of ``caches`` (compressed or raw) after a decode
    step's append of one token, and its flush where the residual tier
    fills: what :meth:`StepLens.stage` staged for the step."""
    if isinstance(caches, LayerCache):
        caches.resid_len += 1
        if caches.resid_len == spec.group:
            caches.comp_len += spec.group
            caches.resid_len = 0
    else:
        caches.length += 1


def init_layer_cache(spec: CacheSpec, device=None) -> LayerCache:
    b, h, d = spec.batch, spec.num_kv_heads, spec.head_dim
    nb, t, r = spec.n_blocks, spec.max_len, spec.r_store
    sb, dt, bdt = spec.sideband_dtype, spec.dtype, spec.base_dtype

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return LayerCache(
        k_codes=z((b, h, spec.v_words, t), torch.int32),
        k_scale=z((b, h, nb, d), sb),
        k_mn=z((b, h, nb, d), sb),
        v_codes=z((b, h, spec.v_words, t), torch.int32),
        v_scale=z((b, h, spec.v_groups_per_token, t), sb),
        v_mn=z((b, h, spec.v_groups_per_token, t), sb),
        k_resid=z((b, h, spec.group, d), dt),
        v_resid=z((b, h, spec.group, d), dt),
        kpt=z((b, h, nb, r, d), bdt),
        kqt=z((b, h, r, t), bdt),
        vpt=z((b, h, nb, r, d), bdt),
        vqt=z((b, h, r, t), bdt),
        k_out_idx=z((b, h, nb, spec.ko_store // 2), torch.int32),
        k_out_val=z((b, h, nb, spec.ko_store), dt),
        v_out_idx=z((b, h, nb, spec.ko_store // 2), torch.int32),
        v_out_val=z((b, h, nb, spec.ko_store), dt),
        k_out_bnd=z((b, h, nb, spec.bnd_lanes), torch.int32),
        v_out_bnd=z((b, h, nb, spec.bnd_lanes), torch.int32),
        kpt_scale=ones((b, h, nb, r)),
        kqt_scale=ones((b, h, r, nb)),
        vpt_scale=ones((b, h, nb, r)),
        vqt_scale=ones((b, h, r, nb)),
    )


# ---------------------------------------------------------------------------
# COO outliers of a block of tokens.
# ---------------------------------------------------------------------------

def _extract_outliers(spec: CacheSpec, x: torch.Tensor):
    """Pull the per-block largest/smallest entries out of a block [B,H,S,D].

    ``outliers_per_block`` entries per (head, quant block), half largest /
    half smallest by value (ties: the lower index first), are replaced by
    the block mean before quantization; their exact values are kept aside.

    Returns (x_cleaned f32 [B,H,S,D], idx int64 [B,H,NBs,ko_store] flat block
    indices ``t_loc * D + d``, val f32, is_dup bool). A duplicate is an entry
    of the smallest set whose position is also in the largest set (heavy
    ties only); duplicates and the padding up to ``ko_store`` carry delta 0
    downstream, so the scatter-add restore never counts a position twice.
    """
    ko = spec.outliers_per_block
    b, h, s_len, d = x.shape
    g = spec.group
    nbs = s_len // g
    xf = x.float().reshape(b, h, nbs, g * d)
    top_v, top_i = outliers.top_k_stable(xf, ko // 2)
    bot_nv, bot_i = outliers.top_k_stable(-xf, ko // 2)
    idx = torch.cat([top_i, bot_i], dim=-1)
    val = torch.cat([top_v, -bot_nv], dim=-1)
    mean = xf.mean(dim=-1, keepdim=True)
    dup_bot = (bot_i[..., :, None] == top_i[..., None, :]).any(dim=-1)
    is_dup = torch.cat([torch.zeros_like(dup_bot), dup_bot], dim=-1)
    cleaned = xf.scatter(-1, idx, mean.expand(idx.shape))
    pad = spec.ko_store - ko
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        val = torch.nn.functional.pad(val, (0, pad))
        is_dup = torch.cat(
            [is_dup, is_dup.new_ones((*is_dup.shape[:-1], pad))], dim=-1)
    return cleaned.reshape(b, h, s_len, d), idx, val, is_dup


def _no_outliers(spec: CacheSpec, x: torch.Tensor):
    """Zero-size outlier index and value of a block with none."""
    b, h, s_len, _ = x.shape
    shape = (b, h, s_len // spec.group, spec.ko_store)
    return (torch.zeros(shape, dtype=torch.int64, device=x.device),
            torch.zeros(shape, dtype=spec.dtype, device=x.device))


def _sort_outliers(spec: CacheSpec, o_idx: torch.Tensor, o_val: torch.Tensor,
                   key_mode: str):
    """Sort each block's COO outliers by token (K) or channel (V), stably,
    and build the boundary table ``bnd[..., t] = (entries with key <= t) -
    1``: token or channel ``t`` owns the entries ``bnd[t-1]+1 .. bnd[t]``.

    Returns (packed idx int32 [..., KO//2], val [..., KO], bnd int32
    [..., 128]); all three zero-size without outliers.
    """
    if spec.outliers_per_block == 0:
        bnd = torch.zeros(o_idx.shape[:-1] + (0,), dtype=torch.int32,
                          device=o_idx.device)
        return _pack_oidx(o_idx), o_val, bnd
    d = spec.head_dim
    key_range = spec.group if key_mode == "token" else spec.head_dim
    if key_range > 128:
        raise ValueError(
            f"sorted-outlier boundary table needs {key_mode} key range "
            f"{key_range} <= 128; use group/head_dim <= 128 or no outliers")
    key = o_idx // d if key_mode == "token" else o_idx % d
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    idx_s = torch.gather(o_idx, -1, perm)
    val_s = torch.gather(o_val, -1, perm)
    t = torch.arange(128, device=key.device).expand(*key.shape[:-1], 128)
    bnd = torch.searchsorted(key_s.contiguous(), t.contiguous(),
                             right=True) - 1
    return _pack_oidx(idx_s), val_s, bnd.to(torch.int32)


def _pack_oidx(idx: torch.Tensor) -> torch.Tensor:
    """[..., KO] indices -> int32 [..., KO//2], 16-bit pairs per word
    (word j = idx[j] | idx[j + KO/2] << 16)."""
    ko = idx.shape[-1]
    idx = idx.to(torch.int64)
    return quant._to_int32_bits(idx[..., :ko // 2] | (idx[..., ko // 2:] << 16))


def _unpack_oidx(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_oidx`: int32 [..., KO//2] -> int64 [..., KO]."""
    w = packed.to(torch.int64) & 0xFFFFFFFF
    return torch.cat([w & 0xFFFF, w >> 16], dim=-1)


def _restore_outliers(spec: CacheSpec, x: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """Add the outlier deltas back into a dequantized block [B,H,S,D] f32.
    ``idx`` is packed ([B,H,NBs,KO//2]); ``val`` holds deltas [B,H,NBs,KO].
    At most one entry per position is non-zero, so the order of the adds
    does not matter."""
    b, h, s_len, d = x.shape
    nbs = s_len // spec.group
    xf = x.float().reshape(b, h, nbs, spec.group * d)
    out = xf.scatter_add(-1, _unpack_oidx(idx), val.float())
    return out.reshape(b, h, s_len, d)


def _deq_at(spec: CacheSpec, x, scale_q, mn_q, scale_s, mn_s):
    """Quantize-dequantize single positions: the code comes from the f32
    sidebands the packed codes used (``*_q``), the value from the stored,
    sideband-cast ones (``*_s``)."""
    levels = (1 << spec.bits) - 1
    safe = torch.where(scale_q == 0.0, torch.ones_like(scale_q), scale_q)
    code = torch.clamp(torch.round((x - mn_q) / safe), 0, levels)
    return code * scale_s + mn_s


def _take_outliers(spec: CacheSpec, x: torch.Tensor):
    """(block to quantize, idx, exact values, is_dup) of a block [B,H,S,D]:
    :func:`_extract_outliers`, or the block itself with zero-size entries."""
    if spec.outliers_per_block:
        return _extract_outliers(spec, x)
    o_idx, o_val = _no_outliers(spec, x)
    return x, o_idx, o_val, None


def _outlier_deltas(spec: CacheSpec, x_clean, o_idx, o_exact, o_dup,
                    side_idx, scale_q, mn_q, scale_s, mn_s) -> torch.Tensor:
    """Deltas ``exact - dequantized`` at the outlier positions of each block.

    ``x_clean`` [B,H,NBs,G*D] f32 is the cleaned block (None without
    outliers), ``side_idx`` names,
    per entry of ``o_idx``, its sideband among the block's [B,H,NBs,n]
    sidebands: the f32 ones the codes used (``*_q``) and the stored,
    sideband-cast ones (``*_s``), so that the restore reproduces the exact
    value up to one rounding. Duplicates and padding get 0. Without outliers
    the zero-size ``o_exact`` comes back."""
    if not spec.outliers_per_block:
        return o_exact

    def gat(a):
        return torch.gather(a.float(), -1, side_idx)

    at = _deq_at(spec, torch.gather(x_clean, -1, o_idx), gat(scale_q),
                 gat(mn_q), gat(scale_s), gat(mn_s))
    return torch.where(o_dup, torch.zeros_like(o_exact),
                       o_exact - at).to(spec.dtype)


# ---------------------------------------------------------------------------
# Compression of a block of tokens (prefill or residual flush).
# ---------------------------------------------------------------------------

def _compress_k_block(spec: CacheSpec, k: torch.Tensor,
                      whole_span: bool = False):
    """K block [B,H,S,D] -> per-channel quant over ``group``-token windows
    (or, with ``whole_span``, one min/max over all S tokens, replicated per
    block row: the KCVT grouping), codes packed along the head dim and
    stored transposed.

    Returns (packed int32 [B,H,WD,S], scale/mn [B,H,S//group,D] sideband,
    outlier idx [B,H,S//group,KO//2], val [.., KO], bnd [.., 128]).
    """
    b, h, s_len, d = k.shape
    g = spec.group
    nbs = s_len // g
    k, o_idx, o_exact, o_dup = _take_outliers(spec, k)
    levels = (1 << spec.bits) - 1
    kg = k.float().reshape(b, h, nbs, g, d)
    if whole_span:
        mn = kg.amin(dim=(2, 3))[:, :, None].expand(b, h, nbs, d)
        mx = kg.amax(dim=(2, 3))[:, :, None].expand(b, h, nbs, d)
    else:
        mn = kg.amin(dim=3)
        mx = kg.amax(dim=3)
    scale = (mx - mn) * (1.0 / levels)  # as jitted XLA computes it
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.clamp(
        torch.round((kg - mn[:, :, :, None]) / safe[:, :, :, None]), 0, levels
    ).to(torch.int32).reshape(b, h, s_len, d)
    scale_s = scale.to(spec.sideband_dtype)
    mn_s = mn.to(spec.sideband_dtype)
    o_val = _outlier_deltas(spec, kg.reshape(b, h, nbs, g * d), o_idx,
                            o_exact, o_dup, o_idx % d, scale, mn, scale_s,
                            mn_s)
    packed = quant.pack_codes_bytestrided(codes, spec.bits).transpose(-1, -2)
    return (packed, scale_s, mn_s,
            *_sort_outliers(spec, o_idx, o_val, "token"))


def _v_outlier_deltas(spec: CacheSpec, v_clean, o_idx, o_exact, o_dup,
                      scale, mn, scale_s, mn_s) -> torch.Tensor:
    """:func:`_outlier_deltas` for a V block [B,H,S,D] with token-major
    sidebands [B,H,S,D//v_group]."""
    b, h, s_len, d = v_clean.shape
    g, ngv = spec.group, spec.v_groups_per_token
    nbs = s_len // g

    def blocks(a):
        return a.reshape(b, h, nbs, g * ngv)

    side_idx = (o_idx // d) * ngv + (o_idx % d) // spec.v_group
    return _outlier_deltas(spec, v_clean.reshape(b, h, nbs, g * d), o_idx,
                           o_exact, o_dup, side_idx, blocks(scale),
                           blocks(mn), blocks(scale_s), blocks(mn_s))


def _compress_v_block(spec: CacheSpec, v: torch.Tensor):
    """V block [B,H,S,D] -> per-token codes packed along the head dim,
    stored word-major transposed.

    Returns (packed int32 [B,H,D//fpi,S], scale/mn [B,H,D//v_group,S],
    outlier idx, val, bnd).
    """
    v, o_idx, o_exact, o_dup = _take_outliers(spec, v)
    vf = v.float()
    codes, scale, mn = quant.quantize_groups(vf, spec.bits, spec.v_group)
    scale_s = scale.to(spec.sideband_dtype)
    mn_s = mn.to(spec.sideband_dtype)
    o_val = _v_outlier_deltas(spec, vf, o_idx, o_exact, o_dup, scale, mn,
                              scale_s, mn_s)
    packed = quant.pack_codes_bytestrided(codes, spec.bits).transpose(-1, -2)
    return (packed, scale_s.transpose(-1, -2), mn_s.transpose(-1, -2),
            *_sort_outliers(spec, o_idx, o_val, "channel"))


def _compress_k_block_pk(spec: CacheSpec, k: torch.Tensor):
    """:func:`_compress_k_block` through the fused pack kernel
    (``kernels.pack.quant_pack_channels``): one read of the block emits the
    packed words and sidebands. The kernel reads the block in the type and
    layout it has: the model's bf16 K (a strided view) without outliers,
    the cleaned float32 block with them. Used by :func:`prefill` on the
    card."""
    from .kernels import pack as packk

    b, h, s_len, d = k.shape
    g = spec.group
    nbs = s_len // g
    k, o_idx, o_exact, o_dup = _take_outliers(spec, k)
    if k.dtype not in (torch.float32, torch.bfloat16):
        k = k.float()
    words, scale, mn = packk.quant_pack_channels(k, bits=spec.bits, group=g)
    packed = words.reshape(b, h, s_len, spec.v_words).transpose(-1, -2)
    scale = scale.reshape(b, h, nbs, d)  # f32: what the codes used
    mn = mn.reshape(b, h, nbs, d)
    scale_s = scale.to(spec.sideband_dtype)
    mn_s = mn.to(spec.sideband_dtype)
    x_clean = (k.float().reshape(b, h, nbs, g * d)
               if spec.outliers_per_block else None)
    o_val = _outlier_deltas(spec, x_clean, o_idx, o_exact, o_dup, o_idx % d,
                            scale, mn, scale_s, mn_s)
    return (packed, scale_s, mn_s,
            *_sort_outliers(spec, o_idx, o_val, "token"))


def _compress_v_block_pk(spec: CacheSpec, v: torch.Tensor):
    """:func:`_compress_v_block` through the fused pack kernel
    (``kernels.pack.quant_pack_tokens``), which reads the block in the type
    it has: the model's bf16 without outliers, the cleaned float32 block
    with them."""
    from .kernels import pack as packk

    b, h, s_len, d = v.shape
    ngv = spec.v_groups_per_token
    v, o_idx, o_exact, o_dup = _take_outliers(spec, v)
    if v.dtype not in (torch.float32, torch.bfloat16):
        v = v.float()
    xf = v.reshape(b * h, s_len, d).contiguous()
    words, scale, mn = packk.quant_pack_tokens(xf, bits=spec.bits,
                                               v_group=spec.v_group)
    packed = words.reshape(b, h, s_len, spec.v_words).transpose(-1, -2)
    scale = scale.reshape(b, h, s_len, ngv)  # token-major f32
    mn = mn.reshape(b, h, s_len, ngv)
    scale_s = scale.to(spec.sideband_dtype)
    mn_s = mn.to(spec.sideband_dtype)
    o_val = _v_outlier_deltas(spec, xf.reshape(b, h, s_len, d), o_idx,
                              o_exact, o_dup, scale, mn, scale_s, mn_s)
    return (packed, scale_s.transpose(-1, -2), mn_s.transpose(-1, -2),
            *_sort_outliers(spec, o_idx, o_val, "channel"))


def _dequant_k_block(spec: CacheSpec, packed, scale, mn, o_idx=None,
                     o_val=None) -> torch.Tensor:
    """Inverse of :func:`_compress_k_block` -> [B,H,S,D] f32 (outlier deltas
    added back when given)."""
    b, h, _, s_len = packed.shape
    nbs = s_len // spec.group
    codes = quant.unpack_codes_bytestrided(packed.transpose(-1, -2), spec.bits)
    d = codes.shape[-1]
    cg = codes.float().reshape(b, h, nbs, spec.group, d)
    x = cg * scale.float()[:, :, :, None] + mn.float()[:, :, :, None]
    x = x.reshape(b, h, s_len, d)
    if spec.outliers_per_block and o_idx is not None:
        x = _restore_outliers(spec, x, o_idx, o_val)
    return x


def _dequant_v_block(spec: CacheSpec, packed, scale, mn, o_idx=None,
                     o_val=None) -> torch.Tensor:
    """Inverse of :func:`_compress_v_block` -> [B,H,S,D] f32."""
    codes = quant.unpack_codes_bytestrided(packed.transpose(-1, -2), spec.bits)
    x = quant.dequantize_groups(codes, scale.transpose(-1, -2).float(),
                                mn.transpose(-1, -2).float(), spec.v_group)
    if spec.outliers_per_block and o_idx is not None:
        x = _restore_outliers(spec, x, o_idx, o_val)
    return x


def _quantize_bases(p: torch.Tensor, qt: torch.Tensor):
    """int8 symmetric absmax quantization of the bases, per rank column.

    p [..., D, R], qt [..., R, S] f32 -> (p8 int8, qt8 int8, p_scale f32
    [..., R], qt_scale f32 [..., R]); dequant is ``code * scale``.
    """
    def quantize(x, dim):
        # "absmax / 127" as jitted XLA computes it: times f32(1 / 127)
        absmax = x.abs().amax(dim=dim, keepdim=True)
        scale = absmax.clamp_min(1e-12) * (1 / 127.0)
        codes = torch.clamp(torch.round(x / scale), -127, 127)
        return codes.to(torch.int8), scale

    p8, p_scale = quantize(p, -2)      # over D
    qt8, qt_scale = quantize(qt, -1)   # over S
    return p8, qt8, p_scale[..., 0, :], qt_scale[..., 0]


def _error_bases(spec: CacheSpec, x, x_hat, rank: int, which: str,
                 p0: P0Fn | None, generator: torch.Generator | None):
    """Low-rank bases of the quantization error, zero-padded to r_store.

    x, x_hat: [B,H,S,D]. Returns (P [B,H,D,r_store], Qt [B,H,r_store,S],
    P scale [B,H,r_store], Qt scale [B,H,r_store]): bases in the cache dtype
    with scales of one, or int8 codes with their f32 scales (base_bits 8).
    """
    err = x.float() - x_hat.float()
    b, h, s, d = x.shape
    if rank <= 0:  # one side of an asymmetric rank/rank_v config may be 0
        p = err.new_zeros((b, h, d, spec.r_store))
        q = err.new_zeros((b, h, s, spec.r_store))
    else:
        init = p0(which, (b, h, d, rank)) if p0 is not None else None
        p, q = lowrank.power_iterate(err, rank, spec.lowrank_loop, p0=init,
                                     generator=generator)
        pad = spec.r_store - rank
        if pad:
            p = torch.nn.functional.pad(p, (0, pad))
            q = torch.nn.functional.pad(q, (0, pad))
    qt = q.transpose(-1, -2)
    if spec.base_bits == 8:
        return _quantize_bases(p, qt)
    ones = err.new_ones((b, h, spec.r_store))
    return p.to(spec.dtype), qt.to(spec.dtype), ones, ones


def prefill(spec: CacheSpec, k: torch.Tensor, v: torch.Tensor, *,
            p0: P0Fn | None = None,
            generator: torch.Generator | None = None,
            use_lowrank: bool = True) -> LayerCache:
    """Build a LayerCache from prefill K/V [B,H,S,D] (S <= max_len).

    The first ``(S // group) * group`` tokens are compressed as one prefill
    block at ``prefill_rank``; the remainder seeds the residual tier.
    On CUDA tensors the block quantize + pack runs through the fused pack
    kernels (bit-identical formulas); on the CPU through the plain ones.
    Under ``kcvt_prefill`` K's sidebands come from one reduction over the
    whole prompt, which the pack kernel's per-group min/max does not
    compute: K then takes the plain path on either device.
    ``use_lowrank=False`` leaves the error bases zero.
    """
    b, h, s, d = k.shape
    g = spec.group
    n_full = (s // g) * g
    cache = init_layer_cache(spec, device=k.device)

    if n_full:
        kb, vb = k[:, :, :n_full], v[:, :, :n_full]
        c_k = _compress_k_block_pk if k.is_cuda else _compress_k_block
        c_v = _compress_v_block_pk if k.is_cuda else _compress_v_block
        if spec.kcvt_prefill:
            k_pack, k_scale, k_mn, ko_i, ko_v, ko_b = _compress_k_block(
                spec, kb, whole_span=True)
        else:
            k_pack, k_scale, k_mn, ko_i, ko_v, ko_b = c_k(spec, kb)
        v_pack, v_scale, v_mn, vo_i, vo_v, vo_b = c_v(spec, vb)
        nbs = n_full // g
        cache.k_codes[:, :, :, :n_full] = k_pack
        cache.k_scale[:, :, :nbs] = k_scale
        cache.k_mn[:, :, :nbs] = k_mn
        cache.v_codes[:, :, :, :n_full] = v_pack
        cache.v_scale[:, :, :, :n_full] = v_scale
        cache.v_mn[:, :, :, :n_full] = v_mn
        cache.comp_len = n_full
        cache.prefill_len = n_full
        if spec.outliers_per_block:
            cache.k_out_idx[:, :, :nbs] = ko_i
            cache.k_out_val[:, :, :nbs] = ko_v
            cache.v_out_idx[:, :, :nbs] = vo_i
            cache.v_out_val[:, :, :nbs] = vo_v
            cache.k_out_bnd[:, :, :nbs] = ko_b
            cache.v_out_bnd[:, :, :nbs] = vo_b
        if use_lowrank and max(spec.prefill_rank,
                               spec.prefill_rank_v_eff) > 0:
            k_hat = _dequant_k_block(spec, k_pack, k_scale, k_mn, ko_i, ko_v)
            v_hat = _dequant_v_block(spec, v_pack, v_scale, v_mn, vo_i, vo_v)
            kp, kqt, kps, kqs = _error_bases(
                spec, kb, k_hat, spec.prefill_rank, "k", p0, generator)
            vp, vqt, vps, vqs = _error_bases(
                spec, vb, v_hat, spec.prefill_rank_v_eff, "v", p0, generator)
            # the prefill P (and its scales) is replicated across its blocks
            cache.kpt[:, :, :nbs] = kp.transpose(-1, -2)[:, :, None]
            cache.kqt[:, :, :, :n_full] = kqt
            cache.vpt[:, :, :nbs] = vp.transpose(-1, -2)[:, :, None]
            cache.vqt[:, :, :, :n_full] = vqt
            cache.kpt_scale[:, :, :nbs] = kps[:, :, None]
            cache.kqt_scale[:, :, :, :nbs] = kqs[:, :, :, None]
            cache.vpt_scale[:, :, :nbs] = vps[:, :, None]
            cache.vqt_scale[:, :, :, :nbs] = vqs[:, :, :, None]

    tail = s - n_full
    if tail:
        cache.k_resid[:, :, :tail] = k[:, :, n_full:]
        cache.v_resid[:, :, :tail] = v[:, :, n_full:]
        cache.resid_len = tail
    return cache


def _flush(spec: CacheSpec, cache: LayerCache, p0: P0Fn | None,
           generator: torch.Generator | None,
           use_lowrank: bool = True) -> None:
    """Quantize the full residual tier into the packed prefix, in place:
    one launch of the flush kernel on the card, the plain path on the CPU
    (``kernels.flush.route``, which also labels the span)."""
    from .kernels import flush as flushk

    route = flushk.route(cache.k_resid.device)
    with profiling.span("cache.flush", comp_len=cache.comp_len, route=route):
        g = spec.group
        c0 = cache.comp_len
        if c0 + g > spec.max_len:
            raise ValueError(
                f"compressed cache full: flushing {g} tokens at comp_len {c0} "
                f"exceeds max_len {spec.max_len}")
        run = flushk.flush if route == "kernel" else flushk.flush_plain
        run(spec, cache, p0, generator, use_lowrank)
        cache.comp_len = c0 + g
        cache.resid_len = 0


def append(spec: CacheSpec, cache: LayerCache, k_new: torch.Tensor,
           v_new: torch.Tensor, *, p0: P0Fn | None = None,
           generator: torch.Generator | None = None,
           use_lowrank: bool = True,
           index: torch.Tensor | None = None) -> LayerCache:
    """Append one decode step's K/V [B,H,1,D] in place at the residual
    tier's slot ``index`` (int64 [1] in device memory, a step's
    ``StepLens.index``; None: ``resid_len``, the same slot); flush the tier
    into the packed prefix when the host lengths say it fills.

    ``p0`` is asked for the flush's power-iteration inits only when a flush
    happens. Raises ``ValueError`` when a flush would pass ``max_len`` (the
    JAX cache silently clamps there).
    """
    i = cache.resid_len
    with profiling.span("cache.append", resid_len=i):
        if index is None:
            index = torch.full((1,), i, dtype=torch.int64,
                               device=cache.k_resid.device)
        cache.k_resid.index_copy_(2, index, k_new.to(cache.k_resid.dtype))
        cache.v_resid.index_copy_(2, index, v_new.to(cache.v_resid.dtype))
        cache.resid_len = i + 1
        if cache.resid_len == spec.group:
            _flush(spec, cache, p0, generator, use_lowrank)
    return cache


def base_kpt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """Dequantized K low-rank P factor (transposed) [B,H,NB,R,D] f32."""
    kpt = cache.kpt.float()
    if spec.base_bits == 8:
        kpt = kpt * cache.kpt_scale[..., None]
    return kpt


def base_vpt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """Dequantized V low-rank P factor (transposed) [B,H,NB,R,D] f32."""
    vpt = cache.vpt.float()
    if spec.base_bits == 8:
        vpt = vpt * cache.vpt_scale[..., None]
    return vpt


def base_kqt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """Dequantized K low-rank Q factor (transposed) [B,H,R,T] f32."""
    kqt = cache.kqt.float()
    if spec.base_bits == 8:
        kqt = kqt * cache.kqt_scale.repeat_interleave(spec.group, dim=-1)
    return kqt


def base_vqt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """Dequantized V low-rank Q factor (transposed) [B,H,R,T] f32."""
    vqt = cache.vqt.float()
    if spec.base_bits == 8:
        vqt = vqt * cache.vqt_scale.repeat_interleave(spec.group, dim=-1)
    return vqt


# ---------------------------------------------------------------------------
# Attention against the compressed cache: the plain version of the decode
# kernel (kernels/decode.py), and the CPU path.
# ---------------------------------------------------------------------------

def _dequant_k(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    return _dequant_k_block(spec, cache.k_codes, cache.k_scale, cache.k_mn,
                            cache.k_out_idx, cache.k_out_val)


def _dequant_v(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    return _dequant_v_block(spec, cache.v_codes, cache.v_scale, cache.v_mn,
                            cache.v_out_idx, cache.v_out_val)


def dequantize_kv(spec: CacheSpec, cache: LayerCache):
    """The reconstructed prefix K/V [B,H,max_len,D] f32: dequantized codes
    plus outlier deltas plus the low-rank correction."""
    k = _dequant_k(spec, cache)
    v = _dequant_v(spec, cache)
    b, h = spec.batch, spec.num_kv_heads
    nb, g, r = spec.n_blocks, spec.group, spec.r_store
    kqt = base_kqt(spec, cache).reshape(b, h, r, nb, g)
    vqt = base_vqt(spec, cache).reshape(b, h, r, nb, g)
    k_corr = torch.einsum("bhrng,bhnrd->bhngd", kqt, base_kpt(spec, cache))
    v_corr = torch.einsum("bhrng,bhnrd->bhngd", vqt, base_vpt(spec, cache))
    return k + k_corr.reshape(k.shape), v + v_corr.reshape(v.shape)


def _scores(spec: CacheSpec, cache: LayerCache, qf: torch.Tensor,
            include_residual: bool) -> torch.Tensor:
    """Unscaled scores of qf [B,Hkv,Q,D] f32 against the prefix (with its
    low-rank correction) and, appended, the residual tier."""
    b, hkv, nq, _ = qf.shape
    t, nb, g, r = spec.max_len, spec.n_blocks, spec.group, spec.r_store
    scores = torch.einsum("bhqd,bhtd->bhqt", qf, _dequant_k(spec, cache))
    kqt = base_kqt(spec, cache).reshape(b, hkv, r, nb, g)
    qp = torch.einsum("bhqd,bhnrd->bhqnr", qf, base_kpt(spec, cache))
    scores = scores + torch.einsum("bhqnr,bhrng->bhqng", qp, kqt).reshape(
        b, hkv, nq, t)
    if include_residual:
        scores_res = torch.einsum("bhqd,bhrd->bhqr", qf,
                                  cache.k_resid.float())
        scores = torch.cat([scores, scores_res], dim=-1)
    return scores


def _valid(spec: CacheSpec, cache: LayerCache, n_ext: int, device,
           pad_start, token_offset=0) -> torch.Tensor:
    """Mask [B or 1, 1, 1, max_len + n_ext] of the live cache slots."""
    t = spec.max_len
    pos = torch.arange(t + n_ext, device=device)
    valid = torch.where(pos < t, pos < cache.comp_len,
                        (pos - t) < cache.resid_len)[None, None, None, :]
    if pad_start is not None:
        ok = ((pos + token_offset)[None, :]
              >= pad_start.to(device)[:, None]) | (pos >= t)
        valid = valid & ok[:, None, None, :]
    return valid


def _pv(spec: CacheSpec, cache: LayerCache, w: torch.Tensor,
        include_residual: bool) -> torch.Tensor:
    """Weights w [B,Hkv,Q,max_len(+group)] times the two-tier V."""
    b, hkv, nq, _ = w.shape
    t, nb, g, r = spec.max_len, spec.n_blocks, spec.group, spec.r_store
    wc = w[..., :t]
    out = torch.einsum("bhqt,bhtd->bhqd", wc, _dequant_v(spec, cache))
    vqt = base_vqt(spec, cache).reshape(b, hkv, r, nb, g)
    wv = torch.einsum("bhqng,bhrng->bhqnr", wc.reshape(b, hkv, nq, nb, g),
                      vqt)
    out = out + torch.einsum("bhqnr,bhnrd->bhqd", wv, base_vpt(spec, cache))
    if include_residual:
        out = out + torch.einsum("bhqr,bhrd->bhqd", w[..., t:],
                                 cache.v_resid.float())
    return out


def attend(spec: CacheSpec, cache: LayerCache, q: torch.Tensor, *,
           sm_scale: float | None = None,
           pad_start: torch.Tensor | None = None,
           window: int | None = None) -> torch.Tensor:
    """Decode attention of q [B,Hq,Qn,D] against the compressed cache.

    Scores against the packed prefix (outlier deltas and low-rank correction
    included) and the residual tier, one masked softmax across both, then
    the two-tier PV product, all in float32. GQA: Hq must be a multiple of
    num_kv_heads. ``pad_start``: optional int32 [B], the first valid prefix
    token per row (left-padded batches). ``window``: optional sliding
    window (Mistral): only the last ``window`` tokens of the sequence are
    attended, exact across both tiers.
    """
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    gq = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    t, g = spec.max_len, spec.group

    qf = q.reshape(b, hkv, gq * qn, d).float()
    scores = _scores(spec, cache, qf, True) * sm_scale
    valid = _valid(spec, cache, g, q.device, pad_start)
    if window is not None:
        # prefix slot i sits at position i, residual slot r at comp_len + r
        pos = torch.arange(t + g, device=q.device)
        abs_pos = torch.where(pos < t, pos, cache.comp_len + (pos - t))
        valid = valid & (abs_pos >= cache.total_len - window)
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = _pv(spec, cache, w, True)
    return out.reshape(b, hq, qn, d).to(q.dtype)


def attend_partial(spec: CacheSpec, cache: LayerCache, q: torch.Tensor, *,
                   sm_scale: float | None = None,
                   pad_start: torch.Tensor | None = None,
                   include_residual: bool = True, token_offset: int = 0):
    """Unnormalised flash-style attention state against this cache (a time
    shard of a longer one).

    Returns (acc [B,Hq,Qn,D] f32, m [B,Hq,Qn], l [B,Hq,Qn]) with the
    normalised output ``acc / l``; states of several shards merge with
    :func:`merge_partials`. ``token_offset`` is the global position of this
    shard's token 0 (only for masking against the global ``pad_start``).
    """
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    gq = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = q.reshape(b, hkv, gq * qn, d).float()
    scores = _scores(spec, cache, qf, include_residual) * sm_scale
    n_ext = spec.group if include_residual else 0
    valid = _valid(spec, cache, n_ext, q.device, pad_start, token_offset)
    scores = scores.masked_fill(~valid, float("-inf"))

    m = scores.amax(dim=-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    w = torch.exp(scores - m_safe[..., None])  # exp(-inf) = 0 where masked
    l = w.sum(dim=-1)
    acc = _pv(spec, cache, w, include_residual)
    m = torch.where(finite, m, torch.full_like(m, -1e30))
    shape_out = (b, hq, qn)
    return (acc.reshape(b, hq, qn, d), m.reshape(shape_out),
            l.reshape(shape_out))


def merge_partials(parts) -> torch.Tensor:
    """Merge partial attention states [(acc, m, l), ...] -> output:
    ``m* = max m_i; out = sum(acc_i e^{m_i - m*}) / sum(l_i e^{m_i - m*})``."""
    m_tot = parts[0][1]
    for _, m, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    num = 0.0
    den = 0.0
    for acc, m, l in parts:
        a = torch.where(m > -1e29, torch.exp(m - m_tot), torch.zeros_like(m))
        num = num + acc * a[..., None]
        den = den + l * a
    return num / den[..., None]


def stack_layers(caches: list[LayerCache]) -> LayerCache:
    """Stack per-layer caches into one with a leading layer axis (all layers
    share their lengths)."""
    first = caches[0]
    for c in caches[1:]:
        if any(getattr(c, f) != getattr(first, f) for f in LENGTH_FIELDS):
            raise ValueError("layers of a stack must share their lengths")
    return LayerCache(
        **{f: torch.stack([getattr(c, f) for c in caches])
           for f in TENSOR_FIELDS},
        **{f: getattr(first, f) for f in LENGTH_FIELDS})


def init_stacked(spec: CacheSpec, num_layers: int, device=None) -> LayerCache:
    """An empty stacked cache of ``num_layers`` layers (own storage per
    layer, since the port updates caches in place)."""
    return stack_layers([init_layer_cache(spec, device=device)
                         for _ in range(num_layers)])
