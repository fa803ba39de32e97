"""Two-tier compressed KV cache (GEARL subset), PyTorch port of ``gear_tpu/cache.py``.

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
  * Lengths are host integers. Every row shares ``comp_len`` / ``resid_len``
    / ``prefill_len`` (scalars in the JAX cache), so keeping them on the
    host spares each decode step a device-to-host sync; the flush is a
    Python ``if`` instead of ``lax.cond``.
  * Randomness. The power-iteration init comes from an optional provider
    ``p0(which, shape) -> Tensor`` (``which`` is ``"k"`` or ``"v"``), else
    uniform [0, 1) draws from a ``torch.Generator``.

This slice covers GEARL (quantization plus bf16 low-rank error bases). COO
outliers, int8 bases and KCVT prefill scales raise ``NotImplementedError``;
the outlier, boundary and base-scale fields keep their shapes (zero-size,
or ones) so the state still matches the JAX cache field for field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .core import lowrank, quant

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
    base_bits: int = 16   # 16 = bf16 P/Q bases (8 = int8: a later slice)
    outliers_per_block: int = 0   # COO outliers: a later slice
    kcvt_prefill: bool = False    # whole-span K scales: a later slice
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
        if self.outliers_per_block:
            raise NotImplementedError(
                "COO outliers (GEAR, outliers_per_block > 0) are not ported "
                "yet: they come with the next slice of gear_tpu_torch")
        if self.base_bits == 8:
            raise NotImplementedError(
                "int8 low-rank bases (base_bits=8) are not ported yet: they "
                "come with a later slice of gear_tpu_torch")
        if self.kcvt_prefill:
            raise NotImplementedError(
                "KCVT prefill scales (kcvt_prefill) are not ported yet: they "
                "come with a later slice of gear_tpu_torch")

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
        return self.outliers_per_block

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
        base_el = 2
        total += 2 * b * h * self.n_blocks * d * self.r_store * base_el
        total += 2 * b * h * t * self.r_store * base_el
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
    kpt: torch.Tensor       # [B, H, n_blocks, r_store, D]
    kqt: torch.Tensor       # [B, H, r_store, max_len]
    vpt: torch.Tensor       # [B, H, n_blocks, r_store, D]
    vqt: torch.Tensor       # [B, H, r_store, max_len]
    k_out_idx: torch.Tensor  # int32 [B, H, n_blocks, 0] (outliers: later)
    k_out_val: torch.Tensor  # [B, H, n_blocks, 0]
    v_out_idx: torch.Tensor
    v_out_val: torch.Tensor
    k_out_bnd: torch.Tensor  # int32 [B, H, n_blocks, 0]
    v_out_bnd: torch.Tensor
    kpt_scale: torch.Tensor  # f32 ones [B, H, n_blocks, r_store]
    kqt_scale: torch.Tensor  # f32 ones [B, H, r_store, n_blocks]
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


def init_layer_cache(spec: CacheSpec, device=None) -> LayerCache:
    b, h, d = spec.batch, spec.num_kv_heads, spec.head_dim
    nb, t, r = spec.n_blocks, spec.max_len, spec.r_store
    sb, dt = spec.sideband_dtype, spec.dtype

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
        kpt=z((b, h, nb, r, d), dt),
        kqt=z((b, h, r, t), dt),
        vpt=z((b, h, nb, r, d), dt),
        vqt=z((b, h, r, t), dt),
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
# Compression of a block of tokens (prefill or residual flush).
# ---------------------------------------------------------------------------

def _compress_k_block(spec: CacheSpec, k: torch.Tensor):
    """K block [B,H,S,D] -> per-channel quant over ``group``-token windows,
    codes packed along the head dim and stored transposed.

    Returns (packed int32 [B,H,WD,S], scale/mn [B,H,S//group,D] sideband).
    """
    b, h, s_len, d = k.shape
    g = spec.group
    nbs = s_len // g
    levels = (1 << spec.bits) - 1
    kg = k.float().reshape(b, h, nbs, g, d)
    mn = kg.amin(dim=3)
    mx = kg.amax(dim=3)
    scale = (mx - mn) * (1.0 / levels)  # as jitted XLA computes it
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.clamp(
        torch.round((kg - mn[:, :, :, None]) / safe[:, :, :, None]), 0, levels
    ).to(torch.int32).reshape(b, h, s_len, d)
    packed = quant.pack_codes_bytestrided(codes, spec.bits).transpose(-1, -2)
    return (packed, scale.to(spec.sideband_dtype),
            mn.to(spec.sideband_dtype))


def _compress_v_block(spec: CacheSpec, v: torch.Tensor):
    """V block [B,H,S,D] -> per-token codes packed along the head dim,
    stored word-major transposed.

    Returns (packed int32 [B,H,D//fpi,S], scale/mn [B,H,D//v_group,S]).
    """
    codes, scale, mn = quant.quantize_groups(v, spec.bits, spec.v_group)
    packed = quant.pack_codes_bytestrided(codes, spec.bits).transpose(-1, -2)
    return (packed, scale.transpose(-1, -2).to(spec.sideband_dtype),
            mn.transpose(-1, -2).to(spec.sideband_dtype))


def _compress_k_block_pk(spec: CacheSpec, k: torch.Tensor):
    """:func:`_compress_k_block` through the fused pack kernel
    (``kernels.pack.quant_pack_channels``): one read of the block emits the
    packed words and sidebands. Used by :func:`prefill` on the card."""
    from .kernels import pack as packk

    b, h, s_len, d = k.shape
    nbs = s_len // spec.group
    xf = k.float().reshape(b * h, s_len, d).contiguous()
    words, scale, mn = packk.quant_pack_channels(xf, bits=spec.bits,
                                                 group=spec.group)
    packed = words.reshape(b, h, s_len, spec.v_words).transpose(-1, -2)
    return (packed, scale.reshape(b, h, nbs, d).to(spec.sideband_dtype),
            mn.reshape(b, h, nbs, d).to(spec.sideband_dtype))


def _compress_v_block_pk(spec: CacheSpec, v: torch.Tensor):
    """:func:`_compress_v_block` through the fused pack kernel
    (``kernels.pack.quant_pack_tokens``)."""
    from .kernels import pack as packk

    b, h, s_len, d = v.shape
    ngv = spec.v_groups_per_token
    xf = v.float().reshape(b * h, s_len, d).contiguous()
    words, scale, mn = packk.quant_pack_tokens(xf, bits=spec.bits,
                                               v_group=spec.v_group)
    packed = words.reshape(b, h, s_len, spec.v_words).transpose(-1, -2)
    return (packed,
            scale.reshape(b, h, s_len, ngv).transpose(-1, -2)
            .to(spec.sideband_dtype),
            mn.reshape(b, h, s_len, ngv).transpose(-1, -2)
            .to(spec.sideband_dtype))


def _dequant_k_block(spec: CacheSpec, packed, scale, mn) -> torch.Tensor:
    """Inverse of :func:`_compress_k_block` -> [B,H,S,D] f32."""
    b, h, _, s_len = packed.shape
    nbs = s_len // spec.group
    codes = quant.unpack_codes_bytestrided(packed.transpose(-1, -2), spec.bits)
    d = codes.shape[-1]
    cg = codes.float().reshape(b, h, nbs, spec.group, d)
    x = cg * scale.float()[:, :, :, None] + mn.float()[:, :, :, None]
    return x.reshape(b, h, s_len, d)


def _dequant_v_block(spec: CacheSpec, packed, scale, mn) -> torch.Tensor:
    """Inverse of :func:`_compress_v_block` -> [B,H,S,D] f32."""
    codes = quant.unpack_codes_bytestrided(packed.transpose(-1, -2), spec.bits)
    return quant.dequantize_groups(codes, scale.transpose(-1, -2).float(),
                                   mn.transpose(-1, -2).float(), spec.v_group)


def _error_bases(spec: CacheSpec, x, x_hat, rank: int, which: str,
                 p0: P0Fn | None, generator: torch.Generator | None):
    """Low-rank bases of the quantization error, zero-padded to r_store.

    x, x_hat: [B,H,S,D]. Returns (P [B,H,D,r_store], Qt [B,H,r_store,S]) in
    the cache dtype (16-bit bases).
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
    return p.to(spec.dtype), q.transpose(-1, -2).to(spec.dtype)


def prefill(spec: CacheSpec, k: torch.Tensor, v: torch.Tensor, *,
            p0: P0Fn | None = None,
            generator: torch.Generator | None = None) -> LayerCache:
    """Build a LayerCache from prefill K/V [B,H,S,D] (S <= max_len).

    The first ``(S // group) * group`` tokens are compressed as one prefill
    block at ``prefill_rank``; the remainder seeds the residual tier.
    On CUDA tensors the block quantize + pack runs through the fused pack
    kernels (bit-identical formulas); on the CPU through the plain ones.
    """
    b, h, s, d = k.shape
    g = spec.group
    n_full = (s // g) * g
    cache = init_layer_cache(spec, device=k.device)

    if n_full:
        kb, vb = k[:, :, :n_full], v[:, :, :n_full]
        c_k = _compress_k_block_pk if k.is_cuda else _compress_k_block
        c_v = _compress_v_block_pk if k.is_cuda else _compress_v_block
        k_pack, k_scale, k_mn = c_k(spec, kb)
        v_pack, v_scale, v_mn = c_v(spec, vb)
        nbs = n_full // g
        cache.k_codes[:, :, :, :n_full] = k_pack
        cache.k_scale[:, :, :nbs] = k_scale
        cache.k_mn[:, :, :nbs] = k_mn
        cache.v_codes[:, :, :, :n_full] = v_pack
        cache.v_scale[:, :, :, :n_full] = v_scale
        cache.v_mn[:, :, :, :n_full] = v_mn
        cache.comp_len = n_full
        cache.prefill_len = n_full
        if max(spec.prefill_rank, spec.prefill_rank_v_eff) > 0:
            k_hat = _dequant_k_block(spec, k_pack, k_scale, k_mn)
            v_hat = _dequant_v_block(spec, v_pack, v_scale, v_mn)
            kp, kqt = _error_bases(spec, kb, k_hat, spec.prefill_rank, "k",
                                   p0, generator)
            vp, vqt = _error_bases(spec, vb, v_hat, spec.prefill_rank_v_eff,
                                   "v", p0, generator)
            # the prefill P is replicated across its blocks
            cache.kpt[:, :, :nbs] = kp.transpose(-1, -2)[:, :, None]
            cache.kqt[:, :, :, :n_full] = kqt
            cache.vpt[:, :, :nbs] = vp.transpose(-1, -2)[:, :, None]
            cache.vqt[:, :, :, :n_full] = vqt

    tail = s - n_full
    if tail:
        cache.k_resid[:, :, :tail] = k[:, :, n_full:]
        cache.v_resid[:, :, :tail] = v[:, :, n_full:]
        cache.resid_len = tail
    return cache


def _flush(spec: CacheSpec, cache: LayerCache, p0: P0Fn | None,
           generator: torch.Generator | None) -> None:
    """Quantize the full residual tier into the packed prefix, in place."""
    g = spec.group
    c0 = cache.comp_len
    if c0 + g > spec.max_len:
        raise ValueError(
            f"compressed cache full: flushing {g} tokens at comp_len {c0} "
            f"exceeds max_len {spec.max_len}")
    kb = cache.k_resid.float()
    vb = cache.v_resid.float()
    k_pack, k_scale, k_mn = _compress_k_block(spec, kb)
    v_pack, v_scale, v_mn = _compress_v_block(spec, vb)
    blk = c0 // g
    cache.k_codes[:, :, :, c0:c0 + g] = k_pack
    cache.k_scale[:, :, blk] = k_scale[:, :, 0]
    cache.k_mn[:, :, blk] = k_mn[:, :, 0]
    cache.v_codes[:, :, :, c0:c0 + g] = v_pack
    cache.v_scale[:, :, :, c0:c0 + g] = v_scale
    cache.v_mn[:, :, :, c0:c0 + g] = v_mn
    if max(spec.rank, spec.rank_v_eff) > 0:
        k_hat = _dequant_k_block(spec, k_pack, k_scale, k_mn)
        v_hat = _dequant_v_block(spec, v_pack, v_scale, v_mn)
        kp, kqt = _error_bases(spec, kb, k_hat, spec.rank, "k", p0, generator)
        vp, vqt = _error_bases(spec, vb, v_hat, spec.rank_v_eff, "v", p0,
                               generator)
        cache.kpt[:, :, blk] = kp.transpose(-1, -2)
        cache.kqt[:, :, :, c0:c0 + g] = kqt
        cache.vpt[:, :, blk] = vp.transpose(-1, -2)
        cache.vqt[:, :, :, c0:c0 + g] = vqt
    cache.comp_len = c0 + g
    cache.resid_len = 0


def append(spec: CacheSpec, cache: LayerCache, k_new: torch.Tensor,
           v_new: torch.Tensor, *, p0: P0Fn | None = None,
           generator: torch.Generator | None = None) -> LayerCache:
    """Append one decode step's K/V [B,H,1,D] in place; flush the residual
    tier into the packed prefix when it fills to ``group`` tokens.

    ``p0`` is asked for the flush's power-iteration inits only when a flush
    happens. Raises ``ValueError`` when a flush would pass ``max_len`` (the
    JAX cache silently clamps there).
    """
    i = cache.resid_len
    cache.k_resid[:, :, i] = k_new[:, :, 0]
    cache.v_resid[:, :, i] = v_new[:, :, 0]
    cache.resid_len = i + 1
    if cache.resid_len == spec.group:
        _flush(spec, cache, p0, generator)
    return cache


def base_kpt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """K low-rank P factor (transposed) [B,H,NB,R,D] f32."""
    return cache.kpt.float()


def base_vpt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """V low-rank P factor (transposed) [B,H,NB,R,D] f32."""
    return cache.vpt.float()


def base_kqt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """K low-rank Q factor (transposed) [B,H,R,T] f32."""
    return cache.kqt.float()


def base_vqt(spec: CacheSpec, cache: LayerCache) -> torch.Tensor:
    """V low-rank Q factor (transposed) [B,H,R,T] f32."""
    return cache.vqt.float()


# ---------------------------------------------------------------------------
# Attention against the compressed cache: the plain version of the decode
# kernel (kernels/decode.py), and the CPU path.
# ---------------------------------------------------------------------------

def dequantize_kv(spec: CacheSpec, cache: LayerCache):
    """The reconstructed prefix K/V [B,H,max_len,D] f32, low-rank included."""
    k = _dequant_k_block(spec, cache.k_codes, cache.k_scale, cache.k_mn)
    v = _dequant_v_block(spec, cache.v_codes, cache.v_scale, cache.v_mn)
    b, h = spec.batch, spec.num_kv_heads
    nb, g, r = spec.n_blocks, spec.group, spec.r_store
    kqt = base_kqt(spec, cache).reshape(b, h, r, nb, g)
    vqt = base_vqt(spec, cache).reshape(b, h, r, nb, g)
    k_corr = torch.einsum("bhrng,bhnrd->bhngd", kqt, base_kpt(spec, cache))
    v_corr = torch.einsum("bhrng,bhnrd->bhngd", vqt, base_vpt(spec, cache))
    return k + k_corr.reshape(k.shape), v + v_corr.reshape(v.shape)


def attend(spec: CacheSpec, cache: LayerCache, q: torch.Tensor, *,
           sm_scale: float | None = None,
           pad_start: torch.Tensor | None = None,
           window: int | None = None) -> torch.Tensor:
    """Decode attention of q [B,Hq,Qn,D] against the compressed cache.

    Scores against the packed prefix (with its low-rank correction) and the
    residual tier, one masked softmax across both, then the two-tier PV
    product, all in float32. GQA: Hq must be a multiple of num_kv_heads.
    ``pad_start``: optional int32 [B], the first valid prefix token per row
    (left-padded batches).
    """
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention over the compressed cache is not "
            "ported yet")
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    gq = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    t, nb, g, r = spec.max_len, spec.n_blocks, spec.group, spec.r_store

    qf = q.reshape(b, hkv, gq * qn, d).float()
    k_deq = _dequant_k_block(spec, cache.k_codes, cache.k_scale, cache.k_mn)
    scores_q = torch.einsum("bhqd,bhtd->bhqt", qf, k_deq)
    kqt = base_kqt(spec, cache).reshape(b, hkv, r, nb, g)
    qp = torch.einsum("bhqd,bhnrd->bhqnr", qf, base_kpt(spec, cache))
    scores_lr = torch.einsum("bhqnr,bhrng->bhqng", qp, kqt).reshape(
        b, hkv, gq * qn, t)
    scores_res = torch.einsum("bhqd,bhrd->bhqr", qf, cache.k_resid.float())
    scores = torch.cat([scores_q + scores_lr, scores_res], dim=-1) * sm_scale

    pos = torch.arange(t + g, device=q.device)
    valid = torch.where(pos < t, pos < cache.comp_len,
                        (pos - t) < cache.resid_len)[None, None, None, :]
    if pad_start is not None:
        ok = (pos[None, :] >= pad_start.to(q.device)[:, None]) | (pos >= t)
        valid = valid & ok[:, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))

    w = torch.softmax(scores, dim=-1)
    wc, wr = w[..., :t], w[..., t:]
    v_deq = _dequant_v_block(spec, cache.v_codes, cache.v_scale, cache.v_mn)
    out = torch.einsum("bhqt,bhtd->bhqd", wc, v_deq)
    vqt = base_vqt(spec, cache).reshape(b, hkv, r, nb, g)
    wv = torch.einsum("bhqng,bhrng->bhqnr",
                      wc.reshape(b, hkv, gq * qn, nb, g), vqt)
    out = out + torch.einsum("bhqnr,bhnrd->bhqd", wv, base_vpt(spec, cache))
    out = out + torch.einsum("bhqr,bhrd->bhqd", wr, cache.v_resid.float())
    return out.reshape(b, hq, qn, d).to(q.dtype)


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
