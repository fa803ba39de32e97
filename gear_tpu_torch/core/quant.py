"""Group-wise asymmetric min/max quantization and int32 bit-packing.

PyTorch port of ``gear_tpu/core/quant.py``. Three packing layouts, as there:
consecutive little-endian (:func:`pack_codes`, the layout of the original
GEAR kernels), strided (:func:`pack_codes_strided`: word w holds codes
{j*W + w}) and byte-strided (:func:`pack_codes_bytestrided`: the compressed
cache's layout, and the one ``native/kvcodec.cc``'s ``gear_pack_u4`` /
``gear_pack_u2`` write). Conventions are the reference's:

  * All primitives operate along the LAST dimension.
  * ``q = clip(round((x - mn) / step), 0, levels)`` with
    ``step = (mx - mn) * f32(1 / levels)`` and ``levels = 2**bits - 1``; a
    constant group (step 0) divides by 1 instead. The step multiplies by the
    float32 reciprocal because that is what the JAX package computes under
    ``jit`` (XLA turns the division by the constant ``levels`` into that
    product); the eager JAX division can differ from it in the last bit.
    ``torch.round`` rounds half to even, like ``jnp.round`` and CUDA's
    ``rintf``.
  * Quant math runs in float32 regardless of input dtype.
  * Bit work runs in int64; words >= 2**31 are folded to negative int32
    explicitly (PyTorch's uint32 support is thin, and an out-of-range
    int64 -> int32 cast is not something to rely on).
"""
from __future__ import annotations

import torch


def group_minmax(x: torch.Tensor, group_size: int):
    """Per-group (min, max) along the last dim -> each [..., n // group_size]."""
    n = x.shape[-1]
    if n % group_size != 0:
        raise ValueError(f"last dim {n} not divisible by group_size {group_size}")
    g = x.reshape(*x.shape[:-1], n // group_size, group_size)
    return g.amin(dim=-1), g.amax(dim=-1)


def quantize_groups(x: torch.Tensor, bits: int, group_size: int, *,
                    levels: int | None = None):
    """Group-wise asymmetric quantization along the last dim.

    Returns (codes int32 [..., n], scale f32 [..., n//G], mn f32 [..., n//G]);
    dequant is ``codes * scale + mn``.
    """
    if levels is None:
        levels = (1 << bits) - 1
    xf = x.float()
    mn, mx = group_minmax(xf, group_size)
    scale = (mx - mn) * (1.0 / levels)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    n = x.shape[-1]
    gshape = (*x.shape[:-1], n // group_size, group_size)
    q = (xf.reshape(gshape) - mn[..., None]) / safe[..., None]
    q = torch.clamp(torch.round(q), 0, levels).to(torch.int32)
    return q.reshape(x.shape), scale, mn


def dequantize_groups(codes: torch.Tensor, scale: torch.Tensor,
                      mn: torch.Tensor, group_size: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_groups`: ``codes * scale + mn``."""
    n = codes.shape[-1]
    gshape = (*codes.shape[:-1], n // group_size, group_size)
    x = codes.reshape(gshape).float() * scale[..., None] + mn[..., None]
    return x.reshape(codes.shape).to(dtype)


def fake_quantize_groups(x: torch.Tensor, bits: int, group_size: int, *,
                         levels: int | None = None) -> torch.Tensor:
    """Quantize -> dequantize round trip along the last dim, back in
    ``x.dtype`` (the simulated accuracy path); ``levels`` overrides the top
    code ``2**bits - 1``."""
    codes, scale, mn = quantize_groups(x, bits, group_size, levels=levels)
    return dequantize_groups(codes, scale, mn, group_size, dtype=x.dtype)


def _to_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _check_bits(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError("bits must be one of 2, 4, 8")
    return 32 // bits


def pack_codes_bytestrided(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack with the BYTE-STRIDED layout: byte c of a row's byte array holds
    codes {c + m * (n / vpb) | m} at bit position m*bits (vpb = 8 // bits);
    int32 word w = bytes 4w..4w+3, little-endian.

    codes [..., n] int -> int32 [..., n * bits // 32].
    """
    fpi = _check_bits(bits)
    vpb = 8 // bits
    n = codes.shape[-1]
    if n % fpi != 0:
        raise ValueError(f"last dim {n} not divisible by {fpi}")
    nb = n // vpb
    c = codes.to(torch.int64)
    byte = torch.zeros(codes.shape[:-1] + (nb,), dtype=torch.int64,
                       device=codes.device)
    for m in range(vpb):
        byte = byte | (c[..., m * nb:(m + 1) * nb] << (m * bits))
    word = torch.zeros(codes.shape[:-1] + (nb // 4,), dtype=torch.int64,
                       device=codes.device)
    for k in range(4):
        word = word | (byte[..., k::4] << (8 * k))
    return _to_int32_bits(word)


def unpack_codes_bytestrided(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_bytestrided` -> int32 [..., W * 32 // bits]."""
    _check_bits(bits)
    vpb = 8 // bits
    w = packed.to(torch.int64) & 0xFFFFFFFF
    nw = packed.shape[-1]
    # byte 4w+k = (word w >> 8k) & 0xFF: stack k innermost, then flatten
    byte = torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    byte = byte.reshape(*packed.shape[:-1], nw * 4)
    mask = (1 << bits) - 1
    parts = [(byte >> (m * bits)) & mask for m in range(vpb)]
    return torch.cat(parts, dim=-1).to(torch.int32)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack codes (values in [0, 2**bits)) into int32 words along the last
    dim, CONSECUTIVE little-endian: word[i] = sum_j codes[i*fpi + j] <<
    (bits*j), fpi = 32 // bits.

    codes [..., n] with n % fpi == 0 -> int32 [..., n * bits // 32].
    """
    fpi = _check_bits(bits)
    n = codes.shape[-1]
    if n % fpi != 0:
        raise ValueError(f"last dim {n} not divisible by {fpi}")
    c = codes.to(torch.int64).reshape(*codes.shape[:-1], n // fpi, fpi)
    word = c[..., 0]
    for j in range(1, fpi):
        word = word | (c[..., j] << (bits * j))
    return _to_int32_bits(word)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> int32 codes [..., W * 32 // bits]."""
    fpi = _check_bits(bits)
    w = (packed.to(torch.int64) & 0xFFFFFFFF)[..., None]
    shifts = torch.arange(fpi, dtype=torch.int64, device=packed.device) * bits
    codes = (w >> shifts) & ((1 << bits) - 1)
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * fpi).to(
        torch.int32)


def pack_codes_strided(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack with the STRIDED lane layout: word w holds codes {j*W + w | j}
    at bit position j*bits, W = n // fpi.

    codes [..., n] with n % fpi == 0 -> int32 [..., W].
    """
    fpi = _check_bits(bits)
    n = codes.shape[-1]
    if n % fpi != 0:
        raise ValueError(f"last dim {n} not divisible by {fpi}")
    c = codes.to(torch.int64).reshape(*codes.shape[:-1], fpi, n // fpi)
    shifts = torch.arange(fpi, dtype=torch.int64, device=codes.device) * bits
    return _to_int32_bits((c << shifts[:, None]).sum(dim=-2))


def unpack_codes_strided(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_strided` -> int32 codes [..., W * fpi]."""
    fpi = _check_bits(bits)
    w = packed.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << bits) - 1
    return torch.cat([(w >> (j * bits)) & mask for j in range(fpi)],
                     dim=-1).to(torch.int32)


def quantize_and_pack(x: torch.Tensor, bits: int, group_size: int):
    """:func:`quantize_groups` + :func:`pack_codes` in one call -> (packed
    int32 [..., n*bits//32], scale [..., n//G], mn [..., n//G])."""
    codes, scale, mn = quantize_groups(x, bits, group_size)
    return pack_codes(codes, bits), scale, mn


def unpack_and_dequantize(packed: torch.Tensor, scale: torch.Tensor,
                          mn: torch.Tensor, bits: int, group_size: int,
                          dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_and_pack`."""
    return dequantize_groups(unpack_codes(packed, bits), scale, mn,
                             group_size, dtype=dtype)


def quant_kv_per_token(x: torch.Tensor, bits: int, group_size: int):
    """Per-token quantization of [B, H, S, D]: groups along the head dim ->
    (codes [B,H,S,D], scale / mn [B,H,S,D//G])."""
    return quantize_groups(x, bits, group_size)


def quant_kv_per_channel(x: torch.Tensor, bits: int, group_size: int):
    """Per-channel quantization of [B, H, S, D]: groups along the sequence,
    on the transposed view -> (codes [B,H,D,S], scale / mn [B,H,D,S//G]),
    TRANSPOSED."""
    return quantize_groups(x.transpose(-1, -2), bits, group_size)
