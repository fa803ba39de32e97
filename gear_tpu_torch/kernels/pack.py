"""Fused group min/max + quantize + byte-strided bit-pack (CUDA, sm_90a).

Port of ``gear_tpu/kernels/pack.py``: the Pallas ``_token_kernel`` and
``_channel_kernel`` become ``csrc/pack.cu``. Two entry points matching the
cache layouts (``gear_tpu_torch.cache``):

  * :func:`quant_pack_tokens`   — V: groups of ``v_group`` channels along the
    head dim (per-token scales), codes packed along the head dim.
  * :func:`quant_pack_channels` — K: groups of ``group`` tokens along time
    (per-channel scales), codes still packed along the head dim.

A tensor on the CPU goes through the plain PyTorch version beside each
kernel (``*_plain``); a CUDA tensor launches the kernel, or the wrapper
raises. Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from ..core import quant
from . import _build


def quant_pack_tokens_plain(x: torch.Tensor, *, bits: int, v_group: int):
    """x [..., D] -> (words int32 [..., D*bits//32], scale f32 [..., D//v_group], mn)."""
    codes, scale, mn = quant.quantize_groups(x, bits, v_group)
    return quant.pack_codes_bytestrided(codes, bits), scale, mn


def quant_pack_channels_plain(x: torch.Tensor, *, bits: int, group: int):
    """x [..., S, D] -> (words int32 [..., S//group, group, D*bits//32],
    scale f32 [..., S//group, 1, D], mn)."""
    *lead, s, d = x.shape
    xg = x.float().reshape(*lead, s // group, group, d)
    # per-channel groups along time == quantize_groups on the [D, G] view
    codes, scale, mn = quant.quantize_groups(xg.transpose(-1, -2), bits, group)
    words = quant.pack_codes_bytestrided(codes.transpose(-1, -2), bits)
    return words, scale.transpose(-1, -2), mn.transpose(-1, -2)


def _check_common(x: torch.Tensor, bits: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected torch.float32 or torch.bfloat16 input, "
                        f"got {x.dtype}")
    if bits not in (2, 4, 8):
        raise ValueError("bits must be one of 2, 4, 8")
    if x.shape[-1] % (32 // bits):
        raise ValueError(f"head dim {x.shape[-1]} not a multiple of {32 // bits}")


def quant_pack_tokens(x: torch.Tensor, *, bits: int, v_group: int):
    """V-layout pack; see :func:`quant_pack_tokens_plain` for shapes. The
    kernel reads float32 or bf16 as it is given (bf16 -> float32 is exact,
    so both give the same words and sidebands), head dims up to 128."""
    if x.device.type == "cpu":
        return quant_pack_tokens_plain(x, bits=bits, v_group=v_group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_common(x, bits)
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    *lead, d = x.shape
    if d % v_group:
        raise ValueError(f"head dim {d} not a multiple of v_group {v_group}")
    if d > 128:
        raise ValueError(f"head dim {d} > 128: a row is one warp of four "
                         "channels a lane")
    if x.data_ptr() % 16:
        raise ValueError("input is not 16-byte aligned")
    m = x.numel() // d
    words = torch.empty((*lead, d * bits // 32), dtype=torch.int32, device=x.device)
    scale = torch.empty((*lead, d // v_group), dtype=torch.float32, device=x.device)
    mn = torch.empty_like(scale)
    lib = _build.library()
    err = lib.gear_quant_pack_tokens(
        x.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
        scale.data_ptr(), mn.data_ptr(), m, d, bits, v_group,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gear_quant_pack_tokens")
    quant_pack_tokens.launches += 1
    return words, scale, mn


def quant_pack_channels(x: torch.Tensor, *, bits: int, group: int):
    """K-layout pack; see :func:`quant_pack_channels_plain` for shapes. The
    kernel reads float32 or bf16 as it is given (both give the same words
    and sidebands), x [S, D], [N, S, D] or [B, H, S, D] through its strides
    (the model's K, a view of its [B, S, H, D] projection, needs no copy)
    with contiguous channels and every row starting on 16 bytes."""
    if x.device.type == "cpu":
        return quant_pack_channels_plain(x, bits=bits, group=group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_common(x, bits)
    if not 2 <= x.dim() <= 4:
        raise ValueError(f"expected [S, D], [N, S, D] or [B, H, S, D], got "
                         f"{tuple(x.shape)}")
    x4 = x[(None,) * (4 - x.dim())]
    *lead, s, d = x.shape
    if s % group:
        raise ValueError(f"length {s} not a multiple of group {group}")
    if x4.stride(-1) != 1 and d > 1:
        raise ValueError("channels must be contiguous")
    # the strides of batch, head and token (0 where the size is 1)
    strides = [st if n > 1 else 0 for st, n in zip(x4.stride()[:3],
                                                    x4.shape[:3])]
    if x.data_ptr() % 16 or any(st * x.element_size() % 16 for st in strides):
        raise ValueError("every row must start on 16 bytes: input pointer "
                         "and strides")
    b, h = x4.shape[:2]
    wd = d * bits // 32
    if b * h * (s // group) * -(-wd // min(wd, 256)) >= 2 ** 31:
        raise ValueError("more than 2**31 - 1 groups: the kernel counts "
                         "them in 32 bits")
    words = torch.empty((*lead, s // group, group, wd),
                        dtype=torch.int32, device=x.device)
    scale = torch.empty((*lead, s // group, 1, d), dtype=torch.float32,
                        device=x.device)
    mn = torch.empty_like(scale)
    lib = _build.library()
    err = lib.gear_quant_pack_channels(
        x.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
        scale.data_ptr(), mn.data_ptr(), b * h, h, *strides, s,
        group, d, bits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gear_quant_pack_channels")
    quant_pack_channels.launches += 1
    return words, scale, mn


quant_pack_tokens.launches = 0
quant_pack_channels.launches = 0
