"""Simulated ("fake-quant") GEAR compression: the accuracy path.

PyTorch port of ``gear_tpu/core/simulated.py``. Quantize -> dequantize
immediately; the cache stays in high precision. This is the path on which
the reference's published accuracy figures are made.

Stack-A layout, as in the JAX package: per-token groups run along the
FLATTENED h*d channel axis and per-channel groups along the sequence, with
a ``seq % group`` tail that passes through uncompressed (unlike the fused
cache's per-head groups, ``gear_tpu_torch.cache``). The level count is
always ``2**bits - 1`` and constant groups do not divide by zero.

Inits. The JAX package draws each tensor's power-iteration init from one
``jax.random`` key split into a K and a V key. Here the init comes from an
explicit hook instead: ``p0(which, shape)`` (``which`` is ``"k"`` or
``"v"``) returns the uniform [0, 1) init, so tests can feed both packages
the same draws; without it the inits come from ``generator``, K's draw
first.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config import LayerCompressionConfig
from . import lowrank, outliers, quant

P0Fn = Callable[[str, tuple], torch.Tensor]


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B,H,S,D] -> [B,S,H*D] (token rows)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _from_tokens(x: torch.Tensor, h: int, d: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, h, d).transpose(1, 2)


def fake_token_quant(x: torch.Tensor, bits: int,
                     group_size: int) -> torch.Tensor:
    """Per-token fake quant of [B,H,S,D]; groups of ``group_size`` along h*d."""
    b, h, s, d = x.shape
    out = quant.fake_quantize_groups(_to_tokens(x), bits, group_size)
    return _from_tokens(out, h, d).to(x.dtype)


def fake_channel_quant(x: torch.Tensor, bits: int,
                       group_size: int) -> torch.Tensor:
    """Per-channel fake quant of [B,H,S,D]; groups of ``group_size`` along
    seq. A trailing ``seq % group_size`` remainder passes through."""
    b, h, s, d = x.shape
    rows = _to_tokens(x)  # [b, s, n]
    n_full = (s // group_size) * group_size
    if n_full == 0:
        return x
    cols = rows[:, :n_full].transpose(1, 2)  # [b, n, s_full]
    out = quant.fake_quantize_groups(cols, bits, group_size).transpose(1, 2)
    if n_full != s:
        out = torch.cat([out, rows[:, n_full:]], dim=1)
    return _from_tokens(out, h, d).to(x.dtype)


def _outlier_k_tokens(x: torch.Tensor, sparsity: float) -> int:
    b, h, s, d = x.shape
    return outliers.outlier_k(b * h * s * d, b * s, sparsity)


def outlier_token_quant(x: torch.Tensor, bits: int, group_size: int,
                        sparsity: float) -> torch.Tensor:
    """Outliers extracted per token row, the rest fake-quantized per token,
    the outliers restored exactly."""
    b, h, s, d = x.shape
    k = _outlier_k_tokens(x, sparsity)
    cleaned, rec = outliers.extract(_to_tokens(x).float(), k)
    cleaned_q = fake_token_quant(_from_tokens(cleaned, h, d), bits,
                                 group_size)
    restored = outliers.restore(_to_tokens(cleaned_q.float()), rec)
    return _from_tokens(restored, h, d).to(x.dtype)


def outlier_channel_quant(x: torch.Tensor, bits: int, group_size: int,
                          sparsity: float) -> torch.Tensor:
    """Outliers extracted per channel row (along seq), the rest
    fake-quantized per channel, the outliers restored exactly. ``k`` follows
    the reference's per-token-row formula, capped at the row length."""
    b, h, s, d = x.shape
    k = min(_outlier_k_tokens(x, sparsity), s)
    cols = _to_tokens(x).transpose(1, 2).float()  # [b, n, s]
    cleaned, rec = outliers.extract(cols, k)
    cleaned_q = fake_channel_quant(
        _from_tokens(cleaned.transpose(1, 2), h, d), bits, group_size)
    cols_q = _to_tokens(cleaned_q.float()).transpose(1, 2)
    restored = outliers.restore(cols_q, rec)
    return _from_tokens(restored.transpose(1, 2), h, d).to(x.dtype)


def _add_lowrank_error(original: torch.Tensor, approx: torch.Tensor,
                       rank: int, loop: int, p0, generator) -> torch.Tensor:
    """approx + the rank-r power-iteration reconstruction of the error."""
    if rank <= 0:
        return approx
    err = original.float() - approx.float()
    err_lr = lowrank.low_rank_residual(err, rank, loop, p0=p0,
                                       generator=generator)
    return (approx.float() + err_lr).to(original.dtype)


def gear_token(x, bits, group_size, sparsity, rank, loop, *, p0=None,
               generator=None):
    """GEAR V path: outliers + per-token quant + low-rank error."""
    out = outlier_token_quant(x, bits, group_size, sparsity)
    return _add_lowrank_error(x, out, rank, loop, p0, generator)


def gear_channel(x, bits, group_size, sparsity, rank, loop, *, p0=None,
                 generator=None):
    """GEAR K path: outliers + per-channel quant + low-rank error."""
    out = outlier_channel_quant(x, bits, group_size, sparsity)
    return _add_lowrank_error(x, out, rank, loop, p0, generator)


def gearl_token(x, bits, group_size, rank, loop, *, p0=None, generator=None):
    """GEARL V path: per-token quant + low-rank error (no outliers)."""
    out = fake_token_quant(x, bits, group_size)
    return _add_lowrank_error(x, out, rank, loop, p0, generator)


def gearl_channel(x, bits, group_size, rank, loop, *, p0=None,
                  generator=None):
    """GEARL K path: per-channel quant + low-rank error (no outliers)."""
    out = fake_channel_quant(x, bits, group_size)
    return _add_lowrank_error(x, out, rank, loop, p0, generator)


def compress_kv(key_states: torch.Tensor, value_states: torch.Tensor,
                cfg: LayerCompressionConfig, *, prefill: bool,
                p0: P0Fn | None = None,
                generator: torch.Generator | None = None):
    """Method dispatch over a [B,H,S,D] K/V pair -> the compressed, then
    reconstructed K, V. ``p0(which, shape)`` gives the power-iteration init
    of K (``"k"``, shape [B, H, D, rank]) and of V (``"v"``); without it
    the inits come from ``generator``."""
    b, h, s, d = key_states.shape
    method = cfg.compress_method
    if method == "UNIFORM":
        method = "KIVI_V2"
    if method == "NONE":
        return key_states, value_states
    bits, g = cfg.quantize_bit, cfg.group_size
    rank, rankv = cfg.rank_for(prefill)

    lo, hi = 0, s
    if cfg.token_preserving:
        lo = int(cfg.start_saving * s)
        hi = s - int(cfg.locality_saving * s)
    k_mid, v_mid = key_states[:, :, lo:hi], value_states[:, :, lo:hi]

    def init(which, r):
        if r <= 0 or p0 is None:
            return {}
        return dict(p0=p0(which, (b, h, d, r)))

    lr_k = dict(generator=generator, **init("k", rank))
    lr_v = dict(generator=generator, **init("v", rankv))
    if method == "KIVI_V2":
        k_c = fake_channel_quant(k_mid, bits, g)
        v_c = fake_token_quant(v_mid, bits, g)
    elif method == "KCVT":
        k_c = fake_channel_quant(k_mid, bits, hi - lo)
        v_c = fake_token_quant(v_mid, bits, h * d)
    elif method == "GEAR":
        k_c = gear_channel(k_mid, bits, g, cfg.left, rank, cfg.loop, **lr_k)
        v_c = gear_token(v_mid, bits, g, cfg.left, rankv, cfg.loop, **lr_v)
    elif method == "GEAR-KCVT":
        k_c = gear_channel(k_mid, bits, hi - lo, cfg.left, rank, cfg.loop,
                           **lr_k)
        v_c = gear_token(v_mid, bits, h * d, cfg.left, rankv, cfg.loop,
                         **lr_v)
    elif method == "GEARL":
        k_c = gearl_channel(k_mid, bits, g, rank, cfg.loop, **lr_k)
        v_c = gearl_token(v_mid, bits, g, rankv, cfg.loop, **lr_v)
    elif method == "GEARL-KCVT":
        k_c = gearl_channel(k_mid, bits, hi - lo, rank, cfg.loop, **lr_k)
        v_c = gearl_token(v_mid, bits, h * d, rankv, cfg.loop, **lr_v)
    elif method == "OUTLIER":
        k_c = outlier_channel_quant(k_mid, bits, g, cfg.left)
        v_c = outlier_token_quant(v_mid, bits, g, cfg.left)
    else:
        raise ValueError(f"unknown compress_method {method!r}")

    if lo == 0 and hi == s:
        return k_c, v_c
    k_out = torch.cat([key_states[:, :, :lo], k_c, key_states[:, :, hi:]],
                      dim=2)
    v_out = torch.cat([value_states[:, :, :lo], v_c,
                       value_states[:, :, hi:]], dim=2)
    return k_out, v_out
