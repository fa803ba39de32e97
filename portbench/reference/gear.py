"""GEAR's compression of one block of keys or values, worked out plainly.

A plain float32 restatement of the GEAR recipe as the port's compressed
cache defines it (group quantization, exact outliers, low-rank error
bases), written from that definition and importing nothing of the program.
It keeps what the format stores and drops how it stores it: codes are not
packed, and a block comes back dequantized, as attention reads it.

For a block x [n, H, S, D] (S a multiple of ``group``):

  * outliers: per head and ``group``-token block, the ``outliers / 2``
    largest and ``outliers / 2`` smallest entries (the lower flat index
    first among equals) are set to the block's mean before quantization;
    afterwards each is restored as its dequantized value plus the
    difference to its exact value, stored in the model's dtype (an entry of the
    smallest set that is also in the largest adds nothing);
  * K: asymmetric ``bits``-bit codes per channel over each block's tokens;
    V: per token over ``v_group`` channels. Scale ``(max - min) / levels``
    in float32 picks the codes; the scale and minimum are stored in the
    model's dtype and dequantize them;
  * error bases: ``x - dequantized`` approximated at ``rank`` by ``loop``
    rounds of power iteration from the start ``p0`` [n, H, D, rank]
    (Gram-Schmidt on the last round), P and Q stored in the model's dtype; the block
    reads back as dequantized + Q P^T.
"""
from __future__ import annotations

import torch


def stored(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the cache stores it, in the model's ``dtype``, back in
    float32."""
    return x.to(dtype).float()


def _stable_top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, the lower index
    first among equal values."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _outliers(x: torch.Tensor, group: int, n_out: int):
    """(cleaned block, flat indices [n,H,NB,n_out], exact values, mask of
    the entries that restore) for x [n,H,S,D]."""
    n, h, s, d = x.shape
    xf = x.reshape(n, h, s // group, group * d)
    top = _stable_top(xf, n_out // 2)
    bot = _stable_top(-xf, n_out // 2)
    dup = (bot[..., :, None] == top[..., None, :]).any(dim=-1)
    idx = torch.cat([top, bot], dim=-1)
    keep = torch.cat([torch.ones_like(dup), ~dup], dim=-1)
    exact = torch.gather(xf, -1, idx)
    mean = xf.mean(dim=-1, keepdim=True)
    cleaned = xf.scatter(-1, idx, mean.expand(idx.shape))
    return cleaned.reshape(x.shape), idx, exact, keep


def _restore(xhat: torch.Tensor, group: int, dtype, idx, exact, keep):
    n, h, s, d = xhat.shape
    xf = xhat.reshape(n, h, s // group, group * d)
    at = torch.gather(xf, -1, idx)
    delta = torch.where(keep, stored(exact - at, dtype), torch.zeros_like(at))
    return xf.scatter_add(-1, idx, delta).reshape(xhat.shape)


def _quant(x: torch.Tensor, bits: int, dim: int, dtype) -> torch.Tensor:
    """Dequantized x with min/max over ``dim`` of a grouped view."""
    levels = (1 << bits) - 1
    mn = x.amin(dim=dim, keepdim=True)
    mx = x.amax(dim=dim, keepdim=True)
    scale = (mx - mn) * (1.0 / levels)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round((x - mn) / safe), 0, levels)
    return codes * stored(scale, dtype) + stored(mn, dtype)


def _thin_q(a: torch.Tensor) -> torch.Tensor:
    """Orthonormal columns of a [..., m, r] by modified Gram-Schmidt."""
    cols = []
    for i in range(a.shape[-1]):
        v = a[..., i]
        for qj in cols:
            v = v - (qj * v).sum(dim=-1, keepdim=True) * qj
        nrm = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
        cols.append(v / torch.clamp(nrm, min=1e-12))
    return torch.stack(cols, dim=-1)


def low_rank(err: torch.Tensor, rank: int, loop: int, p0: torch.Tensor,
             dtype) -> torch.Tensor:
    """Q P^T of err [n,H,S,D] at ``rank`` from the start ``p0``, with P and
    Q stored in ``dtype``."""
    p = p0.float().expand(*err.shape[:-2], err.shape[-1], rank)
    q = None
    for i in range(loop):
        last = i == loop - 1
        if last:
            p = _thin_q(p)
        q = err @ p
        if last:
            q = _thin_q(q)
        p = err.transpose(-1, -2) @ q
    return stored(q, dtype) @ stored(p, dtype).transpose(-1, -2)


def compress(x: torch.Tensor, kind: str, fmt, rank: int, loop: int,
             p0: torch.Tensor | None,
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Block x [n,H,S,D] (float32) of keys (``kind`` "k") or values ("v")
    as the cache reads it back, in float32. ``fmt`` carries ``bits``,
    ``group``, ``v_group`` and ``outliers`` (``counts.KVFormat``);
    ``dtype`` is the model's, in which the cache stores its scales,
    minima, outlier deltas and bases."""
    n, h, s, d = x.shape
    g = fmt.group
    xc, oi = x, None
    if fmt.outliers:
        xc, *oi = _outliers(x, g, fmt.outliers)
    if kind == "k":
        xhat = _quant(xc.reshape(n, h, s // g, g, d), fmt.bits, 3, dtype)
    else:
        vg = fmt.v_group
        xhat = _quant(xc.reshape(n, h, s, d // vg, vg), fmt.bits, 4, dtype)
    xhat = xhat.reshape(x.shape)
    if oi is not None:
        xhat = _restore(xhat, g, dtype, *oi)
    if rank > 0 and p0 is not None:
        xhat = xhat + low_rank(x - xhat, rank, loop, p0, dtype)
    return xhat
