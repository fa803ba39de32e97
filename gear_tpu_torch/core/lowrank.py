"""Batched low-rank approximation of quantization error via power iteration.

PyTorch port of ``gear_tpu/core/lowrank.py``. The result satisfies
``X ~= Q @ P^T`` with Q orthonormal columns ([..., s, r]) and
``P = X^T Q`` ([..., d, r]). Math runs in float32.

On a CUDA device these products must run in full float32: TF32 keeps about
three decimal digits, which would move the error bases well away from the
reference. :func:`power_iterate` therefore turns
``torch.backends.cuda.matmul.allow_tf32`` off while it multiplies on the
card, and restores the caller's setting afterwards.
"""
from __future__ import annotations

import torch


def power_iterate(x: torch.Tensor, rank: int, n_iter: int, *,
                  p0: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """Rank-``rank`` approximation of ``x`` [..., s, d] -> (P [..., d, r], Q [..., s, r]).

    ``n_iter`` alternating multiplications; thin-QR on the final iteration
    only (the reference schedule). ``p0`` injects the initial P basis
    [..., d, rank] (the parity tests feed both packages the same draws);
    without it the init is uniform [0, 1) from ``generator``.
    """
    if rank <= 0 or n_iter <= 0:
        raise ValueError("rank and n_iter must be positive")
    if not x.is_cuda:
        return _power_iterate(x, rank, n_iter, p0, generator)
    matmul = torch.backends.cuda.matmul
    allow_tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        return _power_iterate(x, rank, n_iter, p0, generator)
    finally:
        matmul.allow_tf32 = allow_tf32


def _power_iterate(x, rank, n_iter, p0, generator):
    *batch, s, d = x.shape
    xf = x.float()
    if p0 is not None:
        p = p0.to(device=x.device, dtype=torch.float32).expand(*batch, d, rank)
    else:
        p = torch.rand((*batch, d, rank), generator=generator,
                       device=x.device, dtype=torch.float32)
    q = None
    for i in range(n_iter):
        last = i == n_iter - 1
        if last:
            p = _thin_qr_q(p)
        q = xf @ p
        if last:
            q = _thin_qr_q(q)
        p = xf.transpose(-1, -2) @ q
    return p, q


def _thin_qr_q(a: torch.Tensor) -> torch.Tensor:
    """Q factor of a thin QR, batched over leading dims.

    For the ranks GEAR uses (r <= 8) this is a modified Gram-Schmidt
    unrolled over the columns, as in the reference; ``torch.linalg.qr``
    (Householder) would give other column signs.
    """
    r = a.shape[-1]
    if r > 8:
        return torch.linalg.qr(a, mode="reduced")[0]
    af = a.float()
    cols = []
    for i in range(r):
        v = af[..., i]
        for qj in cols:
            v = v - (qj * v).sum(dim=-1, keepdim=True) * qj
        nrm = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
        cols.append(v / torch.clamp(nrm, min=1e-12))
    return torch.stack(cols, dim=-1)


def reconstruct(p: torch.Tensor, q: torch.Tensor, dtype=None) -> torch.Tensor:
    """``Q @ P^T`` -> [..., s, d]."""
    out = q @ p.transpose(-1, -2)
    return out if dtype is None else out.to(dtype)


def low_rank_residual(x: torch.Tensor, rank: int, n_iter: int, *,
                      p0: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
    """The rank-``rank`` reconstruction ``Q @ P^T`` of ``x`` [..., s, d] in
    ``x.dtype``; the init as :func:`power_iterate` takes it."""
    p, q = power_iterate(x, rank, n_iter, p0=p0, generator=generator)
    return reconstruct(p, q, dtype=x.dtype)
