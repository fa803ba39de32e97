"""Sparse outlier extraction and restoration with fixed shapes.

PyTorch port of ``gear_tpu/core/outliers.py``: per row of ``[..., n]`` the k
smallest and k largest entries are replaced by the row mean before
quantization and written back exactly afterwards, with
``k = int(total_elems * sparsity) / rows / 2``.

Ties. ``jax.lax.top_k`` returns the lower index first among equal values;
``torch.topk`` promises no order. :func:`top_k_stable` therefore takes the
first k of a stable descending sort, which keeps the reference's choice
(K/V rounded to bf16 tie often, and the choice decides which positions
become outliers).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Outliers(NamedTuple):
    """Fixed-size COO record of extracted outliers (per row of [..., n]).

    values/indices: [..., 2*k] — first k are the smallest entries, last k the
    largest. Empty (k == 0) records have trailing dim 0.
    """

    values: torch.Tensor
    indices: torch.Tensor  # int32


def outlier_k(total_elems: int, rows: int, sparsity: float) -> int:
    """k per row per side: ``int(total * sparsity) / rows / 2``."""
    return int(int(total_elems * sparsity) / rows / 2)


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest entries along the last dim, in descending order, the
    lower index first among equal values -> (values, indices int64)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def extract(x: torch.Tensor, k: int) -> tuple[torch.Tensor, Outliers]:
    """Replace the k smallest and k largest entries per row with the row mean.

    x: [..., n]. Returns (x_cleaned, Outliers).
    """
    if k == 0:
        empty = x.new_zeros((*x.shape[:-1], 0))
        return x, Outliers(empty, empty.to(torch.int32))
    lo_v, lo_i = top_k_stable(-x, k)
    hi_v, hi_i = top_k_stable(x, k)
    values = torch.cat([-lo_v, hi_v], dim=-1)
    indices = torch.cat([lo_i, hi_i], dim=-1)
    mean = x.mean(dim=-1, keepdim=True)
    cleaned = x.scatter(-1, indices, mean.expand(indices.shape))
    return cleaned, Outliers(values, indices.to(torch.int32))


def restore(x: torch.Tensor, outliers: Outliers) -> torch.Tensor:
    """Write the exact outlier values back into their positions."""
    if outliers.values.shape[-1] == 0:
        return x
    return x.scatter(-1, outliers.indices.to(torch.int64),
                     outliers.values.to(x.dtype))
