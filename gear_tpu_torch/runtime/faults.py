"""Numeric-fault detection (NaN / Inf) over caches, params and activations,
PyTorch port of ``gear_tpu/runtime/faults.py``.

The counts are keyed by the paths gear_tpu gives the same tree
(``"['layers']['wq']"``, ``".k_scale"``), so a report reads the same from
either package. Counting stays on the device; :func:`check_or_raise` and
:func:`guard` read the counts on the host.
"""
from __future__ import annotations

import torch

from .tree import walk


def tree_nonfinite_counts(tree) -> dict:
    """Per floating leaf, the count of non-finite values (a 0-d tensor on
    the leaf's device; no sync)."""
    out = {}

    def count(path, x, _layers):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            out[path] = (~torch.isfinite(x)).sum()
        return x

    walk(tree, count)
    return out


def tree_is_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf fully finite (no sync)."""
    ok = None

    def fold(_path, x, _layers):
        nonlocal ok
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            f = torch.isfinite(x).all()
            ok = f if ok is None else ok & f.to(ok.device)
        return x

    walk(tree, fold)
    return torch.tensor(True) if ok is None else ok


def check_or_raise(tree, where: str = "") -> None:
    """Raise ``FloatingPointError`` naming the leaves with non-finite
    values. Reads the counts on the host: it synchronises."""
    counts = {k: int(v) for k, v in tree_nonfinite_counts(tree).items()}
    bad = {k: v for k, v in counts.items() if v}
    if bad:
        raise FloatingPointError(f"non-finite values {where}: {bad}")


def guard(tree, where: str = ""):
    """Print a line when ``tree`` holds non-finite values, and return the
    tree unchanged. PyTorch has no in-graph callback, so unlike gear_tpu's
    ``guard`` this reads the check on the host: it synchronises."""
    if not bool(tree_is_finite(tree)):
        print(f"[gear_tpu_torch.faults] non-finite values detected {where}")
    return tree
