"""The port's state trees, walked in the order ``jax.tree.flatten`` walks
the same state in gear_tpu, with the paths ``jax.tree_util.keystr`` gives.

A tree is a tensor, a ``cache.LayerCache``, a ``models.llama.RawLayerCache``,
``None`` (no leaves), or a dict (keys in sorted order), list or tuple of
trees. A cache's leaves are its tensors in field order, then its lengths:
host ints in the port, int32 leaves in gear_tpu (shape ``()`` for one layer,
``[L]`` for a stack of ``L`` layers), so a length is handed over with the
depth of its stack.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..cache import LENGTH_FIELDS, TENSOR_FIELDS, LayerCache
from ..models.llama import RawLayerCache

# leaf(path, value, layers) -> new value; ``layers`` is the depth of a
# length's stack (None for one layer), and None for a tensor
LeafFn = Callable[[str, Any, "int | None"], Any]


def _depth(t: torch.Tensor) -> int | None:
    """Layers in the stack of a cache whose ``k_codes`` / ``k`` is ``t``
    (rank 4 for one layer, rank 5 stacked); None for one layer."""
    return t.shape[0] if t.dim() == 5 else None


def walk(tree, leaf: LeafFn, path: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``leaf(path, value,
    layers)``, the leaves visited in gear_tpu's flatten order."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return leaf(path, tree, None)
    if isinstance(tree, LayerCache):
        n = _depth(tree.k_codes)
        return LayerCache(
            **{f: leaf(f"{path}.{f}", getattr(tree, f), None)
               for f in TENSOR_FIELDS},
            **{f: leaf(f"{path}.{f}", getattr(tree, f), n)
               for f in LENGTH_FIELDS})
    if isinstance(tree, RawLayerCache):
        return RawLayerCache(k=leaf(f"{path}.k", tree.k, None),
                             v=leaf(f"{path}.v", tree.v, None),
                             length=leaf(f"{path}.length", tree.length,
                                         _depth(tree.k)))
    if isinstance(tree, dict):
        return {k: walk(tree[k], leaf, f"{path}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(x, leaf, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    raise TypeError(f"not a tree of the port: {type(tree).__name__} at "
                    f"{path or 'the root'}")
