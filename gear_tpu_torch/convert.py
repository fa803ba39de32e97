"""Carry weights and cache state across from the JAX package, as numpy.

Everything here speaks numpy only (``np.asarray`` of the JAX leaves one
way, arrays to wrap with ``jnp.asarray`` the other), so the port never
imports JAX. bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) are carried
bit for bit. With :func:`cache_from_numpy` and :func:`cache_to_numpy` a
cache built by either package can be handed to the other's ``attend``; with
the ``pool_*`` and ``seqs_*`` functions the same holds for a page pool and
its sequences.
"""
from __future__ import annotations

import numpy as np
import torch

from .cache import LENGTH_FIELDS, TENSOR_FIELDS, LayerCache
from .paged import POOL_FIELDS, PagedSeqs, PagePool


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device)


def params_from_numpy(tree: dict, *, device="cpu") -> dict:
    """The JAX parameter pytree as numpy (layers stacked on a leading axis,
    ``gear_tpu.models.llama.init_params`` layout) -> the port's params."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device=device)
        else:
            out[k] = _tensor(v, device)
    return out


def cache_from_numpy(fields: dict, *, device="cpu") -> LayerCache:
    """A dict of ``gear_tpu.cache.LayerCache`` fields as numpy (one layer, or
    stacked layers) -> the port's LayerCache. Lengths become host ints."""
    return LayerCache(
        **{f: _tensor(fields[f], device) for f in TENSOR_FIELDS},
        **{f: int(np.asarray(fields[f]).reshape(-1)[0]) for f in LENGTH_FIELDS})


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; not part of JAX

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def cache_to_numpy(cache: LayerCache) -> dict:
    """The port's LayerCache (one layer, or stacked) -> a dict of numpy
    arrays with the field names and shapes of ``gear_tpu.cache.LayerCache``;
    lengths become int32 scalars."""
    out = {f: _array(getattr(cache, f)) for f in TENSOR_FIELDS}
    out.update({f: np.int32(getattr(cache, f)) for f in LENGTH_FIELDS})
    return out


def pool_from_numpy(fields: dict, *, device="cpu") -> PagePool:
    """A dict of ``gear_tpu.paged.PagePool`` leaves as numpy (one layer, or
    stacked layers) -> the port's PagePool."""
    return PagePool(**{f: _tensor(fields[f], device) for f in POOL_FIELDS})


def pool_to_numpy(pool: PagePool) -> dict:
    """The port's PagePool -> a dict of numpy arrays with the leaf names and
    shapes of ``gear_tpu.paged.PagePool``."""
    return {f: _array(getattr(pool, f)) for f in POOL_FIELDS}


def seqs_from_numpy(fields: dict, *, device="cpu") -> PagedSeqs:
    """A dict of ``gear_tpu.paged.PagedSeqs`` fields as numpy (block_table
    [B, MAXP], comp_len / resid_len / prefill_len [B], k_resid / v_resid) ->
    the port's PagedSeqs, host mirrors included."""
    table = np.array(fields["block_table"], dtype=np.int32)
    lens = np.stack([np.asarray(fields[f], dtype=np.int32)
                     for f in LENGTH_FIELDS], axis=1)
    return PagedSeqs(
        block_table=_tensor(table, device), lens=_tensor(lens, device),
        k_resid=_tensor(fields["k_resid"], device),
        v_resid=_tensor(fields["v_resid"], device),
        host_table=table.copy(), host_lens=lens.copy())


def seqs_to_numpy(seqs: PagedSeqs) -> dict:
    """The port's PagedSeqs -> a dict of numpy arrays with the field names
    and shapes of ``gear_tpu.paged.PagedSeqs``."""
    out = {"block_table": _array(seqs.block_table),
           "k_resid": _array(seqs.k_resid), "v_resid": _array(seqs.v_resid)}
    lens = _array(seqs.lens)
    out.update({f: lens[:, i].copy() for i, f in enumerate(LENGTH_FIELDS)})
    return out
