"""Process groups, the named mesh and its collectives over
``torch.distributed``; the counterpart of ``gear_tpu/parallel/distributed.py``.

Every parallel path of the port runs as SPMD processes, one rank each, that
join one ``torch.distributed`` process group. A :class:`Mesh` lays the ranks
out on named axes (``data``, ``seq``, ``model``, ``expert``; the last axis
innermost) and holds one process group per axis for this rank: the ranks
that share every other coordinate.

The backend is the caller's choice and is never switched behind its back:
``nccl`` for a card per rank (``torchrun --nproc-per-node N``), ``gloo``
for ranks that share one card and for the CPU. With ``gloo`` every
collective the port needs is an ``all_reduce`` (SUM or MAX) or a
``broadcast``, the two that gloo runs on CUDA tensors (it copies them
through host memory); a gather is an ``all_reduce`` of a zero-filled buffer
(:func:`gather`).

Under ``nccl`` both collectives can be captured into a CUDA graph (gloo's
cannot: it copies through the host): :func:`capturable` says whether every
group of a mesh runs ``nccl``. :func:`collective_counts` counts the
collective calls and their bytes (a graph's replay adds its capture's,
:func:`add_collective_counts`), and each call is a ``comm.all_reduce``
span (attributes ``axis``, ``bytes``).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import profiling

AXES = ("data", "seq", "model", "expert")


def initialize_from_env(backend: str, *, init_method: str | None = None,
                        **kw) -> None:
    """Join the process group: ``torch.distributed.init_process_group`` with
    the world size and rank from ``WORLD_SIZE`` / ``RANK`` (``torchrun``
    sets them, and ``MASTER_ADDR`` / ``MASTER_PORT`` for the default
    ``env://`` rendezvous). ``init_method`` (``tcp://host:port`` or
    ``file:///path``) replaces that rendezvous; ``kw`` overrides any of
    them."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    args = dict(backend=backend, init_method=init_method or "env://",
                world_size=int(os.environ.get("WORLD_SIZE", "1")),
                rank=int(os.environ.get("RANK", "0")))
    args.update(kw)
    dist.init_process_group(**args)


class Mesh:
    """Ranks laid out on named axes, ``shape`` ``{axis: size}`` in order
    (the last axis innermost: rank = row-major index of the coordinates).

    ``coords[axis]`` is this rank's coordinate; ``group(axis)`` the process
    group of the ranks that differ from it only along ``axis`` (None for an
    axis of size 1, whose collectives are no-ops). Every rank must build the
    same meshes in the same order, because ``dist.new_group`` is collective.
    A mesh of one rank needs no process group.
    """

    def __init__(self, shape: dict[str, int]):
        unknown = set(shape) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"axes are {AXES}")
        if any(n < 1 for n in shape.values()):
            raise ValueError(f"mesh sizes must be positive: {shape}")
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the "
                             f"process group has {world}")
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.rank = rank
        sizes = tuple(self.shape.values())
        self.ranks = np.arange(self.size).reshape(sizes)
        self.coords = dict(zip(self.shape,
                               (int(c) for c in np.unravel_index(rank, sizes))))
        self._groups = {}
        for i, axis in enumerate(self.shape):
            if self.shape[axis] == 1:
                self._groups[axis] = None
                continue
            # every line of ranks along this axis, in one order on all ranks
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, sizes[i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._groups[axis] = g

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 where it is absent)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)


_counts = {"calls": 0, "bytes": 0}


def collective_counts() -> dict[str, int]:
    """Collective calls made by this process since the last reset, and the
    bytes they reduced (each call's tensor once)."""
    return dict(_counts)


def reset_collective_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def add_collective_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` to :func:`collective_counts`: the collectives of a
    CUDA graph's replay, which no call makes."""
    for k, n in counts.items():
        _counts[k] += n


def capturable(mesh) -> bool:
    """Whether a CUDA graph can hold the collectives of ``mesh``: every
    group of a :class:`Mesh` of more than one rank runs ``nccl``."""
    if not isinstance(mesh, Mesh):
        return False
    groups = [g for g in mesh._groups.values() if g is not None]
    return bool(groups) and all(dist.get_backend(g) == "nccl"
                                for g in groups)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``sum`` or ``max``) over ``axis``, in place, and
    returned. A no-op along an axis of size 1."""
    if mesh.axis_size(axis) > 1:
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        nbytes = x.numel() * x.element_size()
        with profiling.span("comm.all_reduce", axis=axis, bytes=nbytes):
            dist.all_reduce(x, op=red, group=mesh.group(axis))
        _counts["calls"] += 1
        _counts["bytes"] += nbytes
    return x


def gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole of a tensor of which every rank along ``axis`` holds the
    slice ``x`` along ``dim``, in rank order: one ``all_reduce`` of a
    zero-filled buffer (gloo has no ``all_gather`` of CUDA tensors)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    part = shape[dim]
    shape[dim] = part * n
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, mesh.index(axis) * part, part).copy_(x)
    return all_reduce(full, mesh, axis)


def pod_mesh(model_parallel: int, seq_parallel: int = 1) -> Mesh:
    """The (data, seq, model) mesh over every rank of the process group:
    ``model`` innermost, so a tensor-parallel group is consecutive ranks
    (one host's cards under ``torchrun``), ``data`` outermost."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % (model_parallel * seq_parallel):
        raise ValueError(
            f"{world} ranks not divisible by model*seq = "
            f"{model_parallel * seq_parallel}")
    data = world // (model_parallel * seq_parallel)
    return Mesh({"data": data, "seq": seq_parallel, "model": model_parallel})


def describe(mesh: Mesh) -> str:
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return (f"mesh {dict(mesh.shape)} over {mesh.size} ranks "
            f"({backend} backend), rank {mesh.rank} at {mesh.coords}")
