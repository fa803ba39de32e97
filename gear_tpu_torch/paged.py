"""Paged compressed KV cache: a physical page pool plus per-sequence block
tables over the two-tier GEAR cache. PyTorch port of ``gear_tpu/paged.py``.

  * one page (``page_blocks`` quant blocks = ``page_blocks * group`` tokens)
    holds every compressed leaf of that token range, for all kv heads of one
    layer: a page is the slice ``pool.leaf[pid]``;
  * a sequence is a block table (int32 page ids, -1 = unallocated), its
    dense residual tier (``group`` tokens) and three lengths; appends touch
    only the residual until a flush writes one block into the tail page;
  * pages come from a refcounted free list (``native/pager.cc`` through
    ctypes when built, else the same list in Python);
  * attention reads the pages through the table: the CUDA kernel
    (``kernels.decode.attend_paged``) straight from the pool,
    :func:`attend_gathered` after gathering each row into a dense cache.

Pool leaves carry ``[P, H, ...]`` where the dense ``LayerCache`` carries
``[B, H, ...]``, with the names, shapes and dtypes of the JAX package's pool.

What differs from the JAX package:

  * In-place updates: ``prefill_paged`` and ``append_paged`` write into the
    pool and the sequences they are given and return those same objects.
  * Lengths and block tables live twice. The host arrays
    (``PagedSeqs.host_lens``, ``host_table``) are the truth for control flow:
    who flushes, which page is the tail, how large the kernel's grid must
    be. The device tensors (``lens``, ``block_table``) are what the kernel
    and the residual write read. Both change together, by small in-place
    writes, so a decode step needs no device-to-host fetch for them. The
    flush is a Python ``if`` per row on the host lengths.
  * The power-iteration inits come from ``p0(row, which, shape)`` (``which``
    is ``"k"`` or ``"v"``), else from a ``torch.Generator``.
  * A live row whose residual tier is full and whose tail page is missing
    raises on its next append (the JAX package clamps the write).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import cache as kvcache
from .cache import CacheSpec

RowP0Fn = Callable[[int, str, tuple], torch.Tensor]

COMP, RESID, PREFILL = 0, 1, 2   # columns of ``lens``


@dataclass(frozen=True)
class PagedSpec:
    """Static description of a paged pool for one layer."""

    spec: CacheSpec          # per-sequence spec; max_len = logical capacity
    n_pages: int             # physical pages in the pool
    page_blocks: int = 16    # quant blocks per page (tokens = * group)

    def __post_init__(self):
        if self.spec.n_blocks % self.page_blocks:
            raise ValueError("max_len must be a multiple of the page extent")

    @property
    def page_tokens(self) -> int:
        return self.page_blocks * self.spec.group

    @property
    def max_pages_per_seq(self) -> int:
        return self.spec.n_blocks // self.page_blocks


# Leaves whose page axis is followed by [H, X, PT] (tokens last), by
# [H, PB, ...] (blocks third) and by [H, R, PB] (blocks last).
TOKEN_LEAVES = ("k_codes", "v_codes", "v_scale", "v_mn", "kqt", "vqt")
BLOCK_LEAVES = ("k_scale", "k_mn", "kpt", "vpt", "kpt_scale", "vpt_scale")
BLOCK_LANE_LEAVES = ("kqt_scale", "vqt_scale")
OUTLIER_LEAVES = ("k_out_idx", "k_out_val", "v_out_idx", "v_out_val",
                  "k_out_bnd", "v_out_bnd")   # [H, PB, ...] as BLOCK_LEAVES
POOL_FIELDS = TOKEN_LEAVES + BLOCK_LEAVES + BLOCK_LANE_LEAVES + OUTLIER_LEAVES


@dataclass
class PagePool:
    """Physical storage: every leaf has a leading page axis ``[P, H, ...]``
    (and, stacked over layers, ``[L, P, H, ...]``)."""

    k_codes: torch.Tensor   # int32 [P, H, D//fpi, PT]
    k_scale: torch.Tensor   # [P, H, PB, D]
    k_mn: torch.Tensor      # [P, H, PB, D]
    v_codes: torch.Tensor   # int32 [P, H, D//fpi, PT]
    v_scale: torch.Tensor   # [P, H, NGV, PT]
    v_mn: torch.Tensor      # [P, H, NGV, PT]
    kpt: torch.Tensor       # [P, H, PB, R, D]
    kqt: torch.Tensor       # [P, H, R, PT]
    vpt: torch.Tensor       # [P, H, PB, R, D]
    vqt: torch.Tensor       # [P, H, R, PT]
    # COO outlier deltas, block-major (``cache.LayerCache`` convention);
    # zero-size without outliers.
    k_out_idx: torch.Tensor  # int32 [P, H, PB, KO // 2]
    k_out_val: torch.Tensor  # [P, H, PB, KO]
    v_out_idx: torch.Tensor
    v_out_val: torch.Tensor
    k_out_bnd: torch.Tensor  # int32 [P, H, PB, 128]
    v_out_bnd: torch.Tensor
    # int8-base scales (all ones at base_bits 16).
    kpt_scale: torch.Tensor  # f32 [P, H, PB, R]
    kqt_scale: torch.Tensor  # f32 [P, H, R, PB]
    vpt_scale: torch.Tensor
    vqt_scale: torch.Tensor

    def layer(self, i: int) -> "PagePool":
        """Layer ``i`` of a stacked pool, as views."""
        return PagePool(**{f: getattr(self, f)[i] for f in POOL_FIELDS})

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in POOL_FIELDS)


@dataclass
class PagedSeqs:
    """Per-sequence logical state of a batch of B sequences.

    ``lens[b] = (comp_len, resid_len, prefill_len)``; ``comp_len`` and its
    siblings are views of its columns. Change lengths and table entries only
    through the ``set_*`` methods, which keep host and device copies equal.
    They write the device copy with ``fill_`` (a kernel launch): assigning a
    Python number to an element of a CUDA tensor copies it from the host
    and synchronises.
    """

    block_table: torch.Tensor  # int32 [B, MAXP]; entries < 0 are unallocated
    lens: torch.Tensor         # int32 [B, 3]
    k_resid: torch.Tensor      # [B, H, group, D] (a leading layer axis if stacked)
    v_resid: torch.Tensor
    host_table: np.ndarray     # int32 [B, MAXP]
    host_lens: np.ndarray      # int32 [B, 3]

    @property
    def comp_len(self) -> torch.Tensor:
        return self.lens[:, COMP]

    @property
    def resid_len(self) -> torch.Tensor:
        return self.lens[:, RESID]

    @property
    def prefill_len(self) -> torch.Tensor:
        return self.lens[:, PREFILL]

    @property
    def batch(self) -> int:
        return self.host_lens.shape[0]

    def layer(self, i: int) -> "PagedSeqs":
        """The sequences with layer ``i`` of a stacked residual tier; tables
        and lengths are shared, not copied."""
        return PagedSeqs(self.block_table, self.lens, self.k_resid[i],
                         self.v_resid[i], self.host_table, self.host_lens)

    def set_lengths(self, row: int, comp: int, resid: int,
                    prefill: int | None = None) -> None:
        if prefill is None:
            prefill = int(self.host_lens[row, PREFILL])
        self.host_lens[row] = (comp, resid, prefill)
        self.lens[row, COMP].fill_(comp)
        self.lens[row, RESID].fill_(resid)
        self.lens[row, PREFILL].fill_(prefill)

    def set_page(self, row: int, idx: int, pid: int) -> None:
        self.host_table[row, idx] = pid
        self.block_table[row, idx].fill_(pid)

    def set_table_row(self, row: int, page_ids) -> None:
        """Point row ``row`` at ``page_ids`` (the rest unallocated)."""
        n = len(page_ids)
        self.host_table[row] = -1
        self.host_table[row, :n] = page_ids
        self.block_table[row].fill_(-1)
        if n:
            self.block_table[row, :n] = torch.from_numpy(
                self.host_table[row, :n]).to(self.block_table.device)


def init_pool(pspec: PagedSpec, device=None,
              num_layers: int | None = None) -> PagePool:
    """An empty pool (with a leading layer axis if ``num_layers`` is given)."""
    s = pspec.spec
    p, h, d, pt, pb = (pspec.n_pages, s.num_kv_heads, s.head_dim,
                       pspec.page_tokens, pspec.page_blocks)
    sb, r, bdt = s.sideband_dtype, s.r_store, s.base_dtype
    lead = () if num_layers is None else (num_layers,)

    def z(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(lead + shape, dtype=torch.float32, device=device)

    return PagePool(
        k_codes=z((p, h, s.v_words, pt), torch.int32),
        k_scale=z((p, h, pb, d), sb),
        k_mn=z((p, h, pb, d), sb),
        v_codes=z((p, h, s.v_words, pt), torch.int32),
        v_scale=z((p, h, s.v_groups_per_token, pt), sb),
        v_mn=z((p, h, s.v_groups_per_token, pt), sb),
        kpt=z((p, h, pb, r, d), bdt),
        kqt=z((p, h, r, pt), bdt),
        vpt=z((p, h, pb, r, d), bdt),
        vqt=z((p, h, r, pt), bdt),
        k_out_idx=z((p, h, pb, s.ko_store // 2), torch.int32),
        k_out_val=z((p, h, pb, s.ko_store), s.dtype),
        v_out_idx=z((p, h, pb, s.ko_store // 2), torch.int32),
        v_out_val=z((p, h, pb, s.ko_store), s.dtype),
        k_out_bnd=z((p, h, pb, s.bnd_lanes), torch.int32),
        v_out_bnd=z((p, h, pb, s.bnd_lanes), torch.int32),
        kpt_scale=ones((p, h, pb, r)),
        kqt_scale=ones((p, h, r, pb)),
        vpt_scale=ones((p, h, pb, r)),
        vqt_scale=ones((p, h, r, pb)),
    )


def init_seqs(pspec: PagedSpec, batch: int, device=None,
              num_layers: int | None = None) -> PagedSeqs:
    s = pspec.spec
    lead = () if num_layers is None else (num_layers,)
    shape = lead + (batch, s.num_kv_heads, s.group, s.head_dim)
    maxp = pspec.max_pages_per_seq
    return PagedSeqs(
        block_table=torch.full((batch, maxp), -1, dtype=torch.int32,
                               device=device),
        lens=torch.zeros((batch, 3), dtype=torch.int32, device=device),
        k_resid=torch.zeros(shape, dtype=s.dtype, device=device),
        v_resid=torch.zeros(shape, dtype=s.dtype, device=device),
        host_table=np.full((batch, maxp), -1, np.int32),
        host_lens=np.zeros((batch, 3), np.int32),
    )


# ---------------------------------------------------------------------------
# Page allocator (native C++ when built, else the same free list in Python).
# ---------------------------------------------------------------------------

def _load_pager():
    path = Path(__file__).resolve().parents[1] / "native" / "libgearpager.so"
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.gear_pager_create.restype = ctypes.c_void_p
    lib.gear_pager_create.argtypes = [ctypes.c_int]
    lib.gear_pager_destroy.argtypes = [ctypes.c_void_p]
    lib.gear_pager_alloc.restype = ctypes.c_int
    lib.gear_pager_alloc.argtypes = [ctypes.c_void_p]
    lib.gear_pager_retain.restype = ctypes.c_int
    lib.gear_pager_retain.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gear_pager_release.restype = ctypes.c_int
    lib.gear_pager_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gear_pager_free_count.restype = ctypes.c_int
    lib.gear_pager_free_count.argtypes = [ctypes.c_void_p]
    return lib


_PAGER_LIB = None


class PageAllocator:
    """Refcounted page free list. Native (``native/pager.cc``) when built."""

    def __init__(self, n_pages: int):
        global _PAGER_LIB
        if _PAGER_LIB is None:
            _PAGER_LIB = _load_pager() or False
        self._lib = _PAGER_LIB or None
        self.n_pages = n_pages
        if self._lib:
            self._h = self._lib.gear_pager_create(n_pages)
        else:
            self._free = list(range(n_pages - 1, -1, -1))
            self._refs = [0] * n_pages

    @property
    def native(self) -> bool:
        return self._lib is not None

    def alloc(self) -> int:
        """-> page id, or -1 if the pool is exhausted."""
        if self._lib:
            return self._lib.gear_pager_alloc(self._h)
        if not self._free:
            return -1
        pid = self._free.pop()
        self._refs[pid] = 1
        return pid

    def retain(self, pid: int) -> int:
        """Increment the refcount (shared prefix). New count, or -1."""
        if self._lib:
            return self._lib.gear_pager_retain(self._h, pid)
        if self._refs[pid] <= 0:
            return -1
        self._refs[pid] += 1
        return self._refs[pid]

    def release(self, pid: int) -> int:
        """Decrement the refcount; frees the page at zero. New count."""
        if self._lib:
            return self._lib.gear_pager_release(self._h, pid)
        if self._refs[pid] <= 0:
            return -1
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            self._free.append(pid)
        return self._refs[pid]

    def free_count(self) -> int:
        if self._lib:
            return self._lib.gear_pager_free_count(self._h)
        return len(self._free)

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            self._lib.gear_pager_destroy(self._h)


# ---------------------------------------------------------------------------
# Writing compressed blocks into pages.
# ---------------------------------------------------------------------------

def _scatter_prefix_into_pages(pspec: PagedSpec, pool: PagePool,
                               dense: kvcache.LayerCache, row: int,
                               page_ids: list[int], n_pages_used: int) -> None:
    """Copy row ``row`` of a dense cache's compressed prefix into the pages
    ``page_ids[:n_pages_used]``, in place. Pool and cache are either one
    layer's or both stacked over layers: one indexed copy per leaf writes
    every page (and layer) at once."""
    if n_pages_used == 0:
        return
    pt, pb = pspec.page_tokens, pspec.page_blocks
    lead = pool.k_codes.dim() - 4          # 1 if stacked over layers
    pids = torch.tensor(page_ids[:n_pages_used], dtype=torch.int64).to(
        pool.k_codes.device)
    leaves = TOKEN_LEAVES + BLOCK_LEAVES + BLOCK_LANE_LEAVES
    if pspec.spec.outliers_per_block:
        leaves += OUTLIER_LEAVES
    for name in leaves:
        src = getattr(dense, name).select(lead, row)      # [L?, H, ...]
        # the axis that pages cut, and a page's extent along it
        if name in TOKEN_LEAVES:
            axis, ext = src.dim() - 1, pt
        elif name in BLOCK_LANE_LEAVES:
            axis, ext = src.dim() - 1, pb
        else:
            axis, ext = lead + 1, pb
        src = src.narrow(axis, 0, n_pages_used * ext)
        src = src.unflatten(axis, (n_pages_used, ext)).movedim(axis, lead)
        getattr(pool, name).index_copy_(lead, pids, src)  # [L?, n, H, ...]


def prefill_paged(pspec: PagedSpec, pool: PagePool, seqs: PagedSeqs, row: int,
                  page_ids: list[int], k: torch.Tensor, v: torch.Tensor, *,
                  p0: kvcache.P0Fn | None = None,
                  generator: torch.Generator | None = None,
                  use_lowrank: bool = True) -> tuple[PagePool, PagedSeqs]:
    """Compress a prompt k/v [1, H, S, D] and place it into pages for
    sequence ``row``, in place.

    ``page_ids`` must cover ceil((S // group) / page_blocks) pages (from
    :class:`PageAllocator`). The tail lands in the residual tier. Goes
    through the dense ``cache.prefill`` (on the card: the pack kernels),
    then scatters.
    """
    spec = pspec.spec
    dense = kvcache.prefill(spec, k, v, p0=p0, generator=generator,
                            use_lowrank=use_lowrank)
    n_full_blocks = k.shape[2] // spec.group
    n_pages_used = -(-n_full_blocks // pspec.page_blocks)
    if n_pages_used > len(page_ids):
        raise ValueError("not enough pages for prompt")
    _scatter_prefix_into_pages(pspec, pool, dense, 0, page_ids, n_pages_used)
    seqs.set_table_row(row, page_ids[:n_pages_used])
    seqs.set_lengths(row, dense.comp_len, dense.resid_len, dense.prefill_len)
    seqs.k_resid[row] = dense.k_resid[0]
    seqs.v_resid[row] = dense.v_resid[0]
    return pool, seqs


@dataclass
class AppendPlan:
    """What one decode step's append does, decided on the host."""

    rows: torch.Tensor       # int64 [B] arange (device)
    write_idx: torch.Tensor  # int64 [B] residual slot each row writes (device)
    live: torch.Tensor       # bool [B] (device)
    # (row, comp_len before the flush, page id, block offset in the page)
    flushes: list[tuple[int, int, int, int]]


def plan_append(pspec: PagedSpec, seqs: PagedSeqs, live=None, *,
                live_dev: torch.Tensor | None = None) -> AppendPlan:
    """Advance every live row's lengths by one token (host and device) and
    say where the token goes and which rows flush.

    All layers of a model share the lengths, so a decode step plans once and
    applies the plan per layer (:func:`apply_append`). ``live`` is a host
    bool sequence (None: all live); ``live_dev`` the same mask on the device
    if the caller keeps one (else it is uploaded).
    """
    spec, g, pb = pspec.spec, pspec.spec.group, pspec.page_blocks
    b = seqs.batch
    dev = seqs.lens.device
    live = np.ones((b,), bool) if live is None else np.asarray(live, bool)
    if live_dev is None:
        live_dev = torch.from_numpy(live).to(dev)
    hl = seqs.host_lens
    if (live & (hl[:, RESID] >= g)).any():
        raise ValueError(
            "append to a row whose residual tier is full and whose tail "
            "page was never allocated")
    write_idx = seqs.lens[:, RESID].to(torch.int64)   # a copy, before the step
    seqs.lens[:, RESID] += live_dev.to(torch.int32)
    hl[:, RESID] += live
    flushes = []
    for row in np.nonzero(live & (hl[:, RESID] == g))[0].tolist():
        comp = int(hl[row, COMP])
        blk = comp // g
        if blk // pb >= pspec.max_pages_per_seq:
            raise ValueError(
                f"compressed cache full: flushing {g} tokens at comp_len "
                f"{comp} exceeds max_len {spec.max_len}")
        pid = int(seqs.host_table[row, blk // pb])
        if pid < 0:
            continue  # no tail page: the row keeps its full residual tier
        flushes.append((row, comp, pid, blk % pb))
        seqs.set_lengths(row, comp + g, 0)
    return AppendPlan(rows=torch.arange(b, device=dev), write_idx=write_idx,
                      live=live_dev, flushes=flushes)


def apply_append(pspec: PagedSpec, pool: PagePool, seqs: PagedSeqs,
                 k_new: torch.Tensor, v_new: torch.Tensor, plan: AppendPlan,
                 *, p0: RowP0Fn | None = None,
                 generator: torch.Generator | None = None,
                 use_lowrank: bool = True) -> None:
    """Write one layer's new k/v [B, H, 1, D] into the residual tier and
    flush the planned rows into their tail pages, in place."""
    spec = pspec.spec
    g = spec.group
    keep = plan.live[:, None, None]
    for resid, new in ((seqs.k_resid, k_new), (seqs.v_resid, v_new)):
        # one indexed write for all rows; a parked row keeps what it had
        idx = (plan.rows, slice(None), plan.write_idx.clamp(max=g - 1))
        resid[idx] = torch.where(keep, new[:, :, 0].to(spec.dtype), resid[idx])

    for row, _, pid, off in plan.flushes:
        kb = seqs.k_resid[row:row + 1].float()
        vb = seqs.v_resid[row:row + 1].float()
        k_pack, k_scale, k_mn, ko_i, ko_v, ko_b = \
            kvcache._compress_k_block(spec, kb)
        v_pack, v_scale, v_mn, vo_i, vo_v, vo_b = \
            kvcache._compress_v_block(spec, vb)
        tok = slice(off * g, (off + 1) * g)

        def upd_tok(leaf, val):      # [P, H, X, PT] <- [1, H, X, g]
            leaf[pid, :, :, tok] = val[0]

        def upd_blk(leaf, val):      # [P, H, PB, ...] <- [1, H, 1, ...]
            leaf[pid, :, off] = val[0, :, 0]

        upd_tok(pool.k_codes, k_pack)
        upd_tok(pool.v_codes, v_pack)
        upd_tok(pool.v_scale, v_scale)
        upd_tok(pool.v_mn, v_mn)
        upd_blk(pool.k_scale, k_scale)
        upd_blk(pool.k_mn, k_mn)
        if spec.outliers_per_block:
            upd_blk(pool.k_out_idx, ko_i)
            upd_blk(pool.k_out_val, ko_v)
            upd_blk(pool.v_out_idx, vo_i)
            upd_blk(pool.v_out_val, vo_v)
            upd_blk(pool.k_out_bnd, ko_b)
            upd_blk(pool.v_out_bnd, vo_b)
        if use_lowrank and max(spec.rank, spec.rank_v_eff) > 0:
            row_p0 = None if p0 is None else (
                lambda which, shape, row=row: p0(row, which, shape))
            k_hat = kvcache._dequant_k_block(spec, k_pack, k_scale, k_mn,
                                             ko_i, ko_v)
            v_hat = kvcache._dequant_v_block(spec, v_pack, v_scale, v_mn,
                                             vo_i, vo_v)
            kp, kqt, kps, kqs = kvcache._error_bases(
                spec, kb, k_hat, spec.rank, "k", row_p0, generator)
            vp, vqt, vps, vqs = kvcache._error_bases(
                spec, vb, v_hat, spec.rank_v_eff, "v", row_p0, generator)
            upd_tok(pool.kqt, kqt)
            upd_tok(pool.vqt, vqt)
            pool.kpt[pid, :, off] = kp.transpose(-1, -2)[0]
            pool.vpt[pid, :, off] = vp.transpose(-1, -2)[0]
            if spec.base_bits == 8:
                pool.kpt_scale[pid, :, off] = kps[0]
                pool.vpt_scale[pid, :, off] = vps[0]
                pool.kqt_scale[pid, :, :, off] = kqs[0]   # blocks in lanes
                pool.vqt_scale[pid, :, :, off] = vqs[0]
        seqs.k_resid[row].zero_()
        seqs.v_resid[row].zero_()


def append_paged(pspec: PagedSpec, pool: PagePool, seqs: PagedSeqs,
                 k_new: torch.Tensor, v_new: torch.Tensor, *,
                 p0: RowP0Fn | None = None,
                 generator: torch.Generator | None = None,
                 use_lowrank: bool = True,
                 live=None) -> tuple[PagePool, PagedSeqs]:
    """Append one decode step's k/v [B, H, 1, D] for every sequence of one
    layer, in place.

    A row whose residual tier fills to ``group`` flushes one compressed
    block into its tail page, which the block table must already hold (the
    serving engine allocates it before the step). ``live`` (host bools)
    masks parked rows: they neither write, advance nor flush. A live row
    whose tail entry is negative keeps its full residual tier and does not
    flush. ``p0(row, which, shape)`` is asked for a flushing row's
    power-iteration inits.
    """
    plan = plan_append(pspec, seqs, live)
    apply_append(pspec, pool, seqs, k_new, v_new, plan, p0=p0,
                 generator=generator, use_lowrank=use_lowrank)
    return pool, seqs


# ---------------------------------------------------------------------------
# Attention over paged sequences.
# ---------------------------------------------------------------------------

def gather_dense(pspec: PagedSpec, pool: PagePool, seqs: PagedSeqs,
                 row: int = 0) -> kvcache.LayerCache:
    """Materialise one sequence's dense B=1 ``LayerCache`` from its pages
    (unallocated table entries read page 0 and are masked by ``comp_len``)."""
    safe_bt = seqs.block_table[row].clamp(min=0).to(torch.int64)  # [MAXP]

    def gtok(leaf):   # [P, H, X, PT] -> [1, H, X, T]
        g = leaf[safe_bt].permute(1, 2, 0, 3)           # [H, X, MAXP, PT]
        return g.reshape(*g.shape[:2], g.shape[2] * g.shape[3])[None]

    def gblk(leaf):   # [P, H, PB, ...] -> [1, H, NB, ...]
        g = leaf[safe_bt].movedim(0, 1)                 # [H, MAXP, PB, ...]
        return g.reshape(g.shape[0], g.shape[1] * g.shape[2],
                         *g.shape[3:])[None]

    fields = {}
    for name in POOL_FIELDS:
        lanes = name in TOKEN_LEAVES or name in BLOCK_LANE_LEAVES
        fields[name] = (gtok if lanes else gblk)(getattr(pool, name))
    comp, resid, prefill = (int(x) for x in seqs.host_lens[row])
    return kvcache.LayerCache(
        **fields, k_resid=seqs.k_resid[row][None],
        v_resid=seqs.v_resid[row][None], comp_len=comp, resid_len=resid,
        prefill_len=prefill)


def attend_gathered(pspec: PagedSpec, pool: PagePool, seqs: PagedSeqs,
                    q: torch.Tensor, *, sm_scale: float | None = None,
                    pad_start: torch.Tensor | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Decode attention of q [B, Hq, Qn, D] over paged sequences with
    per-row lengths: each row's pages are gathered into a dense cache, which
    ``cache.attend`` then attends. The counterpart of
    ``gear_tpu.paged.attend_xla``, and the plain version of the paged decode
    kernel (``kernels.decode.attend_paged``), which reads the pages where
    they lie."""
    outs = []
    for row in range(q.shape[0]):
        dense = gather_dense(pspec, pool, seqs, row)
        pad = None if pad_start is None else pad_start[row:row + 1]
        outs.append(kvcache.attend(pspec.spec, dense, q[row:row + 1],
                                   sm_scale=sm_scale, pad_start=pad,
                                   window=window))
    return torch.cat(outs, dim=0)
