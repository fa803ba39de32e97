"""Continuous-batching serving engines, PyTorch port of
``gear_tpu/serving.py``.

Every sequence gets its own slot with its own cache lengths, so requests of
different ages decode together and a freed slot is refilled at once:

  * :class:`ServingEngine` keeps one dense per-slot cache (``max_len`` of
    capacity each). It is the twin that the paged engine is held against.
  * :class:`PagedServingEngine` pools the compressed cache in pages
    (``gear_tpu_torch.paged``): short sequences reserve no ``max_len`` of
    cache, one decode pass serves all slots with per-slot lengths, and on
    the card the paged decode kernel reads the pages through the block
    tables.
  * Admission and slot bookkeeping live in the native C++ scheduler
    (``native/scheduler.cc``, FCFS with a slot free list) through ctypes,
    with the same scheduler in Python when the library is not built.

What differs from the JAX package: nothing is compiled, the caches and the
pool are updated in place, and the per-slot lengths are mirrored on the host
(``paged.PagedSeqs``), so a decode step fetches nothing from the device but
its tokens. There is no ``attn_impl`` switch and no ``heads_per_step``: the
device decides (kernel on the card, plain version on the CPU). The dense
engine runs the projections and the MLP once over the batch of slots and
only the cache append and the attention per slot (the JAX engine maps the
whole model over slots); a slot without a request is skipped. Both engines
take ``init(site, shape)`` to inject the power-iteration inits (sites in
``models.llama``), else draw them from a generator seeded with ``seed``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import cache as kvcache
from . import paged
from .config import CompressionConfig
from .device import resolve_device
from .kernels import decode as fused
from .models import llama


def _load_sched():
    path = Path(__file__).resolve().parents[1] / "native" / "libgearsched.so"
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.gear_sched_create.restype = ctypes.c_void_p
    lib.gear_sched_create.argtypes = [ctypes.c_int]
    lib.gear_sched_destroy.argtypes = [ctypes.c_void_p]
    for name, res, args in [
        ("gear_sched_add", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]),
        ("gear_sched_next_admission", ctypes.c_int64, [ctypes.c_void_p]),
        ("gear_sched_admit", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64]),
        ("gear_sched_step", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int]),
        ("gear_sched_preempt", ctypes.c_int64,
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]),
        ("gear_sched_finish", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int]),
        ("gear_sched_active", ctypes.c_int, [ctypes.c_void_p]),
        ("gear_sched_waiting", ctypes.c_int, [ctypes.c_void_p]),
        ("gear_sched_done", ctypes.c_int64, [ctypes.c_void_p]),
        ("gear_sched_slot_rid", ctypes.c_int64,
         [ctypes.c_void_p, ctypes.c_int]),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


class _PySched:
    """The semantics of native/scheduler.cc in Python."""

    def __init__(self, n_slots):
        self.waiting = []
        self.active = {}
        self.slots = [-1] * n_slots
        self.done_count = 0

    def add(self, rid, plen, max_new):
        self.waiting.append([rid, plen, max_new, 0])
        return 0

    def next_admission(self):
        if not self.waiting or -1 not in self.slots:
            return -1
        return self.waiting[0][0]

    def admit(self, rid):
        if not self.waiting or self.waiting[0][0] != rid:
            return -1
        slot = self.slots.index(-1)
        r = self.waiting.pop(0)
        self.slots[slot] = rid
        self.active[rid] = r
        return slot

    def step(self, slot):
        rid = self.slots[slot]
        if rid == -1:
            return -1
        r = self.active[rid]
        r[3] += 1
        return r[2] - r[3]

    def preempt(self, slot, new_plen):
        rid = self.slots[slot]
        if rid == -1:
            return -1
        r = self.active.pop(rid)
        self.slots[slot] = -1
        remaining = max(r[2] - r[3], 1)
        self.waiting.insert(0, [rid, new_plen, remaining, 0])
        return rid

    def finish(self, slot):
        rid = self.slots[slot]
        if rid == -1:
            return -1
        self.slots[slot] = -1
        del self.active[rid]
        self.done_count += 1
        return rid


class Scheduler:
    """Thin wrapper selecting the native scheduler when built."""

    def __init__(self, n_slots: int):
        self._lib = _load_sched()
        if self._lib is not None:
            self._h = self._lib.gear_sched_create(n_slots)
        else:
            self._py = _PySched(n_slots)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def add(self, rid, plen, max_new):
        if self._lib:
            return self._lib.gear_sched_add(self._h, rid, plen, max_new)
        return self._py.add(rid, plen, max_new)

    def next_admission(self):
        if self._lib:
            return self._lib.gear_sched_next_admission(self._h)
        return self._py.next_admission()

    def admit(self, rid):
        if self._lib:
            return self._lib.gear_sched_admit(self._h, rid)
        return self._py.admit(rid)

    def step(self, slot):
        if self._lib:
            return self._lib.gear_sched_step(self._h, slot)
        return self._py.step(slot)

    def preempt(self, slot, new_plen):
        """Free the slot and requeue its request at the front of the waiting
        queue with its remaining token budget (recompute-style preemption)."""
        if self._lib:
            return self._lib.gear_sched_preempt(self._h, slot, new_plen)
        return self._py.preempt(slot, new_plen)

    def finish(self, slot):
        if self._lib:
            return self._lib.gear_sched_finish(self._h, slot)
        return self._py.finish(slot)

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.gear_sched_destroy(self._h)


@dataclass
class Request:
    rid: int
    tokens: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    done: bool = False
    folded: int = 0  # prefix of `out` already folded into `tokens` (preempt)


class _SlotEngine:
    """What the two engines share: requests, slots, the admission prefill."""

    def __init__(self, model_cfg: llama.ModelConfig, params: dict, comp, *,
                 n_slots: int, max_len: int, eos_token_id: int | None,
                 pad_token_id: int, device, init, seed: int):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        self.cfg = model_cfg
        self.params = params
        self.comp = comp or CompressionConfig(num_layers=model_cfg.num_layers)
        lcomp = self.comp.layer(0)
        win = model_cfg.sliding_window
        if win is not None and win < lcomp.group_size:
            raise ValueError(
                f"sliding_window {win} < group_size {lcomp.group_size}: the "
                "compressed cache masks the window over the packed prefix "
                "only")
        self.spec = model_cfg.cache_spec(1, max_len, lcomp)  # per-slot B=1
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_token_id
        self.pad_id = pad_token_id
        self.init = init
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sched = Scheduler(n_slots)
        self.requests: dict[int, Request] = {}
        self._next_rid = 0
        self._slot_req: list[Request | None] = [None] * n_slots
        dev = self.device
        self.cur_tok = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
        self.positions = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.pad_start = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.live = np.zeros((n_slots,), bool)

    def submit(self, tokens: list[int], max_new: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, list(tokens), max_new)
        self.sched.add(rid, len(tokens), max_new)
        return rid

    def _bucket(self, n: int) -> int:
        g = self.spec.group
        return min(((n + g - 1) // g) * g, self.max_len)

    def _prefill(self, req: Request, s: int):
        """Prompt pass of one request, left-padded to ``s`` tokens ->
        (first token, a 0-d device tensor; stacked B=1 caches; the number of
        prompt tokens kept)."""
        toks = req.tokens[-s:]
        tokens = torch.full((1, s), self.pad_id, dtype=torch.int64)
        mask = torch.zeros((1, s), dtype=torch.int32)
        tokens[0, s - len(toks):] = torch.tensor(toks, dtype=torch.int64)
        mask[0, s - len(toks):] = 1
        tokens, mask = tokens.to(self.device), mask.to(self.device)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        init = None if self.init is None else (
            lambda site, shape, rid=req.rid:
            self.init(("serve_prefill", rid, site[1], site[2]), shape))
        logits, caches1 = llama.forward_prefill(
            self.params, self.cfg, tokens, positions, mask, self.spec,
            compress=True, init=init, generator=self.generator)
        return torch.argmax(logits[0, -1]), caches1, len(toks)

    def _start_slot(self, slot: int, req: Request, first: torch.Tensor,
                    n_prompt: int, s: int) -> None:
        self.cur_tok[slot] = first          # device to device
        self.positions[slot].fill_(n_prompt)
        self.pad_start[slot].fill_(s - n_prompt)
        self.live[slot] = True
        req.out.append(int(first))
        self._after_emit(slot, req)

    def _emit(self, nxt: torch.Tensor) -> None:
        """Hand a decode step's tokens to their requests: the step's one
        fetch from the device."""
        self.positions += 1
        self.cur_tok = nxt
        toks = nxt.tolist()
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is None or req.done:
                continue
            req.out.append(toks[slot])
            self._after_emit(slot, req)

    def _finished(self, slot: int, req: Request) -> bool:
        remaining = self.sched.step(slot)
        hit_eos = self.eos is not None and req.out and req.out[-1] == self.eos
        return remaining <= 0 or hit_eos

    def _done(self) -> dict[int, list[int]]:
        return {rid: r.out for rid, r in self.requests.items() if r.done}


class ServingEngine(_SlotEngine):
    """Continuous batching over ``n_slots`` independent dense caches.

    ``device`` defaults to ``cuda`` and raises without a CUDA device; the
    params must already lie on it.
    """

    def __init__(self, model_cfg: llama.ModelConfig, params: dict, comp=None,
                 *, n_slots: int = 4, max_len: int = 512,
                 eos_token_id: int | None = None, pad_token_id: int = 0,
                 device=None, init=None, seed: int = 0):
        super().__init__(model_cfg, params, comp, n_slots=n_slots,
                         max_len=max_len, eos_token_id=eos_token_id,
                         pad_token_id=pad_token_id, device=device, init=init,
                         seed=seed)
        # one stacked B=1 cache per slot, set at admission
        self.caches: list[kvcache.LayerCache | None] = [None] * n_slots

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drive admissions and decode steps until every submitted request
        has finished."""
        for _ in range(max_steps):
            self._admit_all()
            if not self.live.any():
                break
            self._decode_once()
        return self._done()

    def _admit_all(self):
        while True:
            rid = self.sched.next_admission()
            if rid == -1:
                break
            slot = self.sched.admit(rid)
            req = self.requests[rid]
            self._slot_req[slot] = req
            s = self._bucket(len(req.tokens))
            first, caches1, n_prompt = self._prefill(req, s)
            self.caches[slot] = caches1
            self._start_slot(slot, req, first, n_prompt, s)

    @torch.no_grad()
    def _decode_once(self):
        cfg, spec = self.cfg, self.spec
        h = self.params["embed"][self.cur_tok].to(cfg.dtype)[:, None]
        cos, sin = llama.rope_cos_sin(self.positions[:, None], cfg.head_dim,
                                      cfg.rope_theta)
        slots = [s for s in range(self.n_slots) if self.live[s]]
        last = {}
        for i in range(cfg.num_layers):
            lp = llama._layer_slice(self.params["layers"], i)
            q, k, v = llama._qkv(cfg, lp, h, cos, sin)
            attn = torch.zeros_like(q)
            for s in slots:
                lc = self.caches[s].layer(i)
                p0 = None if self.init is None else (
                    lambda which, shape, s=s, i=i, c=lc.comp_len: self.init(
                        ("serve_decode", s, i, which, c), shape))
                kvcache.append(spec, lc, k[s:s + 1], v[s:s + 1], p0=p0,
                               generator=self.generator)
                attn[s:s + 1] = fused.attend_fused(
                    spec, lc, q[s:s + 1], pad_start=self.pad_start[s:s + 1],
                    window=cfg.sliding_window)
                last[s] = lc
            h = llama._finish_layer(cfg, lp, h, attn)
        for s in slots:
            self.caches[s].set_lengths(last[s])
        h = llama.rmsnorm(h, self.params["final_norm"], cfg.rms_eps)
        logits = llama.logits_from_hidden(self.params, cfg, h)[:, 0]
        self._emit(torch.argmax(logits, dim=-1))

    def _after_emit(self, slot: int, req: Request):
        if self._finished(slot, req):
            req.done = True
            self.sched.finish(slot)
            self._slot_req[slot] = None
            self.live[slot] = False
            self.caches[slot] = None


class PagedServingEngine(_SlotEngine):
    """Continuous batching over a shared physical page pool.

    Against :class:`ServingEngine`: device memory is pooled, so short
    sequences reserve no ``max_len`` of cache; one decode pass serves all
    slots with per-slot lengths; pages are refcounted (``native/pager.cc``).

    The host drives the pages: admission allocates
    ceil(prompt blocks / page_blocks) pages (and waits while fewer than that
    plus one are free); before every decode step a slot whose coming flush
    crosses into a new page gets it, preempting another slot if the pool is
    empty; a finished request releases its pages.

    ``device`` defaults to ``cuda`` and raises without a CUDA device; the
    params must already lie on it.
    """

    def __init__(self, model_cfg: llama.ModelConfig, params: dict, comp=None,
                 *, n_slots: int = 4, max_len: int = 512, n_pages: int = 64,
                 page_blocks: int = 2, eos_token_id: int | None = None,
                 pad_token_id: int = 0, device=None, init=None,
                 seed: int = 0):
        super().__init__(model_cfg, params, comp, n_slots=n_slots,
                         max_len=max_len, eos_token_id=eos_token_id,
                         pad_token_id=pad_token_id, device=device, init=init,
                         seed=seed)
        self.pspec = paged.PagedSpec(spec=self.spec, n_pages=n_pages,
                                     page_blocks=page_blocks)
        self.alloc = paged.PageAllocator(n_pages)
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        n_layers = model_cfg.num_layers
        self.pools = paged.init_pool(self.pspec, self.device, n_layers)
        self.seqs = paged.init_seqs(self.pspec, n_slots, self.device, n_layers)
        for slot in range(n_slots):  # parked: one zero residual token, no NaN
            self.seqs.set_lengths(slot, 0, 1, 0)
        self.live_dev = torch.zeros((n_slots,), dtype=torch.bool,
                                    device=self.device)

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            self._admit_all()
            if not self.live.any():
                break
            self._prealloc_pages()
            self._decode_once()
        return self._done()

    def _splice_slot(self, slot: int, caches1: kvcache.LayerCache,
                     page_ids: list[int]):
        """Scatter a fresh dense prefill cache (leaves [L, 1, ...]) into pages
        and point this slot's table, lengths and residual tier at it."""
        n_blk = caches1.comp_len // self.spec.group
        n_pages_used = -(-n_blk // self.pspec.page_blocks)
        assert n_pages_used <= len(page_ids)
        paged._scatter_prefix_into_pages(self.pspec, self.pools, caches1, 0,
                                         page_ids, n_pages_used)
        self.seqs.set_table_row(slot, page_ids[:n_pages_used])
        self.seqs.set_lengths(slot, caches1.comp_len, caches1.resid_len,
                              caches1.prefill_len)
        self.seqs.k_resid[:, slot] = caches1.k_resid[:, 0]
        self.seqs.v_resid[:, slot] = caches1.v_resid[:, 0]

    def _admit_all(self):
        while True:
            rid = self.sched.next_admission()
            if rid == -1:
                break
            req = self.requests[rid]
            s = self._bucket(len(req.tokens))
            n_pages_needed = -(-(s // self.spec.group)
                               // self.pspec.page_blocks)
            if self.alloc.free_count() < n_pages_needed + 1:
                break  # wait for pages to free up
            slot = self.sched.admit(rid)
            self._slot_req[slot] = req
            first, caches1, n_prompt = self._prefill(req, s)
            ids = [self.alloc.alloc() for _ in range(n_pages_needed)]
            assert -1 not in ids
            self._slot_pages[slot] = ids
            self._splice_slot(slot, caches1, ids)
            self.live_dev[slot].fill_(True)
            self._start_slot(slot, req, first, n_prompt, s)

    def _prealloc_pages(self):
        """Make sure the page that a slot's next flush writes into exists.

        With the pool exhausted, preempt a live slot (release its pages,
        requeue its request with what it generated as part of the prompt)
        until the allocation succeeds.
        """
        g = self.spec.group
        pb = self.pspec.page_blocks
        for slot in range(self.n_slots):
            if not self.live[slot]:
                continue
            comp, resid, _ = (int(x) for x in self.seqs.host_lens[slot])
            if resid + 1 != g:  # this step will not flush
                continue
            pidx = (comp // g) // pb
            if (pidx < len(self._slot_pages[slot])
                    or pidx >= self.pspec.max_pages_per_seq):
                continue
            pid = self.alloc.alloc()
            while pid == -1:
                victim = self._pick_preempt_victim(exclude=slot)
                if victim is None:
                    # nothing left to evict but this slot itself
                    self._preempt(slot)
                    break
                self._preempt(victim)
                pid = self.alloc.alloc()
            if not self.live[slot]:
                continue  # preempted itself above
            assert pid != -1, "page pool exhausted after preemption"
            self._slot_pages[slot].append(pid)
            self.seqs.set_page(slot, pidx, pid)

    def _pick_preempt_victim(self, exclude: int) -> int | None:
        """The live slot holding the most pages (frees the most memory);
        ties go to the highest slot id."""
        best, best_pages = None, 0
        for slot in range(self.n_slots):
            if slot == exclude or not self.live[slot]:
                continue
            if len(self._slot_pages[slot]) >= best_pages:
                best, best_pages = slot, len(self._slot_pages[slot])
        return best

    def _preempt(self, slot: int):
        """Release a slot's pages and requeue its request at the front of
        the queue with its remaining budget; what it generated so far joins
        the prompt, and re-admission prefills the whole context again."""
        req = self._slot_req[slot]
        req.tokens = req.tokens + req.out[req.folded:]
        req.folded = len(req.out)
        self.sched.preempt(slot, len(req.tokens))
        self._park_slot(slot)

    def _decode_once(self):
        logits, _, _ = llama.forward_decode_paged(
            self.params, self.cfg, self.cur_tok, self.positions, self.pools,
            self.seqs, pspec=self.pspec, pad_start=self.pad_start,
            init=self.init, generator=self.generator, live=self.live,
            live_dev=self.live_dev)
        self._emit(torch.argmax(logits, dim=-1))

    def _after_emit(self, slot: int, req: Request):
        if self._finished(slot, req):
            req.done = True
            self.sched.finish(slot)
            self._park_slot(slot)

    def _park_slot(self, slot: int):
        """Free a slot's pages and park it on a harmless state: no page
        (table of -1), one zero residual token. The ``live`` mask keeps a
        parked slot out of the append and the flush."""
        self._slot_req[slot] = None
        self.live[slot] = False
        self.live_dev[slot].fill_(False)
        for pid in self._slot_pages[slot]:
            self.alloc.release(pid)
        self._slot_pages[slot] = []
        self.seqs.set_table_row(slot, [])
        self.seqs.set_lengths(slot, 0, 1, 0)
        self.seqs.k_resid[:, slot].zero_()
        self.seqs.v_resid[:, slot].zero_()
