"""Profiling: the program's spans, ``torch.profiler`` traces, a timer, and
the H100's peaks; the counterpart of ``gear_tpu/profiling.py``.

Spans. :func:`span` marks a stretch of the program's host work (a decode
step, a layer, a cache append or flush, an attention call) with a name and
a few attributes. Spans are recorded only while ``torch.profiler`` records,
so a program that is not being profiled pays one flag check a span. They
are kept in this process's memory (:func:`spans`), stamped with
``time.time_ns()``: the clock the profiler stamps its own events with, so
a span and the operations and kernels launched inside it line up. They are
not profiler events: an annotation (``record_function``, an NVTX range)
would also be drawn on the device's timeline, over the kernels launched
inside it, and counted there as device work. :func:`trace` writes them into
its Chrome trace on a track of their own.

The span names, each at the function it times: ``engine.decode_step``
(attributes ``step``, ``batch``; the root of a step's spans),
``engine.prefill`` (``batch``, ``bucket``), ``llama.layer`` (``layer``),
``cache.append`` (``resid_len``), ``cache.flush`` (``comp_len``;
``route``: ``kernel`` on the card, ``plain`` on the CPU),
``llama.raw_append``, ``decode.attend_fused``, ``flash.raw_attend_flash``,
``moe.block`` (``rows``, ``experts_local``; ``models.mixtral``) and
``comm.all_reduce`` (``axis``, ``bytes``; ``parallel.distributed``). A
decode step replayed from a CUDA graph runs no Python inside it and
records its root span alone.

Beside them: a timer that reads CUDA events for work on the card and the
host clock for work on the CPU, and the H100's published peaks.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


# -- spans ------------------------------------------------------------------

@dataclass(slots=True)
class Span:
    """One recorded span. Times are ``time.time_ns()``; ``parent`` and
    ``root`` index :func:`spans` (``parent`` is None for a root, whose
    ``root`` is its own index); ``thread`` is the OS thread id, as the
    profiler's events give it; ``error`` names the exception that left the
    span, if one did."""
    name: str
    t0: int
    t1: int | None
    parent: int | None
    root: int
    thread: int
    attrs: dict = field(default_factory=dict)
    error: str | None = None


class _Thread(threading.local):
    """A thread's stack of open spans, and its OS id, read once: asking
    for it is a system call, which some hosts make slow."""

    def __init__(self):
        self.stack: list[tuple[int, int]] = []
        self.tid = threading.get_native_id()


_records: list[Span] = []
_lock = threading.Lock()
_thread = _Thread()
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "attrs", "rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _thread.stack
        parent, root = stack[-1] if stack else (None, None)
        with _lock:
            i = len(_records)
            self.rec = Span(self.name, 0, None, parent,
                            i if root is None else root, _thread.tid,
                            self.attrs)
            _records.append(self.rec)
        stack.append((i, self.rec.root))
        self.rec.t0 = time.time_ns()

    def __exit__(self, exc_type, exc, tb):
        self.rec.t1 = time.time_ns()
        if exc_type is not None:
            self.rec.error = exc_type.__name__
        _thread.stack.pop()
        return False


def span(name: str, **attrs):
    """A context that records the block as a span named ``name`` while
    ``torch.profiler`` records; otherwise one shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, attrs)


def spans() -> list[Span]:
    """The spans recorded since the last :func:`clear_spans`, in the order
    they opened (a span still open has ``t1`` None)."""
    with _lock:
        return list(_records)


def clear_spans() -> None:
    with _lock:
        _records.clear()


def self_ns(records: list[Span]) -> list[int | None]:
    """Each span's self time: its duration less the union of its children's
    intervals (None for a span still open)."""
    kids: list[list] = [[] for _ in records]
    for r in records:
        if r.parent is not None and r.t1 is not None:
            kids[r.parent].append((r.t0, r.t1))
    out = []
    for r, ks in zip(records, kids):
        if r.t1 is None:
            out.append(None)
            continue
        covered, end = 0, r.t0
        for a, b in sorted(ks):
            a, b = max(a, end), min(b, r.t1)
            if b > a:
                covered += b - a
                end = b
        out.append(r.t1 - r.t0 - covered)
    return out


def roots(name: str, key: str, records: list[Span]) -> dict:
    """For each value of attribute ``key``, the index of the last root span
    named ``name`` that carries it."""
    return {r.attrs.get(key): i for i, r in enumerate(records)
            if r.parent is None and r.name == name}


def _write_spans(path: str, records: list[Span]) -> None:
    """Add ``records`` to the Chrome trace at ``path`` (as
    ``torch.profiler`` exports it) as complete events on a process track
    named ``gear_tpu_torch``, listed above the profiler's own."""
    with open(path) as f:
        doc = json.load(f)
    # the profiler writes ``ts`` in microseconds since baseTimeNanoseconds
    # of the same clock as time.time_ns() (since the epoch where absent)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "gear_tpu_torch"}})
    events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                   "tid": 0, "args": {"sort_index": -1}})
    for r in records:
        if r.t1 is None:
            continue
        args = dict(r.attrs)
        if r.error is not None:
            args["error"] = r.error
        events.append({"ph": "X", "cat": "gear_tpu_torch", "name": r.name,
                       "pid": pid, "tid": r.thread,
                       "ts": (r.t0 - base) / 1e3,
                       "dur": (r.t1 - r.t0) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


# -- traces and timing -------------------------------------------------------

@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (host, and the card's kernels when
    CUDA is available); on exit the Chrome trace is written to
    ``log_dir/trace.json`` (chrome://tracing or Perfetto) with the block's
    spans on a track of their own. Clears the spans on entry. Yields the
    profiler, whose ``key_averages()`` sum the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, spans())


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def timeit(fn, *args, iters: int = 3, inner: int = 1) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after one
    warm-up, divided by ``inner`` (for calls that loop inside). Where the
    warm-up's output (its first tensor) lies on the card, each call is timed
    by CUDA events around it; elsewhere by the host clock, with no sync."""
    out = _first_tensor(fn(*args))
    cuda = out is not None and out.is_cuda
    if cuda:
        torch.cuda.synchronize(out.device)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / inner)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) / inner)
    return float(np.median(times))


# -- hardware model ---------------------------------------------------------

@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float       # device memory bandwidth, GB/s
    bf16_tflops: float    # dense bf16 tensor-core peak, TFLOP/s
    fp32_tflops: float    # float32 peak outside the tensor cores, TFLOP/s

    def bound_s(self, nbytes: float, fp32_ops: float) -> tuple[float, str]:
        """The least seconds for work that moves ``nbytes`` of device
        memory and does ``fp32_ops`` float32 operations outside the tensor
        cores, and which of the two binds: "bytes" or "operations"."""
        t_bytes = nbytes / (self.hbm_gbps * 1e9)
        t_ops = fp32_ops / (self.fp32_tflops * 1e12)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16
# (without sparsity) and 67 TFLOP/s float32, all at the 700 W power limit.
H100_SXM = ChipSpec("h100_sxm", hbm_gbps=3350.0, bf16_tflops=989.0,
                    fp32_tflops=67.0)
