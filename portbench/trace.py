"""A bounded stretch of a run under ``torch.profiler``, reduced in memory.

The traced run profiles a few steps of its window: ``pad`` steps that are
not counted (a trace can lose its first records), then the counted stretch
inside one ``portbench.stretch`` annotation. The profiler's records stay in
memory; :func:`summarize` keeps only what the per-layer metrics read:

  * the stretch's wall time (the annotation's span on the host clock, onto
    which the profiler maps the device's timestamps) and the device's busy
    time: the union of every device record's interval inside it (kernels,
    copies and fills), never a sum of their durations, which counts
    overlapping kernels twice;
  * per device-record name, its count and seconds inside the stretch;
  * the idle gaps between device records, each named by what the host
    thread that ran the stretch was doing at the gap's middle: the
    innermost operation or annotation open there (runtime calls skipped).
"""
from __future__ import annotations

import bisect
import contextlib

STRETCH = "portbench.stretch"
NAME_CHARS = 160  # names in the breakdown are cut to this many characters


class Stretch:
    """Profiles steps ``first - pad .. first + n - 1`` of a run when
    ``enabled``: call :meth:`step` around each step with its index."""

    def __init__(self, enabled: bool, first: int, n: int, pad: int = 2):
        self.enabled = enabled
        self.first, self.n, self.pad = first, n, pad
        self.prof = None
        self._ann = None
        self.summary = None
        self.steps: list[int] = []

    @contextlib.contextmanager
    def step(self, i: int, tag=None):
        """Context of step ``i`` (``tag`` is recorded for the counted ones:
        the driver's own index of the step)."""
        if not self.enabled or self.summary is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if i == self.first - self.pad and self.prof is None:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        if self.prof is not None and i == self.first:
            self._ann = record_function(STRETCH)
            self._ann.__enter__()
        yield
        if self._ann is not None and self.first <= i:
            self.steps.append(i if tag is None else tag)
        if self._ann is not None and i == self.first + self.n - 1:
            self._ann.__exit__(None, None, None)
            self._ann = None
            self.prof.__exit__(None, None, None)
            self.summary = summarize(self.prof)
            self.prof = None

    def close(self):
        """Stop a profiler the window ended before its stretch did."""
        if self.prof is not None:
            if self._ann is not None:
                self._ann.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.prof = None


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _is_note(ev) -> bool:
    """The harness's own annotations, which the profiler also draws on the
    device's timeline: spans, not device work."""
    return ev.name().startswith("portbench.")


def summarize(prof) -> dict | None:
    """The stretch's summary (see the module's docstring), or None when the
    trace holds no stretch."""
    events = prof.profiler.kineto_results.events()
    ann = [e for e in events if e.name() == STRETCH and not _is_device(e)]
    if not ann:
        return None
    a = ann[0]
    t0, t1 = a.start_ns(), a.end_ns()
    tid = a.start_thread_id()
    dev = []
    for e in events:
        if _is_device(e) and not _is_note(e):
            s, d = e.start_ns(), e.duration_ns()
            if t0 <= s < t1:
                dev.append((s, min(s + d, t1), e.name()))
    dev.sort()
    by_name: dict[str, list] = {}
    for s, e, name in dev:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    busy, gaps, end = 0, [], t0
    for s, e, _ in dev:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if end < t1:
        gaps.append((end, t1))
    host = [e for e in events if not _is_device(e)
            and e.start_thread_id() == tid and e.name() != STRETCH
            and not e.name().startswith(("cuda", "cu"))]
    ops = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                 if not _is_note(e))
    notes = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                   if _is_note(e))
    idle: dict[str, float] = {}
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    for (g0, g1), name in zip(gaps, _names_at(ops, notes, mids)):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9,
            "records": len(dev), "by_name": by_name, "idle": idle}


def _innermost(spans, starts, p, reach):
    """The latest-starting of ``spans`` (sorted by start) that covers
    ``p``, looking back at most ``reach`` spans; None if none does."""
    j = bisect.bisect_right(starts, p) - 1
    stop = max(-1, j - reach)
    while j > stop:
        s, e, n = spans[j]
        if e >= p:
            return n
        j -= 1
    return None


def _names_at(ops, notes, points):
    """For each point, the innermost host operation open there (spans of
    one thread nest), else ``python (<annotation>)`` for the harness's
    innermost annotation open there, else ``"(no host op)"``."""
    op_starts = [o[0] for o in ops]
    note_starts = [n[0] for n in notes]
    out = []
    for p in points:
        name = _innermost(ops, op_starts, p, 32)
        if name is None:
            note = _innermost(notes, note_starts, p, len(notes))
            name = "(no host op)" if note is None else f"python ({note})"
        out.append(name)
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    """The driver's ``breakdown``: the device operations that took most
    time and the host work behind the longest idle time, ``top`` of each,
    in seconds as measured."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][1])
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:NAME_CHARS], v[1]] for n, v in ops[:top]],
            "idle_gaps": [[n[:NAME_CHARS], v] for n, v in idle[:top]]}


def kernel_time(summary: dict, patterns, share_patterns=()) -> tuple[int, float]:
    """(calls, seconds) of the device records whose names match one of the
    regular expressions ``patterns``; the records matching
    ``share_patterns`` (a second kernel each call launches, shared with
    other kernels' calls) are added in proportion to the calls' share of
    their count."""
    import re

    calls, secs, shared_n, shared_s = 0, 0.0, 0, 0.0
    for name, (n, s) in summary["by_name"].items():
        if any(re.search(p, name) for p in patterns):
            calls += n
            secs += s
        elif any(re.search(p, name) for p in share_patterns):
            shared_n += n
            shared_s += s
    if calls and shared_n:
        secs += shared_s * min(1.0, calls / shared_n)
    return calls, secs
