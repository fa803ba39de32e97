"""attn.host_us: the mean duration of a decode attention call's wrapper in
the counted decode steps, in us: ``decode.attend_fused`` (the compressed
cache, B1) or ``flash.raw_attend_flash`` (the bf16 cache, B4), whose
checks, operand views, split planning and launches run on the host. Spans
as ``decode.host_ms`` reads them. Layer: kernels."""
from __future__ import annotations

from gear_tpu_torch import profiling

NAMES = ("decode.attend_fused", "flash.raw_attend_flash")


def read(ctx):
    if not hasattr(profiling, "roots") or not ctx["steps"]:
        return None
    recs = profiling.spans()
    last = profiling.roots("engine.decode_step", "step", recs)
    steps = {last[t] for t in ctx["steps"] if t in last}
    vals = [r.t1 - r.t0 for r in recs
            if r.root in steps and r.name in NAMES and r.t1 is not None]
    return sum(vals) / len(vals) / 1e3 if vals else None
