"""cache.append_host_us: the mean self time of a layer's cache append in
the counted decode steps, in us: ``cache.append`` less a flush inside it
(the compressed cache) or ``llama.raw_append`` (the bf16 cache). Spans as
``decode.host_ms`` reads them. Layer: cache."""
from __future__ import annotations

from gear_tpu_torch import profiling

NAMES = ("cache.append", "llama.raw_append")


def read(ctx):
    if not hasattr(profiling, "roots") or not ctx["steps"]:
        return None
    recs = profiling.spans()
    last = profiling.roots("engine.decode_step", "step", recs)
    steps = {last[t] for t in ctx["steps"] if t in last}
    own = profiling.self_ns(recs)
    vals = [own[i] for i, r in enumerate(recs)
            if r.root in steps and r.name in NAMES and own[i] is not None]
    return sum(vals) / len(vals) / 1e3 if vals else None
