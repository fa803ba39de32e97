"""llama.layer_self_us: the mean self time of a ``llama.layer`` span in the
counted decode steps, in us: its duration less the union of its children
(the cache append and the attention call), so the norms, projections, RoPE
and feed-forward block as the host enqueues them. Spans as
``decode.host_ms`` reads them. Layer: model step."""
from __future__ import annotations

from gear_tpu_torch import profiling


def read(ctx):
    if not hasattr(profiling, "roots") or not ctx["steps"]:
        return None
    recs = profiling.spans()
    last = profiling.roots("engine.decode_step", "step", recs)
    steps = {last[t] for t in ctx["steps"] if t in last}
    own = profiling.self_ns(recs)
    vals = [own[i] for i, r in enumerate(recs)
            if r.root in steps and r.name == "llama.layer"
            and own[i] is not None]
    return sum(vals) / len(vals) / 1e3 if vals else None
