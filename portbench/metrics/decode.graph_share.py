"""decode.graph_share: the share, in %, of the counted decode steps that
the program replayed from a CUDA graph: those whose ``engine.decode_step``
root span carries ``graph="replay"``. Spans as ``decode.host_ms`` reads
them; None where the program records no ``graph`` attribute. Layer: model
step."""
from __future__ import annotations

from gear_tpu_torch import profiling


def read(ctx):
    if not hasattr(profiling, "roots") or not ctx["steps"]:
        return None
    recs = profiling.spans()
    last = profiling.roots("engine.decode_step", "step", recs)
    kinds = [recs[last[t]].attrs.get("graph") for t in set(ctx["steps"])
             if t in last]
    if not kinds or None in kinds:
        return None
    return 100.0 * kinds.count("replay") / len(kinds)
