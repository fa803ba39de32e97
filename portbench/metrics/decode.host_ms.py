"""decode.host_ms: the host's time in a decode step: the mean duration of
the counted steps' ``engine.decode_step`` spans, in ms. The program records
its spans on the host clock while the stretch is profiled (the profiler's
cost included); the last root span of each counted step's index is that
step's. None where the program records no spans. Layer: model step."""
from __future__ import annotations

from gear_tpu_torch import profiling


def read(ctx):
    if not hasattr(profiling, "roots") or not ctx["steps"]:
        return None
    recs = profiling.spans()
    last = profiling.roots("engine.decode_step", "step", recs)
    durs = [recs[last[t]].t1 - recs[last[t]].t0 for t in set(ctx["steps"])
            if t in last and recs[last[t]].t1 is not None]
    return sum(durs) / len(durs) / 1e6 if durs else None
