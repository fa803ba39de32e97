"""comm.allreduce_share: the share, in %, of the traced stretch's wall time
on rank 0 that its NCCL kernels (the collectives' device side, captured in
the step's graph or launched eagerly) ran. Layer: collectives."""
from __future__ import annotations

from portbench import trace

PATTERNS = [r"^ncclDevKernel", r"^ncclKernel"]


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["steps"] or t["window_s"] <= 0:
        return None
    calls, secs = trace.kernel_time(t, PATTERNS)
    return 100.0 * secs / t["window_s"] if calls else None
