"""decode.kernels_per_step: device records (kernels, copies, fills) in the
traced stretch of decode steps, over its steps. Layer: model step."""
from __future__ import annotations


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["steps"] or not t["records"]:
        return None
    return t["records"] / len(ctx["steps"])
