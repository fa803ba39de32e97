"""decode.step_mfu: the whole decode step's share of the card's roofline.

The bound of each traced step (``counts.decode_step``: the larger of its
operations over the bf16 peak and the bytes it needs over the memory
bandwidth) summed over the stretch, over the stretch's wall time. Layer:
model step."""
from __future__ import annotations

from portbench import counts


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["steps"] or t["window_s"] <= 0:
        return None
    hf, fmt = ctx["hf"], ctx["fmt"]
    bound = 0.0
    for j in ctx["steps"]:
        state = counts.decode_state(ctx["prefill_len"], ctx["bucket"], j,
                                    fmt.group, ctx["raw"])
        flops, nbytes = counts.decode_step(hf, fmt, state, ctx["pad_starts"])
        bound += counts.bound_s(flops, nbytes, ctx["kind"])
    return 100.0 * bound / t["window_s"]
