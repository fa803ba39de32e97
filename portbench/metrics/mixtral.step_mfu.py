"""mixtral.step_mfu: one rank's decode step's share of its card's roofline,
rank 0's in the traced stretch.

The bound of each traced step for the rank (``counts_moe.rank_step``: its
weights read once, its kv heads' attended KV in the cell's format and its
share of the logits; the larger of bytes over the bandwidth and operations
over the bf16 peak) summed over the stretch, over the stretch's wall time.
Layer: model step."""
from __future__ import annotations

from portbench import counts, counts_moe


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["steps"] or t["window_s"] <= 0:
        return None
    hf, fmt = ctx["hf"], ctx["fmt"]
    bound = 0.0
    for j in ctx["steps"]:
        state = counts.decode_state(ctx["prefill_len"], ctx["bucket"], j,
                                    fmt.group, ctx["raw"])
        bound += counts.bound_s(*counts_moe.rank_step(
            hf, fmt, state, ctx["pad_starts"], ctx["world"]), ctx["kind"])
    return 100.0 * bound / t["window_s"]
