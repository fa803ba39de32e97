"""Shared arithmetic of the decode-attention kernels' rooflines."""
from __future__ import annotations

from portbench import counts, trace


def roofline(ctx, patterns, shared):
    """Percent of the bound: the bound of every decode-attention call of
    the traced steps (one a layer a step), over the device time of the
    records named by ``patterns`` (and their share of ``shared``); None
    when the stretch holds none."""
    t = ctx["trace"]
    if not t or not ctx["steps"]:
        return None
    calls, secs = trace.kernel_time(t, patterns, shared)
    if not calls or secs <= 0:
        return None
    hf, fmt = ctx["hf"], ctx["fmt"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    bound = 0.0
    for j in ctx["steps"]:
        state = counts.decode_state(ctx["prefill_len"], ctx["bucket"], j,
                                    fmt.group, ctx["raw"])
        bound += counts.bound_s(*counts.attention_call(
            fmt, state, ctx["pad_starts"], hq, hkv,
            hf.get("sliding_window")), ctx["kind"])
    layers = hf["num_hidden_layers"]
    expected = len(ctx["steps"]) * layers
    # a record the trace lost is a call left out of both sides
    return 100.0 * bound * layers * (calls / expected) / secs
