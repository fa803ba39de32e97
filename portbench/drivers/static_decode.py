"""Static long-context decode: one batch of long prompts, decoded greedily
in replays from the cache the prompt pass left.

Set-up makes the weights and the prompts from the seed (``batch`` prompts,
lengths evenly spread over ``prompt_len`` in the seed's order, left-padded
to ``bucket``), runs the prompt pass, keeps a device copy of the cache,
warms up ``warm_steps`` decode steps (a flush among them) and restores the
copy. The window replays ``replay_steps`` greedy decode steps from the copy,
restores it, and repeats until ``--seconds`` have passed. Each step reads
its tokens back to the host, as a server streaming them would; the device
clock (a CUDA event after each step) times the gaps between steps, and a
restore counts into the gap of the step after it.

End-to-end: ``output_tok_s`` (every row's token of every step in the
window over the window's seconds), ``itl_p95_ms`` (95th percentile of the
gaps, each gap one for every row), ``kv_bytes_per_token`` (the device bytes
the cache holds after set-up over ``batch * max_len`` tokens), ``setup_s``
(process start to the first timed step).

The check: the replay last completed in the window (or, if none was, the
one in progress, finished after the close) is compared with the plain
reference over ``check_rows`` rows drawn from the seed, the longest prompt
among them: teacher-forced over each row's prompt and served tokens, the
widest gap by which a served token's reference logit lies below the
reference's best; each number the cell's ``limits`` names
(``NUMBERS``) against its limit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts, inits, trace, traffic, weights
from portbench.reference import decoder

def snapshot(cache) -> dict:
    """A device copy of every tensor of a cache object, and its lengths."""
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in vars(cache).items()}


def restore(cache, snap: dict) -> None:
    for k, v in snap.items():
        if torch.is_tensor(v):
            getattr(cache, k).copy_(v)
        else:
            setattr(cache, k, v)


def store_bytes(cache) -> int:
    """Device bytes held by the cache's tensors (each storage once)."""
    seen = {}
    for v in vars(cache).values():
        if torch.is_tensor(v):
            st = v.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class Clock:
    """Step boundaries: CUDA events on the card, the host clock on the
    CPU. ``gaps_ms()`` after the window."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _faulty(decode, fault: str | None, vocab: int):
    """The decode entry with a fault planted underneath (tests only)."""
    if fault is None:
        return decode
    if fault == "frozen_step":   # returns its state unchanged
        return lambda caches, token, *a, **k: (token, caches)

    def wrapped(caches, token, position, pad_start, step, init):
        nxt, caches = decode(caches, token, position, pad_start, step, init)
        if fault == "altered_token" and step >= 5:
            nxt = (nxt + 1) % vocab
        elif fault == "half_batch":   # the larger half left out
            h = (nxt.shape[0] + 1) // 2
            nxt = torch.cat([nxt[:nxt.shape[0] - h], nxt[:h]])
        return nxt, caches
    return wrapped


def gap_stats(g: torch.Tensor) -> dict:
    """How the checked positions' gaps spread: positions, the share above
    0, the median, the mean, the 99th percentile and the widest."""
    g = g.flatten().float()
    return {"positions": g.numel(), "share_over_0": float((g > 0).float()
                                                          .mean()),
            "median": float(g.median()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)), "max": float(g.max())}


# The numbers a check can compare, over the checked rows' gaps (one
# tensor a row: at each position, by how much the served token's reference
# logit lies below the reference's best): the widest gap anywhere.
NUMBERS = {
    "max_logit_gap": lambda rows: max(float(r.max()) for r in rows),
}


def checks(rows: list, limits: dict) -> list:
    """(name, number, limit) of each number the cell's file limits."""
    return [(name, NUMBERS[name](rows), lim) for name, lim in limits.items()]


def check_rows(lens, n: int, seed: int) -> list[int]:
    """``n`` rows drawn from the seed, the longest prompt's first."""
    longest = int(np.argmax(lens))
    rest = [i for i in traffic.rng(seed, "check").permutation(len(lens))
            if i != longest]
    return sorted([longest] + [int(i) for i in rest[:n - 1]])


def run(ctx) -> dict:
    hf, tr, dev = ctx.hf, ctx.traffic, ctx.device
    b, s, steps = tr["batch"], tr["bucket"], tr["replay_steps"]
    vocab = hf["vocab_size"]
    mode, comp = tr["mode"], tr.get("compression")
    raw = mode == "raw"
    fmt = counts.kv_format(None if raw else comp,
                           hf.get("head_dim") or
                           hf["hidden_size"] // hf["num_attention_heads"])

    params = weights.make(hf, ctx.seed, dev)
    r = traffic.rng(ctx.seed, "prompts")
    lens = traffic.even_lengths(*tr["prompt_len"], b, r)
    tok_np, mask_np = traffic.left_pad(traffic.prompts(lens, vocab, r), s)
    tokens = torch.from_numpy(tok_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    prog = ctx.family.Program(hf, params, comp, mode, tr["max_len"], b, dev)
    decode = _faulty(prog.decode, ctx.fault, vocab)
    rope = prog.rope
    starts = inits.Inits(ctx.seed, dev)

    logits0, caches = prog.prefill(tokens, mask, starts)
    tok0 = torch.argmax(logits0, dim=-1)
    del logits0
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad_start = (s - prompt_len).to(torch.int32)
    positions = [prompt_len + j for j in range(steps)]
    snap = snapshot(caches)
    kv_bytes = store_bytes(caches) / (b * tr["max_len"])
    cur = tok0
    for j in range(tr["warm_steps"]):
        cur, caches = decode(caches, cur, positions[j], pad_start, j, starts)
        cur.tolist()
    restore(caches, snap)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - ctx.t_start

    # -- the window ------------------------------------------------------
    from torch.profiler import record_function

    stretch = trace.Stretch(ctx.trace, tr["trace_from"], tr["trace_steps"])
    clock = Clock(dev)
    done, served, replays = None, [], 0
    j = k = 0
    cur = tok0
    t0 = time.perf_counter()
    clock.mark()
    while True:
        if j == steps:
            done, served, replays = served, [], replays + 1
            with record_function("portbench.restore"):
                restore(caches, snap)
            j, cur = 0, tok0
        with stretch.step(k, tag=j):
            with record_function("portbench.step"):
                cur, caches = decode(caches, cur, positions[j], pad_start, j,
                                     starts)
                clock.mark()
                cur.tolist()
        served.append(cur)
        j += 1
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t_end = time.perf_counter()
    stretch.close()
    gaps = clock.gaps_ms()
    n_tokens = k * b
    attempted = b * (replays + (1 if served else 0))

    if done is None:  # finish the replay in progress, after the close
        while j < steps:
            cur, caches = decode(caches, cur, positions[j], pad_start, j,
                                 starts)
            served.append(cur)
            j += 1
        done = served
    served_tok = torch.stack([tok0] + done, dim=1)        # [B, steps + 1]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del caches, snap, prog, decode, served, done
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    rows = check_rows(lens, tr["check_rows"], ctx.seed)
    ridx = torch.tensor(rows, device=dev)
    hd = fmt.head_dim
    seq = torch.cat([tokens[ridx], served_tok[ridx, :steps]], dim=1)
    ref = decoder.forward(
        params, hf, seq, mask[ridx], "raw" if raw else "gear", fmt=fmt,
        loop=(comp or {}).get("loop", 3),
        inits=starts.for_rows(ridx, b, hf.get("num_key_value_heads"), hd,
                              fmt))
    best = ref.max(dim=-1).values
    gaps_ref = best - torch.gather(ref, -1, served_tok[ridx][..., None])[..., 0]
    control = None
    if getattr(ctx, "control", False):
        low = decoder.forward(
            params, hf, seq, mask[ridx], "raw" if raw else "gear", fmt=fmt,
            loop=(comp or {}).get("loop", 3), precision="fp8",
            inits=starts.for_rows(ridx, b, hf.get("num_key_value_heads"),
                                  hd, fmt))
        pick = torch.argmax(low, dim=-1, keepdim=True)
        control = best - torch.gather(ref, -1, pick)[..., 0]

    traced = stretch.summary
    first, n = tr["trace_from"], tr["trace_steps"]
    overhead = None
    if traced is not None and len(gaps) >= first + n:
        inside = gaps[first:first + n]
        outside = gaps[:first - stretch.pad] + gaps[first + n + 1:]
        overhead = {"traced_step_ms": float(np.mean(inside)),
                    "untraced_step_ms": float(np.mean(outside))
                    if outside else None}
    e2e = {"output_tok_s": n_tokens / (t_end - t0),
           "itl_p95_ms": float(np.percentile(gaps, 95)),
           "kv_bytes_per_token": kv_bytes,
           "setup_s": setup_s}
    metric_ctx = {
        "hf": hf, "fmt": fmt, "raw": raw, "trace": traced,
        "steps": stretch.steps, "bucket": s,
        "prefill_len": 0 if raw else (s // fmt.group) * fmt.group,
        "pad_starts": pad_start.tolist(),
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else None,
    }
    extra = {"window": {"steps": k, "replays_done": replays,
                        "seconds": t_end - t0, "gap_ms_median":
                        float(np.median(gaps)), "gap_ms_max": max(gaps)},
             "checked_rows": rows, "gaps": gap_stats(gaps_ref),
             "rope": rope}
    if control is not None:
        extra["control_numbers"] = {n: v for n, v, _ in
                                    checks(list(control), tr["limits"])}
        extra["control_gaps"] = gap_stats(control)
    if overhead is not None:
        extra["trace_overhead"] = overhead
    return {"e2e": e2e, "ctx": metric_ctx, "attempted": attempted,
            "failed": 0, "memory_peak_bytes": peak, "trace": traced,
            "checks": checks(list(gaps_ref), tr["limits"]),
            "extra": extra}
