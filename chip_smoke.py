#!/usr/bin/env python3
"""Smoke run of gear_tpu_torch (the PyTorch/CUDA port) on one CUDA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing lines of its own:
  1. the card (nvidia-smi name and power limit) and the kernels' build time;
  2. the pack kernels against their plain versions (D=128, group 64, v_group
     64) at B=4, H=32, S=2048 with bits 2/4/8 and, at int4, at the shapes
     the two end-to-end prefills below give them (Llama-2-7B: 128 rows of
     1024 bf16 tokens; Mistral-7B: 16 rows of 4352 tokens, outliers
     replaced by the block mean): words, scales and minima must be
     bit-equal;
  3. the decode kernel against the plain ``cache.attend`` on full-width
     caches built by the port's own prefill + append across a flush: GEARL
     (bits 2/4/8, GQA 32/8 heads, left padding, a sliding window that cuts
     into the prefix), GEAR with 162 outliers per block (int4, int2, GQA),
     int8 bases, GEAR + int8 bases + KCVT together, no low-rank term, and
     GEARL and GEAR at the shapes the two end-to-end paths below give the
     kernel;
  4. the flash-decode kernel against the plain ``raw_attend`` over bf16 raw
     caches (32 heads and 8 kv / 32 q heads, 1,930 and 4,400 valid tokens,
     left padding, a window), with ``scaled_dot_product_attention`` timed
     beside it as the library's call for the same function;
  5. end to end through ``GearLM``, seeded random bf16 weights, group 64,
     rank 2, prefill rank 4, loop 3, 80 new tokens, in ``fused`` and ``raw``
     mode, plus int8 fused vs raw greedy agreement:
     Mistral-7B (32 layers, 8 kv heads, window 4096) with GEAR int4, batch
     2, prompts of ~4,300 tokens, so that the window binds from the first
     decode step; and Llama-2-7B with GEARL int4, batch 4, prompts of ~1,000
     tokens. Each run's launch counts are set to 0 just before it and read
     just after: fused mode must have gone through the decode and pack
     kernels, raw mode through the flash kernel;
  6. a small model in fused mode (GEARL, then GEAR), decoding in lockstep on
     the card (kernels) and on the CPU (plain path) from one prefill: the
     logits must agree.

Any failed check raises, so the script exits non-zero. The second-to-last
line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``. The compiler log and the kernels' record
also go to gear_tpu_torch/_build/.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "gear_tpu_torch" / "_build"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL_DECODE = dict(rtol=1e-3, atol=1e-4)  # both float32; sum order differs


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of a call, from the profiler's kernel records.

    Before each call a 256 MiB buffer is zeroed, so the call finds the 50 MB
    L2 cold, as a decode step finds each layer's cache. The time counted is
    that of the device kernels the call launched (the zeroing kernel
    excluded), so the wrapper's host work does not inflate it.
    """

    SCRUB = "FillFunctor<unsigned char>"

    def __init__(self, torch):
        self.torch = torch
        self.scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, names=None) -> float:
        """Mean device ms per call; ``names``: count only the kernels whose
        names contain one of these (the kernel itself, not its wrapper's
        small tensor ops)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _attempt in range(2):  # a trace can come back empty; retry once
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.scrub.zero_()
                    fn()
                torch.cuda.synchronize()
            total_us = sum(
                e.device_time_total for e in prof.key_averages()
                if self.SCRUB not in e.key
                and (names is None or any(n in e.key for n in names)))
            if total_us > 0:
                return total_us / iters / 1e3
        raise RuntimeError("the profiler recorded no device time")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cleaned_blocks(torch, x, hkv):
    """The blocks the GEAR prefill hands the pack kernels: bf16 values, the
    162 outliers of every 64-token block replaced by the block's mean."""
    from gear_tpu_torch import cache as TC

    n, s, d = x.shape
    spec = TC.CacheSpec(batch=n // hkv, num_kv_heads=hkv, head_dim=d,
                        max_len=s, bits=4, group=64, outliers_per_block=162)
    x4 = x.bfloat16().reshape(n // hkv, hkv, s, d)
    return TC._extract_outliers(spec, x4)[0].reshape(n, s, d).contiguous()


# (rows n = batch x kv heads, tokens, code widths, cleaned of outliers, the
# suffix of the rows of the kernels' record this case fills)
PACK_CASES = [
    (4 * 32, 2048, (2, 4, 8), False, None),
    # the Llama-2-7B path's prefill: batch 4, 32 kv heads, bucket 1024
    (4 * 32, 1024, (4,), False, ""),
    # the Mistral-7B path's prefill: batch 2, 8 kv heads, bucket 4352, GEAR
    (2 * 8, 4352, (4,), True, "_gear"),
]


def phase_pack(torch, timer, record):
    from gear_tpu_torch.kernels import pack as TP

    d, g = 128, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, s, widths, cleaned, row in PACK_CASES:
        x = torch.randn((n, s, d), generator=gen, device="cuda")
        if row is not None:  # the model hands over bf16 values
            x = x.bfloat16().float()
        if cleaned:
            x = cleaned_blocks(torch, x, 8)
        for bits in widths:
            wd = d * bits // 32
            for kern, plain, kw, side in (
                    (TP.quant_pack_tokens, TP.quant_pack_tokens_plain,
                     dict(v_group=g), n * s * (d // g)),
                    (TP.quant_pack_channels, TP.quant_pack_channels_plain,
                     dict(group=g), n * (s // g) * d)):
                got = kern(x, bits=bits, **kw)
                want = plain(x, bits=bits, **kw)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    check(a.shape == b.shape and torch.equal(a, b),
                          f"{kern.__name__} bits={bits} [{n}x{s}x{d}] "
                          "bit-equal to plain")
                err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
                ms = timer(lambda: kern(x, bits=bits, **kw), names=(
                    "token_kernel" if kern is TP.quant_pack_tokens
                    else "channel_kernel",))
                plain_ms = timer(lambda: plain(x, bits=bits, **kw), iters=5)
                nbytes = x.numel() * 4 + n * s * wd * 4 + 2 * side * 4
                bms, by = bound_ms(nbytes, 8 * x.numel())
                log(f"pack {kern.__name__} bits={bits} [{n}x{s}x{d}]"
                    f"{' outlier-cleaned' if cleaned else ''} bit-equal "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bms:.4f} ({by})")
                if row is not None:
                    record[kern.__name__ + row] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None)
        del x


DECODE_KERNELS = ("decode_split_kernel", "attn_merge_kernel")
FLASH_KERNELS = ("flash_split_kernel", "attn_merge_kernel")


def live_tokens(pad, window, total, upto, batch):
    """Per sequence, the tokens of [0, upto) that the masks let through:
    those at or right of max(pad_start, total - window)."""
    first = [0] * batch if pad is None else list(pad)
    if window is not None:
        first = [max(f, total - window) for f in first]
    return [upto - min(max(f, 0), upto) for f in first]


# (name, CacheSpec kwargs, kv heads, q heads, pad_start, window, the row of
# the kernels' record this case fills)
DECODE_CASES = [
    ("gearl int2", dict(bits=2), 32, 32, None, None, None),
    ("gearl int4", dict(), 32, 32, None, None, None),
    ("gearl int8", dict(bits=8), 32, 32, None, None, None),
    ("gearl int4 gqa", dict(), 8, 32, None, None, None),
    ("gearl int4 pad", dict(), 32, 32, [0, 100, 257, 1000], None, None),
    ("gear int4", dict(outliers_per_block=162), 32, 32, None, None, None),
    ("gear int2", dict(outliers_per_block=162, bits=2), 32, 32, None, None,
     None),
    ("int8 bases", dict(base_bits=8), 32, 32, None, None, None),
    ("gear + int8 bases + kcvt", dict(outliers_per_block=162, base_bits=8,
                                      kcvt_prefill=True), 32, 32, None, None,
     None),
    ("gearl window 1000", dict(), 32, 32, [0, 100, 257, 1000], 1000, None),
    ("gear gqa", dict(outliers_per_block=162), 8, 32, None, None, None),
    ("gear, no low-rank term", dict(outliers_per_block=162, rank=0,
                                    prefill_rank=0), 32, 32, None, None, None),
]


def decode_case(torch, timer, gen, name, kw, hkv, hq, pad, window, *,
                b=4, t=2048, n_prefill=1900, n_append=30):
    """Build a full-width cache with the port's own prefill + appends across
    a flush, hold the kernel against the plain ``cache.attend`` on it, and
    time both. Returns the row for the kernels' record."""
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.kernels import decode as TK

    d, g = 128, 64
    spec = TC.CacheSpec(batch=b, num_kv_heads=hkv, head_dim=d, max_len=t,
                        **{"bits": 4, "group": g, "rank": 2,
                           "prefill_rank": 4, "lowrank_loop": 3, **kw})
    shape = (b, hkv, n_prefill, d)
    k = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    v = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    cache = TC.prefill(spec, k, v, generator=gen)
    del k, v
    for _ in range(n_append):
        kn = torch.randn((b, hkv, 1, d), generator=gen, device="cuda")
        vn = torch.randn((b, hkv, 1, d), generator=gen, device="cuda")
        TC.append(spec, cache, kn.bfloat16(), vn.bfloat16(), generator=gen)
    total = n_prefill + n_append
    check(cache.comp_len == total // g * g and cache.resid_len == total % g
          and cache.comp_len > cache.prefill_len, "decode cache lengths")
    q = torch.randn((b, hq, 1, d), generator=gen, device="cuda")
    gq = hq // hkv
    pad_t = None if pad is None else torch.tensor(
        pad, dtype=torch.int32, device="cuda")
    kwargs = dict(pad_start=pad_t, window=window)
    got = TK.attend_fused(spec, cache, q, **kwargs)
    want = TC.attend(spec, cache, q, **kwargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-6)).max())
    check(bool(torch.isfinite(got).all()), "decode output finite")
    ok = torch.allclose(got, want, **TOL_DECODE)
    ms = timer(lambda: TK.attend_fused(spec, cache, q, **kwargs),
               names=DECODE_KERNELS)
    plain_ms = timer(lambda: TC.attend(spec, cache, q, **kwargs), iters=5)

    # The least the card must move: per sequence only the tokens the masks
    # let through, whole quant blocks of them for the per-block parts.
    r, c, rl = spec.r_store, cache.comp_len, cache.resid_len
    ko, bel = spec.ko_store, (1 if spec.base_bits == 8 else 2)
    nbytes = ops = 0
    for live in live_tokens(pad, window, total, c, b):
        blocks = -(-live // g)
        first_blk = (c - live) // g
        # distinct P bases: the prefill's blocks all hold one copy of its P
        pre_blocks = max(0, cache.prefill_len // g - first_blk)
        n_p = (pre_blocks > 0) + blocks - pre_blocks
        per_head = (2 * spec.v_words * live * 4          # K, V codes
                    + 2 * blocks * d * 2                 # K scale, mn
                    + 2 * spec.v_groups_per_token * live * 2  # V scale, mn
                    + 2 * r * live * bel                 # kqt, vqt
                    + 2 * n_p * r * d * bel              # kpt, vpt
                    + 2 * rl * d * 2                     # residual tier
                    + 2 * gq * d * 4)                    # q in, out
        if spec.base_bits == 8:
            per_head += 4 * n_p * r * 4                  # four f32 scales
        if ko:  # per block and tensor: index + delta per entry, the table
            per_head += 2 * blocks * (ko * 4 + 128 * 4)
        nbytes += hkv * per_head
        ops += hkv * gq * (live * (4 * d + 4 * r) + rl * 4 * d
                           + blocks * 4 * ko)
    bms, by = bound_ms(nbytes, ops)
    log(f"decode [{name}] bits={spec.bits} hkv={hkv} hq={hq} pad={pad} "
        f"window={window} max_len={t} comp={c} resid={rl} ko_store={ko} "
        f"base_bits={spec.base_bits} max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} tol(rtol={TOL_DECODE['rtol']}, "
        f"atol={TOL_DECODE['atol']}) {'ok' if ok else 'FAIL'} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
        f"({by}, {nbytes} bytes)")
    check(ok, f"decode kernel within tolerance [{name}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def phase_decode(torch, timer, record):
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"decode_attention": 0.0, "decode_attention_gear": 0.0}
    for name, kw, hkv, hq, pad, window, row in DECODE_CASES:
        res = decode_case(torch, timer, gen, name, kw, hkv, hq, pad, window)
        fam = ("decode_attention_gear" if kw.get("outliers_per_block")
               else "decode_attention")
        worst[fam] = max(worst[fam], res["max_abs_err"])
        if row:
            record[row] = res
    # the GEARL row: the shapes the Llama-2-7B path below gives the kernel
    # near its end (batch 4, 32 heads, bucket 1024 + 70 steps, left padding)
    res = decode_case(torch, timer, gen, "gearl int4, Llama-2-7B path shapes",
                      dict(), 32, 32, [24, 0, 47, 13], None,
                      b=4, t=1152, n_prefill=1024, n_append=70)
    worst["decode_attention"] = max(worst["decode_attention"],
                                    res["max_abs_err"])
    record["decode_attention"] = res
    # the GEAR row: the shapes the Mistral-7B path below gives the kernel
    # (batch 2, 8 kv / 32 q heads, ~4,400 tokens, window 4096, left padding)
    res = decode_case(torch, timer, gen, "gear int4, Mistral-7B path shapes",
                      dict(outliers_per_block=162), 8, 32, [0, 130], 4096,
                      b=2, t=4480, n_prefill=4352, n_append=70)
    worst["decode_attention_gear"] = max(worst["decode_attention_gear"],
                                         res["max_abs_err"])
    record["decode_attention_gear"] = res
    for fam, err in worst.items():  # the largest error over all its cases
        record[fam]["max_abs_err"] = err


FLASH_CASES = [  # (kv heads, q heads, batch, max_len, length, pad, window, row)
    (32, 32, 4, 2048, 1930, None, None, None),
    (32, 32, 4, 2048, 1930, [0, 100, 257, 1000], None, None),
    (8, 32, 4, 2048, 1930, None, None, None),
    (32, 32, 4, 4480, 4400, None, None, None),
    (8, 32, 4, 4480, 4400, [0, 100, 257, 1000], 4096, None),
    (8, 32, 2, 4480, 4400, [0, 130], 4096, "flash_decode"),  # Mistral path
]


def phase_flash(torch, timer, record):
    import torch.nn.functional as F

    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.kernels import flash as TF
    from gear_tpu_torch.models import llama

    d = 128
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for hkv, hq, b, t, length, pad, window, row in FLASH_CASES:
        spec = TC.CacheSpec(batch=b, num_kv_heads=hkv, head_dim=d, max_len=t)
        k = torch.randn((b, hkv, t, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((b, hkv, t, d), generator=gen,
                        device="cuda").bfloat16()
        c = llama.RawLayerCache(k=k, v=v, length=length)
        q = torch.randn((b, hq, 1, d), generator=gen, device="cuda")
        gq = hq // hkv
        pad_t = None if pad is None else torch.tensor(
            pad, dtype=torch.int32, device="cuda")
        kwargs = dict(pad_start=pad_t, window=window)
        got = TF.raw_attend_flash(spec, c, q, **kwargs)
        want = llama.raw_attend(spec, c, q, **kwargs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all()), "flash output finite")
        ok = torch.allclose(got, want, **TOL_DECODE)
        ms = timer(lambda: TF.raw_attend_flash(spec, c, q, **kwargs),
                   names=FLASH_KERNELS)
        plain_ms = timer(lambda: llama.raw_attend(spec, c, q, **kwargs),
                         iters=5)
        # one PyTorch call for the same function (q rounded to bf16 there)
        lives = live_tokens(pad, window, length, length, b)
        pos = torch.arange(t, device="cuda")
        first = torch.tensor([length - n for n in lives], device="cuda")
        mask = ((pos[None] >= first[:, None]) & (pos[None] < length))
        mask = mask[:, None, None, :]
        qb = q.bfloat16()

        def sdpa():
            return F.scaled_dot_product_attention(qb, k, v, attn_mask=mask,
                                                  enable_gqa=gq > 1)

        lib = sdpa().float()
        torch.cuda.synchronize()
        lib_err = float((lib - want).abs().max())
        check(lib_err < 2e-2, "the library call computes the same function "
                              "(bf16 rounding apart)")
        lib_ms = timer(sdpa)
        nbytes = sum(hkv * (2 * n * d * 2 + 2 * gq * d * 4) for n in lives)
        ops = sum(hkv * gq * n * 4 * d for n in lives)
        bms, by = bound_ms(nbytes, ops)
        log(f"flash hkv={hkv} hq={hq} batch={b} max_len={t} length={length} "
            f"pad={pad} window={window} max_abs_err={err:.3e} "
            f"tol(rtol={TOL_DECODE['rtol']}, atol={TOL_DECODE['atol']}) "
            f"{'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}, {nbytes} "
            f"bytes) library_ms={lib_ms:.4f} (scaled_dot_product_attention, "
            f"bf16 q, bool mask; |lib - plain| max {lib_err:.2e})")
        check(ok, f"flash kernel within tolerance (hkv={hkv} pad={pad} "
                  f"window={window})")
        if row:
            record[row] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bms, bound_by=by, library_ms=lib_ms)
        del k, v, c
    record["flash_decode"]["max_abs_err"] = worst


def step_breakdown(torch, eng, prompts, lens, n_steps=70):
    """Where a decode step's time goes, outside the main-path run: each of
    ``n_steps`` steps timed on the host clock between synchronisations (the
    residual tier's flush falls on one of them), then five steady steps
    under the profiler for the device time per step. Returns the median
    step in ms and the line to print."""
    from torch.profiler import ProfilerActivity, profile

    s = eng.bucket_len(max(lens))
    tokens, mask = eng.left_pad(prompts, 0, s)
    logits, caches = eng.prefill(tokens, mask)
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad = (s - prompt_len).to(torch.int32)
    cur = logits[:, -1].argmax(-1)
    del logits
    times, flush_at = [], None
    for i in range(n_steps):
        before = getattr(caches, "comp_len", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, _, caches = eng.decode_step(caches, cur, prompt_len + i, pad,
                                         step=i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if getattr(caches, "comp_len", None) != before:
            flush_at = i
    steady = sorted(t for i, t in enumerate(times) if i != flush_at)
    median = steady[len(steady) // 2]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps, n_steps + 5):
            cur, _, caches = eng.decode_step(caches, cur, prompt_len + i, pad,
                                             step=i)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device_ms = sum(e.device_time_total for e in rows) / 5 / 1e3
    n_kernels = sum(e.count for e in rows) / 5
    flush = "none" if flush_at is None else f"{times[flush_at]:.1f}"
    return median, (
        f"median_step_ms={median:.2f} min_step_ms={steady[0]:.2f} "
        f"flush_step_ms={flush} device_ms_per_step={device_ms:.2f} "
        f"device_launches_per_step={n_kernels:.0f} "
        f"device_busy_share={device_ms / median:.3f}")


def phase_e2e(torch, tag, cfg, method, batch, lens, n_new, max_len,
              depth_note):
    """Generation through ``GearLM`` at the full width of one model, seeded
    random weights, in fused and in raw mode. Returns the launch counts of
    the two main-path runs."""
    import numpy as np

    from gear_tpu_torch import kernels
    from gear_tpu_torch.api import GearLM
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig
    from gear_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"e2e {tag}: hidden {cfg.hidden_size}, FFN {cfg.intermediate_size}, "
        f"heads {cfg.num_heads} / kv {cfg.num_kv_heads}, window "
        f"{cfg.sliding_window}, layers {cfg.num_layers} ({depth_note}), "
        f"{cfg.dtype}; {method} group 64 rank 2 prefill rank 4 loop 3 "
        f"left 0.02; batch {batch}, prompts {lens}, {n_new} new tokens, "
        f"max_len {max_len}; random init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]

    def lm_for(mode, bits):
        comp = CompressionConfig(num_layers=cfg.num_layers,
                                 compress_method=method, quantize_bit=bits,
                                 group_size=64, rank=2, prefill_rank=4,
                                 loop=3, left=0.02)
        return GearLM(cfg=cfg, params=params, comp=comp,
                      engine_cfg=EngineConfig(max_len=max_len, mode=mode),
                      batch_size=batch)

    results, counts = {}, {}
    steps = n_new - 1
    for mode in ("fused", "raw"):
        lm = lm_for(mode, 4)
        eng = lm.engine
        lm.generate(prompts, 2)  # warm-up: CUDA context, cuBLAS handles
        # prefill alone, timed, and its logits checked
        s = eng.bucket_len(max(lens))
        tokens, mask = eng.left_pad(prompts, 0, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = eng.prefill(tokens, mask)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(logits[:, -1]).all()), f"{mode} prefill "
              "logits finite")
        del logits, caches
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.generate(prompts, n_new)  # the main path
        total_ms = (time.perf_counter() - t0) * 1e3
        counts[mode] = kernels.launch_counts()
        check(len(out) == batch and all(len(o) == n_new for o in out),
              f"{mode} output shape")
        check(all(0 <= x < cfg.vocab_size for o in out for x in o),
              f"{mode} tokens in range")
        results[mode] = out
        spec = eng.spec
        kv = (spec.bytes_compressed() if mode == "fused"
              else spec.bytes_fp16_baseline()) * cfg.num_layers
        log(f"e2e {tag} {mode}: prefill_ms={prefill_ms:.1f} "
            f"generate_ms={total_ms:.1f} ({n_new} tokens, one host-clock "
            f"sample; less the prefill timed before it, over {steps} steps: "
            f"{(total_ms - prefill_ms) / steps:.2f} ms, one flush included) "
            f"kv_bytes={kv} "
            f"(bf16 baseline {spec.bytes_fp16_baseline() * cfg.num_layers}) "
            f"launches={counts[mode]}")
        median, line = step_breakdown(torch, eng, prompts, lens)
        log(f"e2e {tag} {mode} steps, host clock, synchronised each: {line} "
            f"tokens_per_s={batch / median * 1e3:.1f} (batch / median step)")
        del lm, eng

    n_l = cfg.num_layers
    f, r = counts["fused"], counts["raw"]
    check(f["decode_attention"] == n_l * steps and f["flash_decode"] == 0,
          f"{tag} fused: decode kernel launched layers x decode steps")
    check(f["quant_pack_tokens"] == n_l and f["quant_pack_channels"] == n_l,
          f"{tag} fused: pack kernels launched once per layer per prefill")
    check(r["flash_decode"] == n_l * steps and r["decode_attention"] == 0
          and r["quant_pack_tokens"] == 0,
          f"{tag} raw: flash kernel launched layers x decode steps")

    horizon = 12
    fused8 = lm_for("fused", 8).generate(prompts, horizon)
    agree = float(np.mean([a == b for rf, rr in zip(fused8, results["raw"])
                           for a, b in zip(rf, rr[:horizon])]))
    log(f"e2e {tag}: int8 {method} fused vs raw greedy agreement over "
        f"{horizon} tokens: {agree:.3f}")
    del params
    torch.cuda.empty_cache()
    return counts


def phase_small(torch, method):
    """The fused model on a small input: kernels on the card against the
    plain path on the CPU, in lockstep from one prefill, across a flush."""
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.models import llama

    cfg = llama.ModelConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                                 head_dim=64, intermediate_size=512)
    params = llama.init_params(cfg, seed=3)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method=method, quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=3,
                             left=0.02)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=128, mode="fused"), batch_size=2)
    check(bool(eng.spec.outliers_per_block) == (method == "GEAR"),
          "small model: outliers with GEAR only")

    def init(site, shape):  # the same power-iteration inits on both sides
        gen = torch.Generator().manual_seed(hash(site) % (1 << 31))
        return torch.rand(shape, generator=gen)

    tokens, mask = eng.left_pad([[5, 9, 2, 7, 11, 3, 8], [4, 1, 6]], 0, 16)
    logits, caches = eng.prefill(tokens, mask, init=init)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    cpu_caches = TC.LayerCache(
        **{f: getattr(caches, f).cpu() for f in TC.TENSOR_FIELDS},
        **{f: getattr(caches, f) for f in TC.LENGTH_FIELDS})
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad = (16 - prompt_len).to(torch.int32)
    cur = logits[:, -1].argmax(-1)
    worst = 0.0
    for step in range(20):  # flushes the residual tier at step 15
        kw = dict(spec=eng.spec, step=step, init=init)
        lg, caches = llama.forward_decode(
            params, cfg, cur, prompt_len + step, caches, pad_start=pad, **kw)
        lc, cpu_caches = llama.forward_decode(
            cpu_params, cfg, cur.cpu(), (prompt_len + step).cpu(), cpu_caches,
            pad_start=pad.cpu(), **kw)
        scale = float(lc.abs().max())
        worst = max(worst, float((lg.cpu() - lc).abs().max()) / scale)
        cur = lg.argmax(-1)
    log(f"small model, {method} fused: card (kernels) vs CPU (plain path) "
        f"over 20 decode steps, max |logit diff| / max |logit| = {worst:.3e} "
        f"(limit 5e-2: bf16 projections round differently on the two)")
    check(caches.comp_len == 32, "small model flushed once")
    check(worst < 5e-2, "small model: card and CPU logits agree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from gear_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    so, build_log = _build.build()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {so.name}")
    (OUT / "nvcc_log.txt").write_text(build_log)
    spills = [ln.strip() for ln in build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    log(f"ptxas: {len(regs)} kernels; register lines: "
        f"{sorted(set(r.split('Used ')[-1] for r in regs))[:6]}; "
        f"non-zero spill lines: {len(spills)}")

    from gear_tpu_torch.models import llama, mistral

    timer = Timer(torch)
    record: dict = {}
    counts: dict = {}
    llama_cfg = llama.ModelConfig.llama2_7b()
    phases = {
        "pack": lambda: phase_pack(torch, timer, record),
        "decode": lambda: phase_decode(torch, timer, record),
        "flash": lambda: phase_flash(torch, timer, record),
        # the Mistral-7B path (GQA, window 4096): the full GEAR
        # recipe, prompts past the window so that it binds from step one
        "e2e mistral": lambda: counts.update(mistral=phase_e2e(
            torch, "Mistral-7B", mistral.mistral_7b(), "GEAR", 2,
            [4300, 4210], 80, 4480, "depth not cut")),
        # the Llama-2-7B path: GEARL, raw mode on the flash kernel
        "e2e llama": lambda: counts.update(llama=phase_e2e(
            torch, "Llama-2-7B", llama_cfg, "GEARL", 4,
            [1000, 1024, 977, 1011], 80, 1152, "depth not cut")),
        "small gearl": lambda: phase_small(torch, "GEARL"),
        "small gear": lambda: phase_small(torch, "GEAR"),
    }
    for name in phases:
        t0 = time.perf_counter()
        phases[name]()
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")

    # (record row, wrapper, source, TPU kernel it replaces, path and mode
    # whose launch count it reports)
    info = [
        ("decode_attention", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "llama", "fused"),
        ("decode_attention_gear", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "mistral", "fused"),
        ("quant_pack_channels", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "llama", "fused"),
        ("quant_pack_tokens", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "llama", "fused"),
        ("quant_pack_channels_gear", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "mistral", "fused"),
        ("quant_pack_tokens_gear", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "mistral", "fused"),
        ("flash_decode", "flash_decode", "gear_tpu_torch/csrc/flash.cu",
         "gear_tpu/kernels/flash.py:32", "mistral", "raw"),
    ]
    kern = []
    for row, wrapper, src, rep, path, mode in info:
        launches = counts[path][mode][wrapper]
        check(launches > 0, f"{row}: launched on the {path} {mode} path")
        kern.append({"name": row, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches, **record[row]})
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kern}, indent=1))
    log(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
