#!/usr/bin/env python3
"""Smoke run of gear_tpu_torch (the PyTorch/CUDA port) on one CUDA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing lines of its own:
  1. the card (nvidia-smi name and power limit) and the kernels' build time;
  2. the pack kernels against their plain versions (D=128, group 64, v_group
     64) at B=4, H=32, S=2048 with bits 2/4/8 and, at int4, at the shapes
     the end-to-end prefills below give them (Llama-2-7B: 128 rows of 1024
     bf16 tokens, as float32 and as the bf16 the GEARL path hands both,
     K as a strided view of the model's [B, S, H, D] projection;
     Mistral-7B: 16 rows of 4352 tokens, outliers replaced
     by the block mean, float32; a serving admission: 32 rows of 3008
     tokens, cleaned likewise): words, scales and minima must be
     bit-equal; and in the profiler's trace of the GEARL prefill's K route
     no kernel may run before the channel pack (no copy of K);
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
  6. simulated mode (the accuracy path) through ``GearLM`` at the full
     width and depth of Llama-2-7B, GEAR int4, batch 4, prompts of ~1,000
     tokens, 130 new tokens (the whole cache recompressed after decode steps
     63 and 127; max_len 1216, since 1024 + 129 tokens overflow 1152): one
     layer's prompt ``compress_kv`` on the card against the CPU, method NONE
     against raw mode's greedy tokens, the flash kernel launched once per
     layer per decode step, finite logits; prefill, step and recompression
     times beside raw mode's;
  7. a small model in fused mode (GEARL, then GEAR), decoding in lockstep on
     the card (kernels) and on the CPU (plain path) from one prefill: the
     logits must agree;
  8. the paged decode kernel against the plain ``paged.attend_gathered`` on
     pools built by the port's own ``prefill_paged`` + ``append_paged``
     across a flush: rows of different lengths on page ids out of order and
     interleaved between rows, one page shared by two rows, one parked row;
     GEARL and GEAR int4, int2, int8, int8 bases, GQA, left padding, a
     window that cuts into one row's prefix and not another's, pages of 64
     and of 256 tokens, and the shapes of the serving path below;
  9. continuous-batching serving through ``PagedServingEngine`` at the full
     width and depth of Llama-2-7B, GEAR int4, 8 slots over a pool of 96
     pages of 256 tokens, 12 requests from a numpy seed (the first 8 prompts
     near 3,000 tokens, so that the 8th admission waits for pages); launch
     counts set to 0 just before and read just after; mid-run one layer's
     paged attention is held against the plain version on the live pool and
     both are timed there (the paged kernel's row of the kernels' record);
  10. a small model served by ``PagedServingEngine`` on the card (kernels) and
     on the CPU (plain path) in lockstep, with a pool small enough to force
     a preemption: the logits must agree; then the dense ``ServingEngine``
     on the card against the paged one.

Any failed check raises, so the script exits non-zero. The second-to-last
line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``. The compiler log and the kernels' record
also go to gear_tpu_torch/_build/.
"""
from __future__ import annotations

import json
import re
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
    PAD = 32  # zeroings of 4 KB before and after the calls

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
        # A trace can lose records, the first few of a profile among them
        # (PERF.md): small zeroings, left out of the sum, pad the calls on
        # both sides, and a trace is taken only if it holds a whole number
        # of launches a call.
        pad = self.scrub[:4096]
        seen = []
        for _attempt in range(4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(self.PAD):
                    pad.zero_()
                for _ in range(iters):
                    self.scrub.zero_()
                    fn()
                for _ in range(self.PAD):
                    pad.zero_()
                torch.cuda.synchronize()
            scrubs, launches, total_us = 0, 0, 0.0
            for e in prof.key_averages():
                if e.device_time_total <= 0:
                    continue
                if self.SCRUB in e.key:
                    scrubs += e.count
                elif names is None or any(n in e.key for n in names):
                    launches += e.count
                    total_us += e.device_time_total
            if scrubs >= iters and launches and launches % iters == 0:
                return total_us / iters / 1e3
            seen.append((scrubs - 2 * self.PAD, launches, sorted(
                (e.key[:60], e.count) for e in prof.key_averages()
                if e.device_time_total > 0)))
        raise RuntimeError(f"the profiler recorded no whole trace of {iters} "
                           f"calls: (zeroings, launches, records) {seen}")


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


# (batch, kv heads, tokens, code widths, cleaned of outliers, input type,
# the suffix of the rows of the kernels' record this case fills)
PACK_CASES = [
    (4, 32, 2048, (2, 4, 8), False, "float32", None),
    # the Llama-2-7B path's prefill: batch 4, 32 kv heads, bucket 1024; the
    # GEARL path hands both packs its bf16 blocks: the token pack (B3) a
    # contiguous V, the channel pack (B2) K as the model's strided view of
    # its [B, S, H, D] projection
    (4, 32, 1024, (4,), False, "float32", ""),
    (4, 32, 1024, (4,), False, "bfloat16", "_bf16"),
    # the Mistral-7B path's prefill: batch 2, 8 kv heads, bucket 4352, GEAR
    # (the cleaned block is float32)
    (2, 8, 4352, (4,), True, "float32", "_gear"),
    # the serving path's admission prefill: one request, 32 kv heads, a
    # prompt near 3,000 tokens in its bucket of 3008, GEAR
    (1, 32, 3008, (4,), True, "float32", "_serving"),
]


def phase_pack(torch, timer, record):
    from gear_tpu_torch.kernels import pack as TP

    d, g = 128, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    for batch, hkv, s, widths, cleaned, dtype, row in PACK_CASES:
        n = batch * hkv
        x = torch.randn((n, s, d), generator=gen, device="cuda")
        if row is not None:  # the model hands over bf16 values
            x = x.bfloat16().float()
        if cleaned:
            x = cleaned_blocks(torch, x, hkv)
        x = x.to(getattr(torch, dtype))
        # B2's input as the model gives it: a [B, H, S, D] view of [B, S, H,
        # D] memory at bf16, contiguous float32 blocks otherwise
        xk = (x.reshape(batch, hkv, s, d).transpose(1, 2).contiguous()
              .transpose(1, 2) if dtype == "bfloat16" else x)
        for bits in widths:
            wd = d * bits // 32
            for kern, plain, kw, side, xin in (
                    (TP.quant_pack_tokens, TP.quant_pack_tokens_plain,
                     dict(v_group=g), n * s * (d // g), x),
                    (TP.quant_pack_channels, TP.quant_pack_channels_plain,
                     dict(group=g), n * (s // g) * d, xk)):
                got = kern(xin, bits=bits, **kw)
                want = plain(xin, bits=bits, **kw)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    check(a.shape == b.shape and torch.equal(a, b),
                          f"{kern.__name__} bits={bits} [{n}x{s}x{d}] "
                          "bit-equal to plain")
                err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
                ms = timer(lambda: kern(xin, bits=bits, **kw), names=(
                    "token_kernel" if kern is TP.quant_pack_tokens
                    else "channel_kernel",))
                plain_ms = timer(lambda: plain(xin, bits=bits, **kw), iters=5)
                nbytes = (xin.numel() * xin.element_size() + n * s * wd * 4
                          + 2 * side * 4)
                bms, by = bound_ms(nbytes, 8 * xin.numel())
                log(f"pack {kern.__name__} bits={bits} [{n}x{s}x{d}] {dtype}"
                    f"{' outlier-cleaned' if cleaned else ''} bit-equal "
                    f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bms:.4f} ({by})")
                if row is not None:
                    record[kern.__name__ + row] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None)
        del x, xk
    k_route_trace(torch)


def k_route_trace(torch):
    """The GEARL prefill's K block route (``cache._compress_k_block_pk``) on
    the model's bf16 K at the Llama-2-7B path's shape, a [B, H, S, D] view
    of [B, S, H, D] memory: in the profiler's trace no kernel runs before
    the channel kernel (no copy of K, float32 or other)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gear_tpu_torch import cache as TC

    spec = TC.CacheSpec(batch=4, num_kv_heads=32, head_dim=128, max_len=1024,
                        bits=4, group=64)
    k = torch.randn((4, 1024, 32, 128), device="cuda").bfloat16()
    k = k.transpose(1, 2)
    TC._compress_k_block_pk(spec, k)
    pad = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(Timer.PAD):  # the trace can lose its first records
            pad.zero_()
        TC._compress_k_block_pk(spec, k)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "FillFunctor" not in e.name),
                    key=lambda e: e.time_range.start)
    names = [re.sub(r"^void |\(anonymous namespace\)::|at::native::", "",
                    e.name)[:48] for e in events]
    check(bool(names) and "channel_kernel" in names[0],
          f"K route: the channel kernel comes first, got {names}")
    log(f"K route (GEARL prefill, bf16 K [4x32x1024x128] strided): kernels "
        f"in order {names}")


DECODE_KERNELS = ("decode_split_kernel", "attn_merge_kernel")
# (role, instantiation) of the attention kernels the main paths launch:
# decode_split_kernel<bits, GQ, int8 bases, paged>, flash_split_kernel<GQ>
MAIN_PATH_KERNELS = (
    ("B1 Llama-2-7B", "decode_split_kernel<4,1,0,0>"),
    ("B1 Mistral-7B", "decode_split_kernel<4,4,0,0>"),
    ("B4 Llama-2-7B", "flash_split_kernel<1>"),
    ("B4 Mistral-7B", "flash_split_kernel<4>"),
    ("B5 serving", "decode_split_kernel<4,1,0,1>"),
    ("B3 Llama-2-7B", "token_kernel<bf16,4,1>"),
    ("B3 Mistral-7B and serving", "token_kernel<float,4,1>"),
    ("B2 Llama-2-7B", "channel_kernel<bf16,4>"),
    ("B2 Mistral-7B and serving", "channel_kernel<float,4>"),
)
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


def phase_simulated(torch, cfg):
    """Simulated mode (the accuracy path) through ``GearLM`` at the full
    width and depth of Llama-2-7B, seeded random bf16 weights, GEAR int4
    (left 0.02, group 64, rank 2, prefill rank 4, loop 3), stream_grouping
    off, batch 4, prompts of ~1,000 tokens, 130 new tokens: the prompt's K/V
    compressed inside the prefill, the whole cache again after decode steps
    63 and 127, decode over the raw cache through the flash kernel. Returns
    the launch counts of the main-path run."""
    import numpy as np

    from gear_tpu_torch import kernels
    from gear_tpu_torch.api import GearLM
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.core import simulated
    from gear_tpu_torch.engine import EngineConfig
    from gear_tpu_torch.models import llama

    lens, batch, n_new, gap = [1000, 1024, 977, 1011], 4, 130, 64
    # 1024 + 129 appended tokens, and 5 more for the profiled steps below
    max_len = 1216
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"simulated Llama-2-7B: layers {cfg.num_layers} (depth not cut), "
        f"GEAR int4 left 0.02 group 64 rank 2 prefill rank 4 loop 3, "
        f"streaming_gap {gap}, stream_grouping off; batch {batch}, prompts "
        f"{lens}, {n_new} new tokens, max_len {max_len}; random init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]

    def lm_for(mode, method):
        comp = CompressionConfig(num_layers=cfg.num_layers,
                                 compress_method=method, quantize_bit=4,
                                 group_size=64, rank=2, prefill_rank=4,
                                 loop=3, left=0.02, streaming_gap=gap,
                                 stream_grouping=False)
        return GearLM(cfg=cfg, params=params, comp=comp,
                      engine_cfg=EngineConfig(max_len=max_len, mode=mode),
                      batch_size=batch)

    # one layer's prompt compression at full width, on the card and on the
    # CPU with the same inits: the quantization is elementwise and exact on
    # both, the low-rank products sum in other orders
    gen = torch.Generator(device="cuda").manual_seed(7)
    k = torch.randn((batch, cfg.num_kv_heads, 1024, cfg.head_dim),
                    generator=gen, device="cuda").bfloat16().float()
    v = torch.randn(k.shape, generator=gen, device="cuda").bfloat16().float()
    inits = {w: torch.rand((batch, cfg.num_kv_heads, cfg.head_dim, 4),
                           generator=torch.Generator().manual_seed(i))
             for i, w in enumerate("kv")}
    lcomp = lm_for("simulated", "GEAR").comp.layer(0)

    def p0(which, shape):
        return inits[which]

    got = simulated.compress_kv(k, v, lcomp, prefill=True, p0=p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = simulated.compress_kv(k.cpu(), v.cpu(), lcomp, prefill=True, p0=p0)
    cpu_s = time.perf_counter() - t0
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-4)
              for g, w in zip(got, want)),
          "simulated compress_kv: card and CPU agree")
    log(f"simulated compress_kv [{batch}x{cfg.num_kv_heads}x1024x"
        f"{cfg.head_dim}] GEAR: card vs CPU max |diff| = {err:.3e} (limit "
        f"rtol 1e-4 / atol 1e-4: the power iteration's float32 products sum "
        f"in other orders); CPU {cpu_s:.1f} s")
    del k, v, got, want

    # NONE compresses nothing: simulated mode's tokens are raw mode's
    horizon = 32
    none_sim = lm_for("simulated", "NONE").generate(prompts, horizon)
    none_raw = lm_for("raw", "NONE").generate(prompts, horizon)
    check(none_sim == none_raw, "simulated NONE gives raw mode's tokens")
    log(f"simulated NONE vs raw: greedy tokens identical over {horizon} "
        "tokens")

    lm = lm_for("simulated", "GEAR")
    eng = lm.engine
    lm.generate(prompts, 2)  # warm-up
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.generate(prompts, n_new)  # the main path
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    n_l, steps = cfg.num_layers, n_new - 1
    check(len(out) == batch and all(len(o) == n_new for o in out)
          and all(0 <= x < cfg.vocab_size for o in out for x in o),
          "simulated output shape and range")
    check(counts["flash_decode"] == n_l * steps
          and counts["decode_attention"] == 0
          and counts["quant_pack_channels"] == 0,
          "simulated: flash kernel launched once per layer per decode step")
    log(f"simulated main path: generate_ms={total_ms:.1f} ({n_new} tokens, "
        f"one host-clock sample, two recompressions) launches={counts}")

    # where the time goes: the prefill, each step, each recompression
    from torch.profiler import ProfilerActivity, profile

    s = eng.bucket_len(max(lens))
    tokens, mask = eng.left_pad(prompts, 0, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = eng.prefill(tokens, mask)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(logits).all()), "simulated prefill logits "
          "finite")
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad = (s - prompt_len).to(torch.int32)
    cur = logits[:, -1].argmax(-1)
    del logits
    times, rec_ms = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, lg, caches = eng.decode_step(caches, cur, prompt_len + i, pad,
                                          step=i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if (i + 1) % gap == 0:
            t0 = time.perf_counter()
            eng.recompress(caches, s + i + 1, step=i)
            torch.cuda.synchronize()
            rec_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(lg).all()), "simulated decode logits finite")
    check(len(rec_ms) == 2, "simulated: two recompressions")
    median = sorted(times)[len(times) // 2]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps, steps + 5):
            cur, _, caches = eng.decode_step(caches, cur, prompt_len + i, pad,
                                             step=i)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device_ms = sum(e.device_time_total for e in rows) / 5 / 1e3
    n_kernels = sum(e.count for e in rows) / 5
    log(f"simulated GEAR steps, host clock, synchronised each: "
        f"prefill_ms={prefill_ms:.1f} median_step_ms={median:.2f} "
        f"min_step_ms={min(times):.2f} recompression_ms="
        f"{', '.join(f'{r:.1f}' for r in rec_ms)} "
        f"device_ms_per_step={device_ms:.2f} "
        f"device_launches_per_step={n_kernels:.0f} "
        f"tokens_per_s={batch / median * 1e3:.1f} (batch / median step)")
    del lm, eng, caches

    raw = lm_for("raw", "GEAR").engine
    tokens, mask = raw.left_pad(prompts, 0, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw.prefill(tokens, mask)
    torch.cuda.synchronize()
    raw_prefill_ms = (time.perf_counter() - t0) * 1e3
    median, line = step_breakdown(torch, raw, prompts, lens)
    log(f"simulated beside raw (same config): prefill_ms={raw_prefill_ms:.1f}"
        f" {line} tokens_per_s={batch / median * 1e3:.1f}")
    del raw, params
    torch.cuda.empty_cache()
    return counts


def build_paged(torch, gen, kw, hkv, page_blocks, prompt_lens, *, max_len,
                n_pages, n_append=70, d=128, g=64):
    """A pool filled by the port's own prefill_paged + append_paged across a
    flush: rows of different lengths on page ids out of order and
    interleaved between rows, then a row that shares row 0's first page, and
    a parked row last."""
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch import paged

    spec = TC.CacheSpec(batch=1, num_kv_heads=hkv, head_dim=d,
                        max_len=max_len,
                        **{"bits": 4, "group": g, "rank": 2, "prefill_rank": 4,
                           "lowrank_loop": 3, **kw})
    pspec = paged.PagedSpec(spec=spec, n_pages=n_pages,
                            page_blocks=page_blocks)
    pt = pspec.page_tokens
    n_rows = len(prompt_lens) + 2
    pool = paged.init_pool(pspec, "cuda")
    seqs = paged.init_seqs(pspec, n_rows, "cuda")
    free = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        n_pages)).tolist()
    need = [-(-(s + n_append) // pt) for s in prompt_lens]
    ids = [[] for _ in prompt_lens]
    while any(len(i) < n for i, n in zip(ids, need)):  # dealt out in turns
        for i, n in zip(ids, need):
            if len(i) < n:
                i.append(free.pop())
    for row, s in enumerate(prompt_lens):
        k = torch.randn((1, hkv, s, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((1, hkv, s, d), generator=gen,
                        device="cuda").bfloat16()
        paged.prefill_paged(pspec, pool, seqs, row, ids[row], k, v,
                            generator=gen)
        for idx, pid in enumerate(ids[row]):  # the tail pages too
            seqs.set_page(row, idx, pid)
    shared, parked = n_rows - 2, n_rows - 1
    check(prompt_lens[0] >= pt, "row 0 fills the page it shares")
    seqs.set_table_row(shared, [ids[0][0], free.pop()])
    seqs.set_lengths(shared, pt, 0, pt)
    seqs.set_lengths(parked, 0, 1, 0)
    live = [True] * (n_rows - 1) + [False]
    for _ in range(n_append):
        kn = torch.randn((n_rows, hkv, 1, d), generator=gen, device="cuda")
        vn = torch.randn((n_rows, hkv, 1, d), generator=gen, device="cuda")
        paged.append_paged(pspec, pool, seqs, kn.bfloat16(), vn.bfloat16(),
                           generator=gen, live=live)
    return pspec, pool, seqs


def paged_bound(pspec, seqs, gq, pad, window):
    """(bytes, operations) the paged kernel must move and do for these
    sequences: per row only the tokens the masks let through, whole quant
    blocks of them for the per-block parts, a page shared by two rows once,
    the prefill's P basis once per row, the residual tier, the table row and
    the lengths."""
    spec = pspec.spec
    g, d, r, hkv = spec.group, spec.head_dim, spec.r_store, spec.num_kv_heads
    ko, bel = spec.ko_store, (1 if spec.base_bits == 8 else 2)
    pb = pspec.page_blocks
    seen = set()
    nbytes = ops = 0
    for row in range(seqs.batch):
        comp, resid, prefill = (int(x) for x in seqs.host_lens[row])
        first = 0 if pad is None else pad[row]
        if window is not None:
            first = max(first, comp + resid - window)
        first = min(max(first, 0), comp)
        per_head = (2 * resid * d * 2 + 2 * gq * d * 4)   # residual, q, out
        had_prefill_p = False
        for blk in range(first // g, comp // g):
            live = (blk + 1) * g - max(first, blk * g)
            ops += hkv * gq * (live * (4 * d + 4 * r) + 4 * ko)
            where = (int(seqs.host_table[row, blk // pb]), blk % pb)
            if where in seen:
                continue
            seen.add(where)
            per_head += (2 * spec.v_words * live * 4           # K, V codes
                         + 2 * d * 2                           # K scale, mn
                         + 2 * spec.v_groups_per_token * live * 2
                         + 2 * r * live * bel)                 # kqt, vqt
            if blk * g >= prefill or not had_prefill_p:
                had_prefill_p = had_prefill_p or blk * g < prefill
                per_head += 2 * r * d * bel                    # kpt, vpt
                if spec.base_bits == 8:
                    per_head += 4 * r * 4
            if ko:
                per_head += 2 * (ko * 4 + 128 * 4)
        ops += hkv * gq * resid * 4 * d
        nbytes += hkv * per_head + pspec.max_pages_per_seq * 4 + 12
    return nbytes, ops


# (name, CacheSpec kwargs, kv heads, q heads, page_blocks, pad_start, window)
PAGED_CASES = [
    ("gearl int4, pages of 64", dict(), 32, 32, 1, None, None),
    ("gearl int4, pages of 256", dict(), 32, 32, 4, None, None),
    ("gear int4, pages of 64", dict(outliers_per_block=162), 32, 32, 1, None,
     None),
    ("gear int4, pages of 256", dict(outliers_per_block=162), 32, 32, 4, None,
     None),
    ("gearl int2", dict(bits=2), 32, 32, 4, None, None),
    ("gearl int8", dict(bits=8), 32, 32, 1, None, None),
    ("int8 bases", dict(base_bits=8), 32, 32, 4, None, None),
    ("gear + int8 bases", dict(outliers_per_block=162, base_bits=8), 32, 32,
     1, None, None),
    ("gearl gqa", dict(), 8, 32, 4, None, None),
    ("gear gqa, pages of 64", dict(outliers_per_block=162), 8, 32, 1, None,
     None),
    ("gearl pad", dict(), 32, 32, 4, [0, 100, 257, 0, 0, 0], None),
    # 1970, 770, 370 and 326 tokens: cuts into the first row's prefix only
    ("gear window 1000", dict(outliers_per_block=162), 32, 32, 4,
     [0, 100, 0, 0, 0, 0], 1000),
]


def paged_case(torch, timer, gen, name, kw, hkv, hq, pb, pad, window, *,
               prompt_lens=(1900, 700, 300, 256), max_len=2048, n_pages=96):
    from gear_tpu_torch import paged
    from gear_tpu_torch.kernels import decode as TK

    pspec, pool, seqs = build_paged(torch, gen, kw, hkv, pb, prompt_lens,
                                    max_len=max_len, n_pages=n_pages)
    spec = pspec.spec
    b = seqs.batch
    check(len(set(seqs.host_lens[:, 0].tolist())) >= 4
          and (seqs.host_lens[:-1, 0] > seqs.host_lens[:-1, 2]).all(),
          "paged rows differ in length and have flushed")
    q = torch.randn((b, hq, 1, spec.head_dim), generator=gen, device="cuda")
    pad_t = None if pad is None else torch.tensor(
        pad, dtype=torch.int32, device="cuda")
    kwargs = dict(pad_start=pad_t, window=window)
    got = TK.attend_paged(pspec, pool, seqs, q, **kwargs)
    want = paged.attend_gathered(pspec, pool, seqs, q, **kwargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "paged output finite")
    check(bool((got[-1] == 0).all()), "the parked row attends to zeros")
    ok = torch.allclose(got, want, **TOL_DECODE)
    ms = timer(lambda: TK.attend_paged(pspec, pool, seqs, q, **kwargs),
               names=DECODE_KERNELS)
    plain_ms = timer(lambda: paged.attend_gathered(pspec, pool, seqs, q,
                                                   **kwargs), iters=3)
    nbytes, ops = paged_bound(pspec, seqs, hq // hkv, pad, window)
    bms, by = bound_ms(nbytes, ops)
    log(f"paged [{name}] bits={spec.bits} hkv={hkv} hq={hq} "
        f"page_tokens={pspec.page_tokens} pad={pad} window={window} "
        f"rows (comp, resid, prefill)={seqs.host_lens.tolist()} "
        f"ko_store={spec.ko_store} base_bits={spec.base_bits} "
        f"max_abs_err={err:.3e} tol(rtol={TOL_DECODE['rtol']}, "
        f"atol={TOL_DECODE['atol']}) {'ok' if ok else 'FAIL'} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
        f"({by}, {nbytes} bytes)")
    check(ok, f"paged decode kernel within tolerance [{name}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def phase_paged(torch, timer, record):
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for name, kw, hkv, hq, pb, pad, window in PAGED_CASES:
        res = paged_case(torch, timer, gen, name, kw, hkv, hq, pb, pad, window)
        worst = max(worst, res["max_abs_err"])
    # the serving path's shapes: 8 slots (6 live rows of different ages, one
    # sharing a page, one parked), 32 kv heads, GEAR int4, pages of 256
    # tokens, max_len 4096
    res = paged_case(torch, timer, gen, "gear int4, serving path shapes",
                     dict(outliers_per_block=162), 32, 32, 4, None, None,
                     prompt_lens=(3008, 2944, 2880, 1100, 640, 320),
                     max_len=4096, n_pages=96)
    # the row of the kernels' record; the serving run replaces its times
    # with those it reads on its own live pool
    res["max_abs_err"] = max(worst, res["max_abs_err"])
    record["decode_attention_paged"] = res


SERVE_N_SLOTS, SERVE_N_PAGES, SERVE_PAGE_BLOCKS, SERVE_MAX_LEN = 8, 96, 4, 4096


def phase_serving(torch, cfg, timer, record):
    """Continuous-batching serving through ``PagedServingEngine`` at the full
    width and depth of one model: the main path of the paged slice. Mid-run
    the paged kernel is held against its plain version and timed on the live
    pool: those are its times in the kernels' record. Returns the launch
    counts of the run."""
    import warnings

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from gear_tpu_torch import cache as TC
    from gear_tpu_torch import kernels, paged
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.kernels import decode as TK
    from gear_tpu_torch.models import llama
    from gear_tpu_torch.serving import PagedServingEngine

    params = llama.init_params(cfg, seed=0)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=64, rank=2, prefill_rank=4, loop=3,
                             left=0.02)
    eng = PagedServingEngine(cfg, params, comp, n_slots=SERVE_N_SLOTS,
                             max_len=SERVE_MAX_LEN, n_pages=SERVE_N_PAGES,
                             page_blocks=SERVE_PAGE_BLOCKS)
    spec, pspec, n_l = eng.spec, eng.pspec, cfg.num_layers
    resid_bytes = 2 * eng.seqs.k_resid.numel() * eng.seqs.k_resid.element_size()
    pool_bytes = eng.pools.nbytes() + resid_bytes
    one = TC.init_layer_cache(spec, device="meta")  # a dense slot's layer
    dense_bytes = SERVE_N_SLOTS * n_l * sum(
        getattr(one, f).numel() * getattr(one, f).element_size()
        for f in TC.TENSOR_FIELDS)
    rng = np.random.default_rng(0)
    # the first 8 prompts take 12 pages each: 7 fit beside the spare page
    # that admission asks for, the 8th waits for pages with a slot free
    lens = np.concatenate([rng.integers(2830, 3001, 8),
                           rng.integers(300, 1501, 4)]).tolist()
    news = rng.integers(70, 201, 12).tolist()
    log(f"e2e serving: Llama-2-7B hidden {cfg.hidden_size}, layers {n_l} "
        f"(depth not cut), kv heads {cfg.num_kv_heads}, {cfg.dtype}; GEAR "
        f"int4 group 64 rank 2 prefill rank 4 loop 3 left 0.02 "
        f"({spec.outliers_per_block} outliers per block, {spec.ko_store} "
        f"stored); {SERVE_N_SLOTS} slots, max_len {SERVE_MAX_LEN}, "
        f"{SERVE_N_PAGES} pages of {pspec.page_tokens} tokens "
        f"({SERVE_N_PAGES * pspec.page_tokens} tokens pooled, against "
        f"{SERVE_N_SLOTS * SERVE_MAX_LEN} for dense slots); pool_bytes="
        f"{pool_bytes} ({pool_bytes / (SERVE_N_PAGES * pspec.page_tokens):.0f}"
        f" a token over {n_l} layers, residual tiers included) "
        f"dense_slots_bytes={dense_bytes}; prompts {lens}, new tokens {news}")

    # warm-up outside the counted run: CUDA context, cuBLAS handles
    warm = PagedServingEngine(cfg, params, comp, n_slots=2, max_len=256,
                              n_pages=4, page_blocks=SERVE_PAGE_BLOCKS)
    warm.submit(list(range(1, 100)), 3)
    warm.run()
    del warm

    stats = dict(prefill=[], splice=[], steps=[], flush_steps=[], syncs=[],
                 waited=0, grown=0, midrun=None, device=None, sync_sites=set())

    def timed(fn, into):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    eng._prefill = timed(eng._prefill, stats["prefill"])
    eng._splice_slot = timed(eng._splice_slot, stats["splice"])
    admit_all, prealloc, decode_once = (eng._admit_all, eng._prealloc_pages,
                                        eng._decode_once)

    def admit_counted():
        admit_all()
        if eng.sched.next_admission() != -1:  # a slot is free, pages are not
            stats["waited"] += 1

    def prealloc_counted():
        before = eng.alloc.free_count()
        prealloc()
        stats["grown"] += before - eng.alloc.free_count()

    def midrun_check():
        """One layer's paged attention on the live pool, kernel vs plain,
        both timed there: the shapes are the main path's own. The launches
        made here are taken off the count again."""
        layer = n_l // 2
        lpool, lseqs = eng.pools.layer(layer), eng.seqs.layer(layer)
        gen = torch.Generator(device="cuda").manual_seed(6)
        q = torch.randn((SERVE_N_SLOTS, cfg.num_heads, 1, cfg.head_dim),
                        generator=gen, device="cuda")
        before = TK.decode_attention_paged.launches
        got = TK.attend_paged(pspec, lpool, lseqs, q, pad_start=eng.pad_start)
        want = paged.attend_gathered(pspec, lpool, lseqs, q,
                                     pad_start=eng.pad_start)
        ages = sorted(set(eng.seqs.host_lens[eng.live, 0].tolist()))
        err = float((got - want).abs().max())
        check(len(ages) > 1, "mid-run check: slots of different ages")
        check(torch.allclose(got, want, **TOL_DECODE),
              "mid-run: paged kernel equals the plain version on the live "
              "pool")
        ms = timer(lambda: TK.attend_paged(pspec, lpool, lseqs, q,
                                           pad_start=eng.pad_start),
                   names=DECODE_KERNELS)
        plain_ms = timer(lambda: paged.attend_gathered(
            pspec, lpool, lseqs, q, pad_start=eng.pad_start), iters=3)
        TK.decode_attention_paged.launches = before
        nbytes, ops = paged_bound(pspec, lseqs, cfg.num_heads
                                  // cfg.num_kv_heads, eng.pad_start.tolist(),
                                  None)
        bms, by = bound_ms(nbytes, ops)
        stats["midrun"] = (err, ages, int(eng.live.sum()),
                           eng.seqs.host_lens.tolist(), ms, plain_ms, bms,
                           by, nbytes)
        record["decode_attention_paged"].update(
            max_abs_err=max(err, record["decode_attention_paged"][
                "max_abs_err"]),
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    prof_steps = range(20, 25)  # steady steps under the profiler

    def decode_counted():
        i = len(stats["steps"])
        # a live slot whose residual tier fills in this step flushes in it
        flushing = bool((eng.seqs.host_lens[eng.live, 1] + 1
                         == spec.group).any())
        if i == prof_steps[0]:
            stats["prof"] = profile(activities=[ProfilerActivity.CUDA])
            stats["prof"].__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                decode_once()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        stats["steps"].append((time.perf_counter() - t0) * 1e3)
        where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]
        stats["syncs"].append(len(where))
        stats["sync_sites"].update(where)
        if flushing:
            stats["flush_steps"].append(i)
        if i == prof_steps[-1]:
            prof = stats.pop("prof")
            prof.__exit__(None, None, None)
            rows = prof.key_averages()
            stats["device"] = (
                sum(e.device_time_total for e in rows) / len(prof_steps) / 1e3,
                sum(e.count for e in rows) / len(prof_steps))
            top = sorted(rows, key=lambda e: -e.device_time_total)[:6]
            stats["top"] = "; ".join(
                f"{e.key[:48]} {e.device_time_total / len(prof_steps) / 1e3:.2f}"
                f" ms x{e.count // len(prof_steps)}" for e in top)
        if stats["midrun"] is None and i >= 100 and len(set(
                eng.seqs.host_lens[eng.live, 0].tolist())) > 1:
            midrun_check()

    eng._admit_all, eng._prealloc_pages, eng._decode_once = (
        admit_counted, prealloc_counted, decode_counted)
    rids = [eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), m)
            for n, m in zip(lens, news)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run()  # the main path
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = kernels.launch_counts()

    n_steps = len(stats["steps"])
    check(set(outs) == set(rids) and all(
        len(outs[r]) == m for r, m in zip(rids, news)),
        "serving: every request done with exactly its max_new tokens")
    check(all(0 <= x < cfg.vocab_size for o in outs.values() for x in o),
          "serving: tokens in range")
    check(eng.alloc.free_count() == SERVE_N_PAGES,
          "serving: every page back in the pool")
    check(counts["decode_attention_paged"] == n_l * n_steps,
          "serving: paged kernel launched layers x decode steps")
    n_admit = len(stats["prefill"])
    check(counts["quant_pack_tokens"] == n_l * n_admit
          and counts["quant_pack_channels"] == n_l * n_admit
          and n_admit >= len(rids),
          "serving: pack kernels ran at every admission")
    check(counts["decode_attention"] == 0 and counts["flash_decode"] == 0,
          "serving: no dense attention kernel on the paged path")
    check(stats["waited"] > 0, "serving: an admission waited for pages")
    check(stats["grown"] > 0, "serving: a slot crossed into a new page")
    check(len(stats["flush_steps"]) > 0 and stats["midrun"] is not None,
          "serving: slots flushed and the mid-run check ran")
    steady = sorted(t for i, t in enumerate(stats["steps"])
                    if i not in stats["flush_steps"] and i not in prof_steps)
    flush = sorted(stats["steps"][i] for i in stats["flush_steps"])
    steady_syncs = [s for i, s in enumerate(stats["syncs"])
                    if i not in stats["flush_steps"]]
    flush_syncs = [stats["syncs"][i] for i in stats["flush_steps"]]
    dev_ms, dev_launches = stats["device"]
    median = steady[len(steady) // 2]
    by_len = sorted(zip(lens[:n_admit] if n_admit == len(lens) else
                        [0] * n_admit, stats["prefill"], stats["splice"]))
    (err, ages, n_live, rows, k_ms, k_plain_ms, k_bound_ms, k_by,
     k_bytes) = stats["midrun"]
    log(f"e2e serving: {len(rids)} requests, {sum(news)} tokens in "
        f"{total_s:.1f} s ({sum(news) / total_s:.1f} tokens/s, admissions "
        f"and flushes included); {n_steps} decode steps, {n_admit} "
        f"admissions ({n_admit - len(rids)} after a preemption), "
        f"{stats['waited']} rounds in which an admission waited for pages, "
        f"{stats['grown']} pages allocated at decode time; "
        f"median_step_ms={median:.2f} min_step_ms={steady[0]:.2f} (host "
        f"clock, synchronised each, {len(steady)} steady steps) "
        f"flush_step_ms median={flush[len(flush) // 2]:.1f} "
        f"max={flush[-1]:.1f} ({len(flush)} steps in which a slot flushed) "
        f"device_ms_per_step={dev_ms:.2f} "
        f"device_launches_per_step={dev_launches:.0f} (steps "
        f"{prof_steps[0]}-{prof_steps[-1]} under the profiler) "
        f"device_busy_share={dev_ms / median:.3f} "
        f"host_syncs_per_steady_step={sorted(set(steady_syncs))} "
        f"host_syncs_per_flush_step={sorted(set(flush_syncs))}")
    log(f"e2e serving device time per step, largest kernels: {stats['top']}")
    log("e2e serving admissions (prompt tokens: prefill_ms / splice_ms): "
        + ", ".join(f"{n}: {p:.1f} / {sp:.1f}" for n, p, sp in by_len))
    log(f"e2e serving mid-run check: {n_live} live slots with comp_len "
        f"{ages}, layer {n_l // 2}, |kernel - plain| max {err:.3e} within "
        f"tol(rtol={TOL_DECODE['rtol']}, atol={TOL_DECODE['atol']}); rows "
        f"(comp, resid, prefill)={rows} kernel_ms={k_ms:.4f} "
        f"plain_ms={k_plain_ms:.4f} bound_ms={k_bound_ms:.4f} ({k_by}, "
        f"{k_bytes} bytes); launches={counts}")
    check(sorted(set(stats["syncs"])) == [1],
          "serving: one host sync per decode step (the token fetch), flush "
          f"steps included; counted {sorted(set(stats['syncs']))} at "
          f"{sorted(stats['sync_sites'])}")
    del eng, params
    torch.cuda.empty_cache()
    return counts


def phase_small_serving(torch):
    """A small bf16 model served by ``PagedServingEngine`` on the card
    (kernels) and on the CPU (plain path) in lockstep from the same inits,
    staggered finishes, a pool small enough to force a preemption; then the
    dense ``ServingEngine`` on the card against the paged one."""
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.models import llama
    from gear_tpu_torch.serving import PagedServingEngine, ServingEngine

    cfg = llama.ModelConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                                 head_dim=64, intermediate_size=512)
    params = llama.init_params(cfg, seed=3)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=3,
                             left=0.02)

    def init(site, shape):  # the same power-iteration inits on both sides
        gen = torch.Generator().manual_seed(hash(site) % (1 << 31))
        return torch.rand(shape, generator=gen)

    prompt = list(range(1, 33))
    requests = [(prompt, 40), ([x + 50 for x in prompt], 40), ([5, 9, 2], 6),
                ([7, 11, 3, 8], 25)]
    kw = dict(n_slots=2, max_len=128, n_pages=6, page_blocks=1, init=init)
    card = PagedServingEngine(cfg, params, comp, **kw)
    cpu = PagedServingEngine(cfg, cpu_params, comp, device="cpu", **kw)
    preempted = []
    card_preempt = card._preempt
    card._preempt = lambda slot: (preempted.append(slot), card_preempt(slot))
    for eng in (card, cpu):
        for p, n in requests:
            eng.submit(p, n)
    worst, n_steps = 0.0, 0
    while True:
        for eng in (card, cpu):
            eng._admit_all()
        # the CPU engine follows the card's tokens, so both stay in lockstep
        cpu.cur_tok = card.cur_tok.cpu()
        for rid, req in card.requests.items():
            cpu.requests[rid].out[:] = req.out
        check(card.live.tolist() == cpu.live.tolist(), "small serving: the "
              "same slots live on the card and on the CPU")
        if not card.live.any():
            break
        for eng in (card, cpu):
            eng._prealloc_pages()
        check((card.seqs.host_lens == cpu.seqs.host_lens).all()
              and (card.seqs.host_table == cpu.seqs.host_table).all(),
              "small serving: same lengths and tables on both")
        live = card.live.copy()
        logits = []
        for eng in (card, cpu):
            lg, _, _ = llama.forward_decode_paged(
                eng.params, cfg, eng.cur_tok, eng.positions, eng.pools,
                eng.seqs, pspec=eng.pspec, pad_start=eng.pad_start,
                init=init, live=eng.live, live_dev=eng.live_dev)
            logits.append(lg.cpu()[live])
        scale = float(logits[1].abs().max())
        worst = max(worst, float((logits[0] - logits[1]).abs().max()) / scale)
        nxt = torch.zeros_like(card.cur_tok)
        nxt[torch.from_numpy(live).cuda()] = logits[0].argmax(-1).cuda()
        card._emit(nxt)
        cpu._emit(nxt.cpu())
        n_steps += 1
    counts = [[len(r.out) for r in eng.requests.values()]
              for eng in (card, cpu)]
    log(f"small serving, GEAR int4, 2 slots over 6 pages of 16 tokens: card "
        f"(kernels) vs CPU (plain path) over {n_steps} decode steps in "
        f"lockstep, {len(preempted)} preemption(s), tokens per request "
        f"{counts[0]}, max |logit diff| / max |logit| = {worst:.3e} (limit "
        f"5e-2: bf16 projections round differently on the two)")
    check(counts[0] == counts[1] == [n for _, n in requests]
          and all(r.done for r in card.requests.values()),
          "small serving: every request done, token counts equal")
    check(len(preempted) >= 1, "small serving: the pool forced a preemption")
    check(card.alloc.free_count() == 6 and cpu.alloc.free_count() == 6,
          "small serving: every page back in the pool")
    check(worst < 5e-2, "small serving: card and CPU logits agree")

    # the dense twin on the card, and the paged engine with pages to spare
    outs = {}
    for name, cls, extra in (
            ("paged", PagedServingEngine, dict(n_pages=16, page_blocks=1)),
            ("dense", ServingEngine, {})):
        eng = cls(cfg, params, comp, n_slots=2, max_len=128, init=init,
                  **extra)
        rids = [eng.submit(p, n) for p, n in requests]
        done = eng.run()
        outs[name] = [done[r] for r in rids]
    same = [a == b for pa, de in zip(outs["paged"], outs["dense"])
            for a, b in zip(pa, de)]
    agree = sum(same) / len(same)
    log(f"small serving: dense ServingEngine vs PagedServingEngine on the "
        f"card, same requests, no preemption: token counts "
        f"{[len(o) for o in outs['dense']]}, greedy agreement "
        f"{agree:.3f} (bf16 logits near ties may part the two: the kernels "
        f"merge their splits in different orders)")
    check([len(o) for o in outs["dense"]] == [len(o) for o in outs["paged"]]
          == [n for _, n in requests], "small serving: dense token counts")
    check(agree >= 0.9, "small serving: dense and paged tokens agree")


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
    usage = _build.ptxas_usage(build_log)
    spilled = sorted(k for k, (_, st, ld) in usage.items() if st or ld)
    log(f"ptxas: {len(usage)} kernels, spills in {len(spilled)}: {spilled}")
    log("ptxas, the main paths' kernels (registers, spill stores "
        "/ loads bytes): " + "; ".join(
            f"{role} {k}: {usage[k][0]} / {usage[k][1]} / {usage[k][2]}"
            for role, k in MAIN_PATH_KERNELS if k in usage))

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
        # the simulated mode's path (the accuracy path): raw cache, prompt
        # and cache recompressed by fake quantization, the flash kernel
        "e2e simulated": lambda: counts.update(
            simulated={"simulated": phase_simulated(torch, llama_cfg)}),
        "small gearl": lambda: phase_small(torch, "GEARL"),
        "small gear": lambda: phase_small(torch, "GEAR"),
        "paged": lambda: phase_paged(torch, timer, record),
        # the paged slice's path: continuous batching over the page pool
        "e2e serving": lambda: counts.update(
            serving={"paged": phase_serving(torch, llama_cfg, timer,
                                            record)}),
        "small serving": lambda: phase_small_serving(torch),
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
        ("quant_pack_tokens_bf16", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "llama", "fused"),
        ("quant_pack_channels_bf16", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "llama", "fused"),
        ("quant_pack_channels_gear", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "mistral", "fused"),
        ("quant_pack_tokens_gear", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "mistral", "fused"),
        ("flash_decode", "flash_decode", "gear_tpu_torch/csrc/flash.cu",
         "gear_tpu/kernels/flash.py:32", "mistral", "raw"),
        ("decode_attention_paged", "decode_attention_paged",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:1163",
         "serving", "paged"),
        ("quant_pack_channels_serving", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "serving", "paged"),
        ("quant_pack_tokens_serving", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "serving", "paged"),
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
