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
     no kernel may run before the channel pack (no copy of K); then the
     flush kernel against its plain version at the benchmark's two GEAR
     shapes (Mistral-7B int4 at batch 16, a Mixtral-8x7B rank's 2 kv heads
     at int2), timed;
  3. the decode kernel against the plain ``cache.attend`` on full-width
     caches built by the port's own prefill + append across a flush: GEARL
     (bits 2/4/8, GQA 32/8 heads, left padding, a sliding window that cuts
     into the prefix), GEAR with 162 outliers per block (int4, int2, GQA),
     int8 bases, GEAR + int8 bases + KCVT together, no low-rank term,
     GEARL and GEAR at the shapes the two end-to-end paths below give the
     kernel, and both at the shapes one of two tensor-parallel ranks gives
     it (16 of the Llama path's 32 kv heads; 4 of Mistral's 8, GQ 4);
  4. the flash-decode kernel against the plain ``raw_attend`` over bf16 raw
     caches (32 heads and 8 kv / 32 q heads, 1,930 and 4,400 valid tokens,
     left padding, a window), with ``scaled_dot_product_attention`` timed
     beside it as the library's call for the same function;
  5. end to end through ``GearLM``, seeded random bf16 weights at full
     width and 8 of the 32 layers (``EARLIER_DEPTH``: the earlier slices'
     7B paths, 5, 6 and 9, run at a cut depth so that the whole script
     stays near five minutes; the evaluation slice's 14 keeps all 32),
     group 64,
     rank 2, prefill rank 4, loop 3, 80 new tokens, in ``fused`` and ``raw``
     mode, plus int8 fused vs raw greedy agreement:
     Mistral-7B (32 layers, 8 kv heads, window 4096) with GEAR int4, batch
     2, prompts of ~4,300 tokens, so that the window binds from the first
     decode step; and Llama-2-7B with GEARL int4, batch 4, prompts of ~1,000
     tokens. Each run's launch counts are set to 0 just before it and read
     just after: fused mode must have gone through the decode and pack
     kernels, raw mode through the flash kernel;
  6. simulated mode (the accuracy path) through ``GearLM`` at the full
     width of Llama-2-7B (depth cut), GEAR int4, batch 4, prompts of ~1,000
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
     width of Llama-2-7B (depth cut), GEAR int4, 8 slots over a pool of 96
     pages of 256 tokens, 12 requests from a numpy seed (the first 8 prompts
     near 3,000 tokens, so that the 8th admission waits for pages); launch
     counts set to 0 just before and read just after; mid-run one layer's
     paged attention is held against the plain version on the live pool and
     both are timed there (the paged kernel's row of the kernels' record);
  10. a small model served by ``PagedServingEngine`` on the card (kernels) and
     on the CPU (plain path) in lockstep, with a pool small enough to force
     a preemption: the logits must agree; then the dense ``ServingEngine``
     on the card against the paged one;
  11. B1-B4 at the shapes the evaluation path gives them (the mid-scale
     checkpoint: 8 rows, 6 kv / 12 q heads, head_dim 64, group 32, a
     128-token bucket and 47 steps; B4 also at the CLI's head_dim 32);
  12. the accuracy protocol (``tools/acc_run.py``) on runs/mid_arith, the
     checkpoint gear_tpu trained, loaded with ml_dtypes blocked: NONE,
     GEAR-int4, GEARL-int4, GEAR-int2 and KIVI-int4 in simulated mode and
     GEAR / GEARL int4 in fused mode, n=150, each accuracy beside the TPU
     record (runs/mid_arith/accuracy_sweep.json); NONE >= 0.20, every int4
     configuration within 0.06 of NONE, B1-B3 launched by the fused runs
     and B4 by the simulated ones; NONE raw on the card against the CPU
     over 16 problems (a problem may part only where the two devices'
     tokens are the top two on both and that decode step's logits agree
     within the lockstep limit: a bf16 near-tie); then
     ``python -m gear_tpu_torch.eval.run`` with its turnkey defaults;
  13. ``eval.synth.train`` on the card (the tiny scale, 30 steps: the loss
     falls), the checkpoint round trip bit for bit, greedy generation from
     the trained params;
  14. engine modes h2o (256 heavy-hitter + 768 recent slots) and sink (4
     sinks, window 1020) at the full width and depth of Llama-2-7B, batch
     4, prompts of ~1,000 tokens, 80 new tokens: eviction and the ring's
     wrap from the first decode step, first tokens equal to raw mode's,
     finite logits, step times beside raw mode's;
  15. a small model in modes h2o and sink on the card and on the CPU in
     lockstep through eviction and the wrap: the logits must agree;
  16. Mixtral-8x7B (sparse MoE, 8 experts of 14,336, top 2) at full width
     and 16 of its 32 layers (``MIXTRAL_DEPTH``: 32 layers' 93 GB of bf16
     weights do not fit the card), GEAR int2 with 2% outliers, batch 2,
     prompts of 8,100 / 7,900 tokens, 80 decode steps through
     ``models.mixtral`` in fused and raw mode: launch counts per run, B2 /
     B3 at the prefill's shape bit-equal, B1 and B4 held against their plain
     versions on the live caches, a ``runtime.kvstore`` snapshot after step
     40 from which steps 41-80 must repeat the uninterrupted run bit for
     bit, ``runtime.faults`` over caches and logits, no copy of the expert
     weights in a profiled step;
  17. a small Mixtral in fused mode (GEARL, then GEAR) in lockstep on the
     card and on the CPU, as phase 7;
  18. parallelism: the unsharded references here, then two gloo ranks on
     cuda:0 (this script with ``--parallel-rank``; NCCL refuses two ranks
     on one card), each held in lockstep against the references (every
     position's logits within ``LOCKSTEP_LIMIT`` of the largest, greedy
     tokens parting only where the two are the top two of both runs, and
     what the sharded ``generate`` returned equal to the unsharded tokens
     up to each row's first parting): tensor parallelism (TP 2) over
     Llama-2-7B at full width and 8 layers, the Llama path's batch and
     prompts, fused and raw through ``GearLM.shard`` (B1 / B4 at 16 kv
     heads a rank, B1 held against ``cache.attend`` on each rank's layer 0);
     sequence parallelism (2 shards of 4,096 tokens) over an 8,000-token
     prompt, 80 tokens across a flush on the last shard; Mistral-7B at TP 2
     (B1 at 4 kv heads, GQ 4, the window), 16 tokens, also in lockstep;
     expert parallelism (EP 2) over Mixtral-8x7B at full width and 4
     layers, GEAR int2, batch 2, 20 steps, ``moe_block_ep`` (each rank's
     experts from ``shard_experts``) against ``moe_block``. Each path's device
     ms and launches a step, its collectives' ms alone, the host median and
     the peak memory a rank, all taken with two ranks sharing the card.

Any failed check raises, so the script exits non-zero. The second-to-last
line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``. The compiler log and the kernels' record
also go to gear_tpu_torch/_build/.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "gear_tpu_torch" / "_build"

EARLIER_DEPTH = 8  # layers (of 32) of the earlier slices' 7B paths
TOL_DECODE = dict(rtol=1e-3, atol=1e-4)  # both float32; sum order differs
LOCKSTEP_LIMIT = 5e-2  # max |card - CPU| / max |CPU| logits, bf16 weights


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The card's least ms for ``nbytes`` moved and ``ops`` float32
    operations (``profiling.H100_SXM``, NVIDIA's data sheet)."""
    from gear_tpu_torch.profiling import H100_SXM

    t, by = H100_SXM.bound_s(nbytes, ops)
    return t * 1e3, by


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


def short_name(name: str) -> str:
    """A kernel's name from the profiler without its boilerplate."""
    return re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)


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
            note = dtype + (" outlier-cleaned" if cleaned else "")
            for res in pack_cases(torch, timer, x, xk, bits, g, note):
                if row is not None:
                    record[res.pop("name") + row] = res
        del x, xk
    k_route_trace(torch)


def pack_cases(torch, timer, x, xk, bits, g, note):
    """Both pack kernels against their plain versions, bit-equal, and
    timed: B3 (``quant_pack_tokens``) on ``x`` [N, S, D] with V groups of
    ``g`` channels, B2 (``quant_pack_channels``) on ``xk`` (the same values,
    as the model hands them) with groups of ``g`` tokens. Returns the two
    rows for the kernels' record, each with its wrapper's name."""
    from gear_tpu_torch.kernels import pack as TP

    n, s, d = x.shape
    wd = d * bits // 32
    rows = []
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
                  f"{kern.__name__} bits={bits} [{n}x{s}x{d}] g={g} "
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
        log(f"pack {kern.__name__} bits={bits} [{n}x{s}x{d}] g={g} {note} "
            f"bit-equal kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bms:.4f} ({by})")
        rows.append(dict(name=kern.__name__, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=None))
    return rows


# (row of the kernels' record, spec of a layer's cache, compressed length
# before the flush): the flush at the shapes the two GEAR cells of the
# benchmark give it, Mistral-7B GEAR int4 at batch 16 and a Mixtral-8x7B
# rank's 2 kv heads at int2
FLUSH_CASES = (
    ("flush", dict(batch=16, num_kv_heads=8, head_dim=128, max_len=4608,
                   bits=4, group=64, rank=2, prefill_rank=4, lowrank_loop=3,
                   outliers_per_block=162), 4352),
    ("flush_mixtral", dict(batch=16, num_kv_heads=2, head_dim=128,
                           max_len=8448, bits=2, group=64, rank=2,
                           prefill_rank=4, lowrank_loop=3,
                           outliers_per_block=162), 8192),
)


def flush_bytes(spec) -> int:
    """Bytes a layer's flush must move: the residual tier read, the block's
    codes, sidebands, outlier entries and bases written."""
    b, h, d, g = spec.batch, spec.num_kv_heads, spec.head_dim, spec.group
    el, r = spec.dtype.itemsize, spec.r_store
    per = (g * d * el + g * spec.v_words * 4                  # resid, codes
           + 2 * el * (d + g * spec.v_groups_per_token) / 2   # sidebands
           + spec.ko_store * (2 + el) + 4 * spec.bnd_lanes    # outliers
           + r * (d + g) * (1 if spec.base_bits == 8 else el) + 8 * r)
    return int(2 * b * h * per)


def phase_flush(torch, timer, record):
    """The flush kernel (``kernels.flush.flush``) against its plain version
    at the benchmark's two GEAR shapes, from one cache with every leaf
    filled and the same starts, held by the card test's own comparison
    (``tests/test_torch_flush_kernel.py``: ``compare``): sidebands, outlier
    indices and boundary tables bit-equal, codes bit-equal away from the
    plain version's outlier positions, deltas within one bf16 ulp where the
    codes agree, the low-rank term within 1e-3, nothing outside the block
    written; then timed (a layer's flush, K and V), with the kernel's
    shared memory."""
    import ctypes
    import importlib.util

    from gear_tpu_torch.kernels import _build
    from gear_tpu_torch.kernels import flush as TFL

    where = ROOT / "tests" / "test_torch_flush_kernel.py"
    mod = importlib.util.spec_from_file_location("flush_kernel_checks", where)
    ft = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(ft)
    lib = _build.library()
    lib.gear_flush_smem_bytes.restype = ctypes.c_int64
    lib.gear_flush_smem_bytes.argtypes = [ctypes.c_int] * 5
    p0 = ft.site_p0("cuda")

    for seed, (row, kw, c0) in enumerate(FLUSH_CASES, 7):
        spec = ft.TC.CacheSpec(**kw)
        before = ft.full_cache(spec, c0, "cuda", seed)
        want, got = ft.clone(before), ft.clone(before)
        TFL.flush_plain(spec, want, p0, None)
        TFL.flush(spec, got, p0)
        torch.cuda.synchronize()
        try:
            ft.compare(spec, before, want, got, c0)
        except AssertionError as err:
            check(False, f"{row}: the kernel against the plain version: "
                  f"{err!r}")
        g = spec.group
        moved = sum(int((getattr(got, f"{x}_codes")[..., c0:c0 + g]
                         != getattr(want, f"{x}_codes")[..., c0:c0 + g])
                        .sum()) for x in ("k", "v"))
        n_words = 2 * spec.batch * spec.num_kv_heads * spec.v_words * g
        ms = timer(lambda: TFL.flush(spec, got, p0), names=("flush_kernel",))
        plain_ms = timer(lambda: TFL.flush_plain(spec, want, p0, None),
                         iters=3)
        bms, by = bound_ms(flush_bytes(spec), 0)
        smem = lib.gear_flush_smem_bytes(spec.head_dim, spec.group,
                                         spec.v_group,
                                         spec.outliers_per_block,
                                         spec.ko_store)
        log(f"flush {row} B={spec.batch} H={spec.num_kv_heads} "
            f"D={spec.head_dim} g={g} int{spec.bits} "
            f"ko={spec.outliers_per_block} rank={spec.rank}: words "
            f"differing {moved} of {n_words} (outlier positions), "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bms:.5f} ({by}) smem={smem} B")
        record[row] = dict(max_abs_err=None, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, library_ms=None,
                           smem_bytes=smem)


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
    names = [short_name(e.name)[:48] for e in events]
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
    ("B1 Mixtral-8x7B", "decode_split_kernel<2,4,0,0>"),
    ("B4 Mixtral-8x7B", "flash_split_kernel<4>"),
    ("B3 Mixtral-8x7B", "token_kernel<float,2,1>"),
    ("B2 Mixtral-8x7B", "channel_kernel<float,2>"),
    ("flush Mistral-7B", "flush_kernel<4,1,0>"),
    ("flush Mixtral-8x7B", "flush_kernel<2,1,0>"),
    ("B1 eval", "decode_split_kernel<4,2,0,0>"),
    ("B3 eval", "token_kernel<bf16,4,1>"),
    ("B4 eval", "flash_split_kernel<2>"),
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
                b=4, t=2048, n_prefill=1900, n_append=30, d=128, g=64):
    """Build a full-width cache with the port's own prefill + appends across
    a flush, hold the kernel against the plain ``cache.attend`` on it, and
    time both. Returns the row for the kernels' record."""
    from gear_tpu_torch import cache as TC

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
    return hold_decode(torch, timer, name, spec, cache, q, pad, window)


def hold_decode(torch, timer, name, spec, cache, q, pad, window):
    """Hold the decode kernel against the plain ``cache.attend`` over one
    layer's ``cache`` for the float32 queries ``q`` [B, Hq, 1, D], and time
    both. Returns the row for the kernels' record."""
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.kernels import decode as TK

    b, hq, _, d = q.shape
    hkv, g, t = spec.num_kv_heads, spec.group, spec.max_len
    gq = hq // hkv
    total = cache.comp_len + cache.resid_len
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
    log(f"decode [{name}] bits={spec.bits} hkv={hkv} hq={hq} d={d} g={g} "
        f"pad={pad} window={window} max_len={t} comp={c} resid={rl} "
        f"ko_store={ko} "
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
    # B1 at the shapes a rank of two gives it under tensor parallelism: the
    # Llama-2-7B path's 16 of 32 kv heads, and Mistral-7B's 4 of 8 kv heads
    # with 16 of 32 query heads (GQ 4) and the window
    record["decode_attention_tp"] = decode_case(
        torch, timer, gen, "gearl int4, Llama-2-7B TP-rank shapes", dict(),
        16, 16, [24, 0, 47, 13], None, b=4, t=1152, n_prefill=1024,
        n_append=70)
    record["decode_attention_tp_mistral"] = decode_case(
        torch, timer, gen, "gear int4, Mistral-7B TP-rank shapes",
        dict(outliers_per_block=162), 4, 16, [0, 130], 4096, b=2, t=4480,
        n_prefill=4352, n_append=70)


FLASH_CASES = [  # (kv heads, q heads, batch, max_len, length, pad, window, row)
    (32, 32, 4, 2048, 1930, None, None, None),
    (32, 32, 4, 2048, 1930, [0, 100, 257, 1000], None, None),
    (8, 32, 4, 2048, 1930, None, None, None),
    (32, 32, 4, 4480, 4400, None, None, None),
    (8, 32, 4, 4480, 4400, [0, 100, 257, 1000], 4096, None),
    (8, 32, 2, 4480, 4400, [0, 130], 4096, "flash_decode"),  # Mistral path
]


def flash_case(torch, timer, gen, hkv, hq, b, t, length, pad, window, *,
               d=128):
    """Hold the flash kernel against the plain ``raw_attend`` over a random
    bf16 raw cache, time both and ``scaled_dot_product_attention`` for the
    same function. Returns the row for the kernels' record."""
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.models import llama

    spec = TC.CacheSpec(batch=b, num_kv_heads=hkv, head_dim=d, max_len=t)
    k = torch.randn((b, hkv, t, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, hkv, t, d), generator=gen, device="cuda").bfloat16()
    c = llama.RawLayerCache(k=k, v=v, length=length)
    q = torch.randn((b, hq, 1, d), generator=gen, device="cuda")
    return hold_flash(torch, timer, spec, c, q, pad, window)


def hold_flash(torch, timer, spec, c, q, pad, window):
    """Hold the flash kernel against the plain ``raw_attend`` over one
    layer's raw cache ``c`` for the float32 queries ``q`` [B, Hq, 1, D],
    and time both and ``scaled_dot_product_attention`` for the same
    function. Returns the row for the kernels' record."""
    import torch.nn.functional as F

    from gear_tpu_torch.kernels import flash as TF
    from gear_tpu_torch.models import llama

    b, hq, _, d = q.shape
    hkv, t, length, k, v = spec.num_kv_heads, spec.max_len, c.length, c.k, c.v
    gq = hq // hkv
    pad_t = None if pad is None else torch.tensor(
        pad, dtype=torch.int32, device="cuda")
    kwargs = dict(pad_start=pad_t, window=window)
    got = TF.raw_attend_flash(spec, c, q, **kwargs)
    want = llama.raw_attend(spec, c, q, **kwargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "flash output finite")
    ok = torch.allclose(got, want, **TOL_DECODE)
    ms = timer(lambda: TF.raw_attend_flash(spec, c, q, **kwargs),
               names=FLASH_KERNELS)
    plain_ms = timer(lambda: llama.raw_attend(spec, c, q, **kwargs), iters=5)
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
    log(f"flash hkv={hkv} hq={hq} d={d} batch={b} max_len={t} "
        f"length={length} pad={pad} window={window} max_abs_err={err:.3e} "
        f"tol(rtol={TOL_DECODE['rtol']}, atol={TOL_DECODE['atol']}) "
        f"{'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}, {nbytes} "
        f"bytes) library_ms={lib_ms:.4f} (scaled_dot_product_attention, "
        f"bf16 q, bool mask; |lib - plain| max {lib_err:.2e})")
    check(ok, f"flash kernel within tolerance (hkv={hkv} d={d} pad={pad} "
              f"window={window})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def phase_flash(torch, timer, record):
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for hkv, hq, b, t, length, pad, window, row in FLASH_CASES:
        res = flash_case(torch, timer, gen, hkv, hq, b, t, length, pad,
                         window)
        worst = max(worst, res["max_abs_err"])
        if row:
            record[row] = res
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
    width of Llama-2-7B, seeded random bf16 weights, GEAR int4
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
    log(f"simulated Llama-2-7B: layers {cfg.num_layers} of 32, "
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
    width of one model: the main path of the paged slice. Mid-run
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
        f"of 32, kv heads {cfg.num_kv_heads}, {cfg.dtype}; GEAR "
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


def phase_small(torch, method, family="llama"):
    """The fused model on a small input (Llama, or Mixtral with 4 experts,
    top 2): kernels on the card against the plain path on the CPU, in
    lockstep from one prefill, across a flush."""
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.models import llama, mixtral

    model = llama if family == "llama" else mixtral
    config = (llama.ModelConfig if family == "llama"
              else mixtral.MixtralConfig)
    cfg = config.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                      head_dim=64, intermediate_size=512)
    params = model.init_params(cfg, seed=3)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method=method, quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=3,
                             left=0.02)
    spec = cfg.cache_spec(2, 128, comp.layer(0))
    check(bool(spec.outliers_per_block) == (method == "GEAR"),
          "small model: outliers with GEAR only")

    def init(site, shape):  # the same power-iteration inits on both sides
        gen = torch.Generator().manual_seed(hash(site) % (1 << 31))
        return torch.rand(shape, generator=gen)

    prompts = [[5, 9, 2, 7, 11, 3, 8], [4, 1, 6]]
    tokens = torch.tensor([[0] * (16 - len(p)) + p for p in prompts],
                          device="cuda")
    mask = (tokens != 0).to(torch.int32)
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    logits, caches = model.forward_prefill(params, cfg, tokens, positions,
                                           mask, spec, init=init)
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
        kw = dict(spec=spec, step=step, init=init)
        lg, caches = model.forward_decode(
            params, cfg, cur, prompt_len + step, caches, pad_start=pad, **kw)
        lc, cpu_caches = model.forward_decode(
            cpu_params, cfg, cur.cpu(), (prompt_len + step).cpu(), cpu_caches,
            pad_start=pad.cpu(), **kw)
        scale = float(lc.abs().max())
        worst = max(worst, float((lg.cpu() - lc).abs().max()) / scale)
        cur = lg.argmax(-1)
    log(f"small model ({family}), {method} fused: card (kernels) vs CPU "
        f"(plain path) over 20 decode steps, max |logit diff| / max |logit| "
        f"= {worst:.3e} (limit {LOCKSTEP_LIMIT}: bf16 projections round "
        f"differently on the two)")
    check(caches.comp_len == 32, "small model flushed once")
    check(worst < LOCKSTEP_LIMIT, "small model: card and CPU logits agree")


MID_ARITH = ROOT / "runs" / "mid_arith"


def phase_eval_kernels(torch, timer, record):
    """B1-B4 at the shapes the evaluation path gives them on the mid-scale
    checkpoint (8 rows, 6 kv / 12 q heads, head_dim 64, group 32, prompts
    in buckets of 96 and 128 tokens, 47 decode steps, max_len 512), and B4
    at the CLI's tiny_arith_hf shapes (head_dim 32, 4 kv / 8 q heads,
    max_len 2048, 128 + 255 tokens)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    pad = [22, 36, 30, 27, 33, 24, 29, 31]  # prompts of 92-106 in 128
    eval_shape = dict(b=8, t=512, n_prefill=128, n_append=47, d=64, g=32)
    for row, name, kw in (
            ("decode_attention_eval", "gearl int4, eval path shapes", {}),
            ("decode_attention_eval_gear", "gear int4, eval path shapes",
             dict(outliers_per_block=40))):
        record[row] = decode_case(torch, timer, gen, name, kw, 6, 12, pad,
                                  None, **eval_shape)
    # the GEARL prefill hands the packs the model's bf16 K and V: V
    # contiguous, K a [B, H, S, D] view of [B, S, H, D] memory
    v = torch.randn((48, 128, 64), generator=gen, device="cuda").bfloat16()
    k = torch.randn((8, 128, 6, 64), generator=gen, device="cuda").bfloat16()
    for res in pack_cases(torch, timer, v, k.transpose(1, 2), 4, 32,
                          "bfloat16, eval path shapes"):
        record[res.pop("name") + "_eval"] = res
    record["flash_decode_eval"] = flash_case(
        torch, timer, gen, 6, 12, 8, 512, 175, pad, None, d=64)
    record["flash_decode_eval_d32"] = flash_case(
        torch, timer, gen, 4, 8, 8, 2048, 383, [34, 30, 29, 33, 24, 31, 27,
                                                 28], None, d=32)




def card_vs_cpu_predictions(torch, cfg, params, rows):
    """Greedy answers of NONE in raw mode (the protocol's prompts, batch 8,
    48 new tokens) on the card and on the CPU, from the same bf16 weights:
    each device decodes its own greedy path by the steps
    ``InferenceEngine.generate`` takes (one prefill, then ``decode_step``),
    and every step's logits are kept. Returns the number of equal
    predictions and, for each problem where they part, a dict: its index,
    the first differing token j, the card's and the CPU's token there, the
    top two tokens on each device at the step that chose token j (both
    devices saw the same prefix up to it), that step's top-two gap on each
    and its max |card - CPU| / max |CPU| logits."""
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.eval import harness, synth
    from gear_tpu_torch.tools import acc_run

    tok = synth.CharTokenizer()
    prompts = [tok.encode(harness.GSM8K.build_prompt("", r["question"]))
               for r in rows]
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="NONE")
    on = {"cuda": params, "cpu": {
        k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
            else v.cpu()) for k, v in params.items()}}
    toks, steps = {}, {}  # per device: tokens [n][T], logits [n][T, V]
    for dev, p in on.items():
        eng = InferenceEngine(cfg, p, comp, EngineConfig(
            max_len=acc_run.MAX_LEN, mode="raw"), batch_size=8,
            device=None if dev == "cuda" else dev)
        toks[dev], steps[dev] = [], []
        for i in range(0, len(prompts), 8):
            batch = prompts[i:i + 8]
            s = eng.bucket_len(max(len(t) for t in batch))
            tokens, mask = eng.left_pad(batch, eng.ecfg.pad_token_id, s)
            with torch.no_grad():
                logits, caches = eng.prefill(tokens, mask)
                prompt_len = mask.sum(dim=1).to(torch.int32)
                pad_start = (s - prompt_len).to(torch.int32)
                lg = [logits[:, -1]]
                out = [lg[0].argmax(-1)]
                for step in range(acc_run.MAX_NEW_TOKENS - 1):
                    nxt, step_lg, caches = eng.decode_step(
                        caches, out[-1], prompt_len + step, pad_start,
                        step=step)
                    lg.append(step_lg)
                    out.append(nxt)
            toks[dev] += torch.stack(out, 1).cpu().tolist()
            steps[dev] += torch.stack(lg, 1).float().cpu().unbind(0)

    def pred(t):
        return harness.GSM8K.pred_fn(tok.decode(t).split("Question:")[0])

    agree, parts = 0, []
    for i, (a, b) in enumerate(zip(toks["cuda"], toks["cpu"])):
        if pred(a) == pred(b):
            agree += 1
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        lg_card, lg_cpu = steps["cuda"][i][j], steps["cpu"][i][j]
        top = {"card": torch.topk(lg_card, 2), "cpu": torch.topk(lg_cpu, 2)}
        parts.append({
            "problem": i, "token": j, "card": a[j], "cpu": b[j],
            "top2": {d: t.indices.tolist() for d, t in top.items()},
            "gap": {d: round(float(t.values[0] - t.values[1]), 4)
                    for d, t in top.items()},
            "logit_err": float((lg_card - lg_cpu).abs().max()
                               / lg_cpu.abs().max())})
    return agree, parts


def phase_eval(torch, counts):
    """The accuracy protocol on the card: the mid-scale checkpoint trained
    by gear_tpu (runs/mid_arith, bf16), loaded with ml_dtypes blocked, the
    acc_run matrix in simulated mode and GEAR / GEARL int4 in fused mode,
    zero-shot, greedy, batch 8, 48 new tokens, max_len 512, n=150; the
    record of the same protocol on a TPU beside each figure. Then the
    port's predictions on the card against its predictions on the CPU
    (NONE, raw mode, 16 problems), and the CLI with its turnkey defaults."""
    from gear_tpu_torch import kernels
    from gear_tpu_torch.eval import run as evalrun
    from gear_tpu_torch.tools import acc_run

    t_phase = time.perf_counter()
    sys.modules["ml_dtypes"] = None  # the checkpoint must load without it
    try:
        import ml_dtypes  # noqa: F401
        blocked = False
    except ImportError:
        blocked = True
    check(blocked, "eval: ml_dtypes cannot be imported")
    t0 = time.perf_counter()
    cfg, params, rows = acc_run.load_checkpoint(MID_ARITH)
    check(params["embed"].dtype == torch.bfloat16, "eval: bf16 checkpoint")
    log(f"eval: runs/mid_arith loaded without ml_dtypes in "
        f"{time.perf_counter() - t0:.1f} s: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} q / {cfg.num_kv_heads} kv "
        f"heads, head_dim {cfg.head_dim}, {len(rows)} test problems")
    ref = json.loads((MID_ARITH / "accuracy_sweep.json").read_text())
    n = 150
    check(ref["n"] == n, "eval: the record's n")
    runs = [("simulated", name) for name in acc_run.matrix(cfg.num_layers)]
    runs += [("fused", "GEAR-int4"), ("fused", "GEARL-int4")]
    acc, seen = {}, {"simulated": {}, "fused": {}}
    configs = acc_run.matrix(cfg.num_layers)
    for mode, name in runs:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, _ = acc_run.evaluate(cfg, params, rows, configs[name],
                                  mode=mode, limit=n)
        secs = time.perf_counter() - t0
        run_counts = kernels.launch_counts()
        seen[f"{mode} {name}"] = run_counts
        for k, c in run_counts.items():
            seen[mode][k] = seen[mode].get(k, 0) + c
        acc[mode, name] = res.accuracy
        base = acc["simulated", "NONE"]
        want = ref["results"][name]
        log(f"eval {mode} {name}: accuracy {res.accuracy:.4f} "
            f"({res.correct}/{res.n}) delta vs NONE "
            f"{res.accuracy - base:+.4f}; TPU record (simulated, "
            f"runs/mid_arith/accuracy_sweep.json) {want['accuracy']:.4f} "
            f"({want['correct']}/{want['n']}) delta "
            f"{want['delta_vs_none']:+.4f}; {secs:.1f} s")
    counts["eval"] = seen
    none = acc["simulated", "NONE"]
    check(none >= 0.20, f"eval: NONE accuracy {none:.3f} >= 0.20")
    for (mode, name), a in acc.items():
        if "int4" in name:
            check(abs(a - none) <= 0.06, f"eval: {mode} {name} within 0.06 "
                  f"of NONE ({a:.3f} against {none:.3f})")
    f, sim = seen["fused"], seen["simulated"]
    check(f["decode_attention"] > 0 and f["quant_pack_channels"] > 0
          and f["quant_pack_tokens"] > 0, "eval: fused runs launched B1, "
          "B2 and B3")
    check(sim["flash_decode"] > 0, "eval: simulated runs launched B4")
    log(f"eval launches: simulated {sim}; fused {f}")

    # the card against the CPU: NONE, raw mode, the first 16 problems
    t0 = time.perf_counter()
    agree, parts = card_vs_cpu_predictions(torch, cfg, params, rows[:16])
    log(f"eval card vs CPU, NONE raw, 16 problems: {agree} of 16 "
        f"predictions equal; where they part, at the first differing token "
        f"(same prefix on both), each device's top two, their gap and the "
        f"step's max |logit diff| / max |logit|: {parts} "
        f"({time.perf_counter() - t0:.1f} s)")
    # a parting is allowed only as a bf16 near-tie: the two devices' tokens
    # are the top two on both, and the step's logits agree as in lockstep
    for part in parts:
        pair = sorted((part["card"], part["cpu"]))
        check(all(sorted(t) == pair for t in part["top2"].values())
              and part["logit_err"] < LOCKSTEP_LIMIT,
              f"eval: card and CPU part on problem {part['problem']} only "
              f"at a near-tie of their two tokens, logits within "
              f"{LOCKSTEP_LIMIT}")
    del params
    phase_s = time.perf_counter() - t_phase
    log(f"eval phase (matrix at n={n}, card vs CPU): {phase_s:.1f} s")

    # the CLI, turnkey: tiny_arith_hf, its gsm8k split, NONE, simulated
    out_dir = OUT / "eval_cli"
    before = set(out_dir.glob("results_*.json"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    evalrun.main(["--zero_shot", "--limit", "16", "--out_dir",
                  str(out_dir)])
    counts["eval_cli"] = {"simulated": kernels.launch_counts()}
    new = sorted(set(out_dir.glob("results_*.json")) - before)
    check(len(new) == 1, "eval CLI wrote its results JSON")
    payload = json.loads(new[0].read_text())
    check(payload["results"][0]["n"] == 16, "eval CLI: 16 problems")
    log(f"eval CLI (python -m gear_tpu_torch.eval.run --zero_shot --limit "
        f"16): accuracy {payload['results'][0]['accuracy']:.4f}, "
        f"{time.perf_counter() - t0:.1f} s, launches "
        f"{counts['eval_cli']['simulated']}")


def phase_train(torch):
    """``eval.synth.train`` on the card: the tiny scale, 30 steps from a
    seeded init; the loss falls; the checkpoint round trip keeps every bit;
    greedy generation runs from the trained params."""
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.eval import synth
    from gear_tpu_torch.models import llama
    from gear_tpu_torch.tools import acc_run

    tok = synth.CharTokenizer()
    cfg = llama.ModelConfig(**acc_run.SCALES["tiny"])
    params = llama.init_params(cfg, seed=0)
    spec = synth.TrainSpec(steps=30)
    losses = []
    t0 = time.perf_counter()
    trained = synth.train(cfg, params, synth.make_dataset(4000, seed=0), tok,
                          spec, log_every=10, log=log, losses=losses)
    torch.cuda.synchronize()
    log(f"train: {spec.steps} steps of batch {spec.batch} x {spec.seq_len} "
        f"in {time.perf_counter() - t0:.1f} s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    check(losses[-1] < losses[0], "train: the last loss below the first")
    path = OUT / "train" / "params.pkl"
    synth.save_params(trained, path)
    back = synth.load_params(path)
    same = all(
        torch.equal(a.view(torch.int16), b.view(torch.int16))
        for (_, a), (_, b) in zip(synth._flatten(trained),
                                  synth._flatten(back)))
    check(same, "train: save_params -> load_params keeps every bit")
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="NONE")
    eng = InferenceEngine(cfg, back, comp, EngineConfig(max_len=256,
                                                        mode="raw"),
                          batch_size=2)
    rows = synth.make_dataset(2, seed=5)
    prompts = [tok.encode(synth.QUESTION_TEMPLATE.format(q=r["question"]))
               for r in rows]
    out = eng.generate(prompts, 24)
    check(all(len(o) == 24 and all(0 <= x < cfg.vocab_size for x in o)
              for o in out), "train: greedy generation from the trained "
          "params")
    log(f"train: greedy from the trained params: {tok.decode(out[0])!r}")


def phase_evict(torch, cfg):
    """Engine modes h2o and sink at the full width and depth of Llama-2-7B,
    seeded random bf16 weights, batch 4, prompts of ~1,000 tokens in a
    bucket of 1024, 80 new tokens: H2O with 256 heavy-hitter and 768 recent
    slots (eviction from the first decode step), sink with 4 sinks and a
    window of 1020 (the ring wraps from the first decode step). The first
    token must be raw mode's (the prompt fits, the prefill is exact), the
    logits finite; step times beside raw mode's."""
    import numpy as np

    from gear_tpu_torch import kernels
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.models import llama
    from torch.profiler import ProfilerActivity, profile

    lens, batch, n_new, max_len = [1000, 1024, 977, 1011], 4, 80, 1152
    params = llama.init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="NONE", group_size=64,
                             important_size=256, recent_size=768,
                             sink_size=4, window_size=1020)

    def engine(mode):
        return InferenceEngine(cfg, params, comp,
                               EngineConfig(max_len=max_len, mode=mode),
                               batch_size=batch)

    first_raw = [o[0] for o in engine("raw").generate(prompts, 1)]
    for mode in ("h2o", "sink"):
        eng = engine(mode)
        eng.generate(prompts, 2)  # warm-up
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, n_new)  # the path
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        check(len(out) == batch and all(len(o) == n_new for o in out)
              and all(0 <= x < cfg.vocab_size for o in out for x in o),
              f"{mode}: output shape and range")
        check([o[0] for o in out] == first_raw, f"{mode}: first token equal "
              "to raw mode's")
        s = eng.bucket_len(max(lens))
        tokens, mask = eng.left_pad(prompts, 0, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = eng.prefill(tokens, mask)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prompt_len = mask.sum(dim=1).to(torch.int32)
        pad = (s - prompt_len).to(torch.int32)
        cur = logits[:, -1].argmax(-1)
        del logits
        times = []
        for i in range(n_new - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cur, lg, caches = eng.decode_step(caches, cur, prompt_len + i,
                                              pad)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(lg).all()), f"{mode}: decode logits finite")
        if mode == "h2o":
            check(caches.length == eng.hspec.budget
                  and int(caches.pos.min()) >= 0,
                  "h2o: the cache evicted and holds no pad slot")
            state = (f"budget {eng.hspec.budget} full, kept positions "
                     f"{int(caches.pos.min())}..{int(caches.pos.max())}")
        else:
            check(caches.length == s + n_new - 1
                  and caches.length > eng.sspec.capacity,
                  "sink: the ring wrapped")
            state = (f"{caches.length} tokens through a capacity of "
                     f"{eng.sspec.capacity}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n_new - 1, n_new + 4):
                cur, _, caches = eng.decode_step(caches, cur,
                                                 prompt_len + i, pad)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        device_ms = sum(e.device_time_total for e in rows) / 5 / 1e3
        n_kernels = sum(e.count for e in rows) / 5
        median = sorted(times)[len(times) // 2]
        log(f"{mode} Llama-2-7B (32 layers, depth not cut): batch {batch}, "
            f"prompts {lens}, {n_new} new tokens; {state}; first tokens "
            f"equal to raw mode's; generate_ms={total_ms:.1f} (one "
            f"host-clock sample) prefill_ms={prefill_ms:.1f} "
            f"median_step_ms={median:.2f} min_step_ms={min(times):.2f} "
            f"device_ms_per_step={device_ms:.2f} "
            f"device_launches_per_step={n_kernels:.0f} "
            f"tokens_per_s={batch / median * 1e3:.1f}; kernel launches "
            f"{launches} (plain torch attention, as in the reference)")
        del eng, caches
    raw = engine("raw")
    median, line = step_breakdown(torch, raw, prompts, lens)
    log(f"h2o / sink beside raw (same config): {line} "
        f"tokens_per_s={batch / median * 1e3:.1f}")
    del raw, params
    torch.cuda.empty_cache()


def phase_small_evict(torch):
    """A small bf16 model in modes h2o and sink, decoding in lockstep on the
    card and on the CPU from the same prompts, through eviction and the
    ring's wrap: the logits must agree."""
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.models import llama

    cfg = llama.ModelConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                                 head_dim=64, intermediate_size=512)
    params = llama.init_params(cfg, seed=3)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    comp = CompressionConfig(num_layers=cfg.num_layers, group_size=16,
                             important_size=6, recent_size=26, sink_size=3,
                             window_size=29)
    prompts = [[5, 9, 2, 7, 11, 3, 8, 4, 1, 6, 12, 13, 14, 15, 16, 17, 18,
                19, 21, 22], [4, 1, 6, 20, 30]]
    for mode in ("h2o", "sink"):
        engs = [InferenceEngine(cfg, p, comp, EngineConfig(max_len=128,
                                                           mode=mode),
                                batch_size=2, device=dev)
                for p, dev in ((params, None), (cpu_params, "cpu"))]
        tokens, mask = engs[0].left_pad(prompts, 0, 32)
        states = [eng.prefill(t, m) for eng, t, m in (
            (engs[0], tokens, mask), (engs[1], tokens.cpu(), mask.cpu()))]
        caches = [c for _, c in states]
        cur = states[0][0][:, -1].argmax(-1)
        prompt_len = mask.sum(dim=1).to(torch.int32)
        pad = (32 - prompt_len).to(torch.int32)
        worst = 0.0
        for step in range(40):
            out = [eng.decode_step(c, t, (prompt_len + step).to(t.device),
                                   pad.to(t.device))
                   for eng, c, t in zip(engs, caches, (cur, cur.cpu()))]
            lg, lc = out[0][1].cpu(), out[1][1]
            worst = max(worst, float((lg - lc).abs().max())
                        / float(lc.abs().max()))
            caches = [o[2] for o in out]
            cur = out[0][1].argmax(-1)
        if mode == "h2o":
            check(caches[0].length == 32 and torch.equal(
                caches[0].pos.cpu(), caches[1].pos),
                "small h2o: evicting, the same kept positions on both")
        else:
            check(caches[0].length == 72 > engs[0].sspec.capacity,
                  "small sink: the ring wrapped")
        log(f"small model, {mode}: card vs CPU over 40 decode steps through "
            f"{'eviction' if mode == 'h2o' else 'the ring wrap'}, max |logit "
            f"diff| / max |logit| = {worst:.3e} (limit 5e-2: bf16 "
            f"projections round differently on the two)")
        check(worst < 5e-2, f"small {mode}: card and CPU logits agree")


MIXTRAL_DEPTH = 16  # of 32 layers: 46.5 GB of bf16 weights; 32 (93 GB)
# do not fit the 80 GB card beside the prefill's intermediates


def profile_steps(torch, step, n=5, top=6):
    """``step()`` ``n`` times under the profiler: device ms and launches a
    call, the longest single launch of a copy kernel in ms, and the ``top``
    kernels by device time (ms a call each, names shortened)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in rows) / n / 1e3
    launches = sum(e.count for e in rows) / n
    copy_ms = max([e.device_time_total / e.count / 1e3 for e in rows
                   if "copy" in e.key.lower()] or [0.0])
    rows.sort(key=lambda e: -e.device_time_total)
    heavy = "; ".join(
        f"{short_name(e.key)[:44]} {e.device_time_total / n / 1e3:.2f}"
        for e in rows[:top])
    return device_ms, launches, copy_ms, heavy


def phase_mixtral(torch, timer, record):
    """Mixtral-8x7B (sparse MoE: 8 experts of 14,336, top 2) at full width
    and ``MIXTRAL_DEPTH`` of its 32 layers, seeded random bf16 weights made
    on the card, through ``models.mixtral.forward_prefill`` /
    ``forward_decode``: GEAR int2 (2% outliers, group 64, rank 2, prefill
    rank 4, loop 3), batch 2, prompts of 8,100 and 7,900 tokens left-padded
    to 8,100, max_len 8,320, 80 greedy decode steps (8,100 = 126 x 64 + 36:
    the residual tier flushes at step 28), in fused mode and in raw mode (the
    bf16 baseline). Launch counts set to 0 just before each run and read
    just after. After step 40 the fused run's 16 stacked layers are saved
    with ``runtime.kvstore`` and, after the run, loaded into a fresh cache:
    steps 41-80 from it must give the same tokens and logits bit for bit.
    On the live caches B1 and B4 are held against their plain versions and
    timed there; B2 and B3 at the prefill's shape, bit-equal. Returns the
    launch counts of the two runs."""
    import numpy as np

    from gear_tpu_torch import cache as TC
    from gear_tpu_torch import kernels
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.models import llama, mixtral
    from gear_tpu_torch.runtime import faults, kvstore

    card = nvidia_smi()  # beside every measured line
    full = mixtral.MixtralConfig.mixtral_8x7b()
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_DEPTH)
    n_l, batch, lens, s, max_len, n_steps, snap_at = (
        cfg.num_layers, 2, [8100, 7900], 8100, 8320, 80, 40)
    comp = CompressionConfig(num_layers=n_l, compress_method="GEAR",
                             quantize_bit=2, group_size=64, rank=2,
                             prefill_rank=4, loop=3, left=0.02)
    spec = cfg.cache_spec(batch, max_len, comp.layer(0))

    # B2 and B3 at the prefill's shape: 2 x 8 rows of the 8,064 tokens the
    # prefill compresses, int2, outliers replaced by the block mean (the
    # float32 block the GEAR route hands both)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((batch * cfg.num_kv_heads, 8064, cfg.head_dim),
                    generator=gen, device="cuda")
    x = cleaned_blocks(torch, x.bfloat16().float(), cfg.num_kv_heads)
    for res in pack_cases(torch, timer, x, x, 2, 64,
                          "float32 outlier-cleaned, Mixtral-8x7B prefill"):
        record[res.pop("name") + "_mixtral"] = res
    del x

    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_par = llama.param_count(params)
    step_weights = 2 * (n_par - params["embed"].numel())  # bytes read a step
    per_layer = llama.param_count(params["layers"]) // n_l
    full_bytes = 2 * (n_par + per_layer * (full.num_layers - n_l))
    log(f"e2e mixtral: Mixtral-8x7B, hidden {cfg.hidden_size}, experts "
        f"{cfg.num_experts} x FFN {cfg.intermediate_size}, top "
        f"{cfg.experts_per_token}, heads {cfg.num_heads} / kv "
        f"{cfg.num_kv_heads}, rope theta {cfg.rope_theta}, no window, "
        f"layers {n_l} of {full.num_layers} ({n_par / 1e9:.2f} B parameters, "
        f"{2 * n_par / 1e9:.1f} GB bf16; all {full.num_layers} layers, "
        f"{full_bytes / 1e9:.1f} GB, do not fit the 80 GB card); GEAR int2 "
        f"group 64 rank 2 "
        f"prefill rank 4 loop 3 left 0.02 (ko {spec.outliers_per_block}); "
        f"batch {batch}, prompts {lens} left-padded to {s}, {n_steps} decode "
        f"steps, max_len {max_len}; random init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    tokens = torch.zeros((batch, s), dtype=torch.int64)
    mask = torch.zeros((batch, s), dtype=torch.int32)
    for i, n in enumerate(lens):
        tokens[i, s - n:] = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                          n))
        mask[i, s - n:] = 1
    tokens, mask = tokens.cuda(), mask.cuda()
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad = [s - n for n in lens]
    pad_t = torch.tensor(pad, dtype=torch.int32, device="cuda")

    # warm-up at a short prompt: CUDA modules, cuBLAS handles, both modes
    wspec = cfg.cache_spec(batch, 384, comp.layer(0))
    for compress in (True, False):
        _, wc = mixtral.forward_prefill(params, cfg, tokens[:, -320:],
                                        positions[:, -320:], mask[:, -320:],
                                        wspec, compress=compress)
        mixtral.forward_decode(params, cfg, tokens[:, -1], prompt_len, wc,
                               spec=wspec, compress=compress, pad_start=pad_t)
    del wc
    snap = OUT / "mixtral_snapshot.gear"
    runs, counts, save_ms = {}, {}, None
    for mode in ("fused", "raw"):
        compress = mode == "fused"
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = mixtral.forward_prefill(
            params, cfg, tokens, positions, mask, spec, compress=compress,
            generator=gen)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        last = logits[:, -1].clone()
        del logits
        toks, step_logits, times = [last.argmax(-1)], [], []
        for step in range(1, n_steps + 1):  # the main path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = mixtral.forward_decode(
                params, cfg, toks[-1], prompt_len + step - 1, caches,
                spec=spec, compress=compress, pad_start=pad_t, generator=gen,
                step=step)
            toks.append(lg.argmax(-1))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            step_logits.append(lg)
            if compress and step == snap_at:
                check(caches.comp_len == 8128 and caches.resid_len == 12,
                      "mixtral: the flush at step 28 came before the "
                      "snapshot")
                t0 = time.perf_counter()
                kvstore.save_cache(snap, caches)
                save_ms = (time.perf_counter() - t0) * 1e3
        counts[mode] = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        faults.check_or_raise({"caches": caches, "prefill": last,
                               "steps": step_logits}, f"mixtral {mode}")
        out = torch.stack(toks, dim=1).cpu()
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"mixtral {mode}: tokens in range")
        runs[mode] = dict(last=last, toks=toks, logits=step_logits,
                          caches=caches)
        steady = sorted(t for i, t in enumerate(times) if i != 27)
        median = steady[len(steady) // 2]
        kv = (spec.bytes_compressed() if compress
              else spec.bytes_fp16_baseline()) * n_l
        log(f"e2e mixtral {mode}: prefill_ms={prefill_ms:.1f} "
            f"median_step_ms={median:.2f} min_step_ms={steady[0]:.2f} "
            f"step_28_ms={times[27]:.1f} "
            f"({'the flush' if compress else 'no flush'}) tokens_per_s={batch / median * 1e3:.1f} kv_bytes={kv} (bf16 "
            f"baseline {spec.bytes_fp16_baseline() * n_l}) "
            f"max_memory_allocated={peak} launches={counts[mode]} [{card}]")

    f, r = runs["fused"], runs["raw"]
    check(torch.equal(f["last"], r["last"]) and torch.equal(
        f["toks"][0], r["toks"][0]), "mixtral: fused and raw take the same "
        "first token, from the same prefill logits")
    cf, cr = counts["fused"], counts["raw"]
    check(cf["decode_attention"] == n_l * n_steps and cf["flash_decode"] == 0
          and cf["quant_pack_channels"] == n_l
          and cf["quant_pack_tokens"] == n_l, "mixtral fused: B1 every layer "
          "and step, B2 / B3 once a layer in the prefill")
    check(cr["flash_decode"] == n_l * n_steps and cr["decode_attention"] == 0
          and cr["quant_pack_tokens"] == 0, "mixtral raw: B4 every layer "
          "and step")
    agree = float(np.mean([bool(torch.equal(a, b)) for a, b in
                           zip(f["toks"], r["toks"])]))
    log(f"e2e mixtral: first token equal in fused and raw mode; int2 fused "
        f"vs raw greedy agreement over {n_steps + 1} tokens {agree:.3f} "
        f"(random weights: near-uniform logits)")

    # resume from the snapshot taken after step 40
    like = TC.init_stacked(spec, n_l, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = kvstore.load_cache(snap, like)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    del like
    snap_bytes = snap.stat().st_size
    snap.unlink()
    check((resumed.comp_len, resumed.resid_len, resumed.prefill_len)
          == (8128, 12, 8064), "mixtral: the snapshot's lengths")
    gen = torch.Generator(device="cuda").manual_seed(2)  # draws nothing
    for step in range(snap_at + 1, n_steps + 1):
        lg, resumed = mixtral.forward_decode(
            params, cfg, f["toks"][step - 1], prompt_len + step - 1, resumed,
            spec=spec, pad_start=pad_t, generator=gen, step=step)
        check(torch.equal(lg, f["logits"][step - 1])
              and torch.equal(lg.argmax(-1), f["toks"][step]),
              f"mixtral: step {step} after the resume equals the "
              "uninterrupted run's logits and token bit for bit")
    for fld in TC.TENSOR_FIELDS:
        check(torch.equal(getattr(resumed, fld), getattr(f["caches"], fld)),
              f"mixtral: the resumed cache's {fld} equals the uninterrupted "
              "one's")
    log(f"e2e mixtral snapshot after step {snap_at}: {snap_bytes} bytes "
        f"({snap_bytes / (spec.bytes_fp16_baseline() * n_l):.3f} of the bf16 "
        f"KV bytes {spec.bytes_fp16_baseline() * n_l}), save_ms={save_ms:.1f} "
        f"load_ms={load_ms:.1f}, codec "
        f"{'native' if kvstore.native_available() else 'numpy'}; steps {snap_at + 1}-{n_steps} from it: tokens and logits equal "
        f"the uninterrupted run's bit for bit [{card}]")

    # B1 on one layer's live cache after the flush, B4 on the raw one
    gen = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((batch, cfg.num_heads, 1, cfg.head_dim), generator=gen,
                    device="cuda")
    record["decode_attention_mixtral"] = hold_decode(
        torch, timer, "gear int2, Mixtral-8x7B live cache, layer 0", spec,
        f["caches"].layer(0), q, pad, None)
    record["flash_decode_mixtral"] = hold_flash(
        torch, timer, spec, r["caches"].layer(0), q, pad, None)

    # device time a step, and no copy of the expert weights in it
    for mode, run in (("fused", resumed), ("raw", r["caches"])):
        state = {"tok": f["toks"][-1] if mode == "fused" else r["toks"][-1],
                 "step": n_steps + 1, "caches": run}

        def step():
            lg, state["caches"] = mixtral.forward_decode(
                params, cfg, state["tok"], prompt_len + state["step"] - 1,
                state["caches"], spec=spec, compress=mode == "fused",
                pad_start=pad_t, generator=gen, step=state["step"])
            state["tok"] = lg.argmax(-1)
            state["step"] += 1

        device_ms, launches, copy_ms, heavy = profile_steps(torch, step)
        log(f"e2e mixtral {mode} steps {n_steps + 1}-{n_steps + 5} under the "
            f"profiler: device_ms_per_step={device_ms:.2f} "
            f"device_launches_per_step={launches:.0f}; longest copy kernel "
            f"{copy_ms:.4f} ms; weights read a step {step_weights} bytes, "
            f"{bound_ms(step_weights, 0)[0]:.2f} ms at 3.35 TB/s; "
            f"heaviest kernels, ms a step: {heavy} [{card}]")
        check(copy_ms < 0.25, f"mixtral {mode}: no copy kernel reads the "
              "expert weights (one layer's stack of one matrix, 940 MB, "
              "takes >= 0.28 ms to read)")
    del runs, f, r, resumed
    # where the raw prefill's device time goes (outside the counted runs)
    device_ms, launches, _, heavy = profile_steps(
        torch, lambda: mixtral.forward_prefill(
            params, cfg, tokens, positions, mask, spec, compress=False),
        n=1, top=8)
    log(f"e2e mixtral raw prefill under the profiler: device_ms="
        f"{device_ms:.1f} launches={launches:.0f}; heaviest kernels, ms: "
        f"{heavy} [{card}]")
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The parallel slice: tensor, sequence and expert parallelism, two gloo
# ranks on the one card.
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_TIMEOUT = 420  # seconds for both ranks, every path
PARALLEL_NOTE = ("two ranks sharing one card, gloo copying each collective "
                 "through host memory: a correctness run, not a production "
                 "speed")
TP_PROMPTS = [1000, 1024, 977, 1011]      # the Llama-2-7B cell's batch
SEQ_PROMPT, SEQ_MAX_LEN = 8000, 8192      # two shards of 4,096 tokens
MISTRAL_PROMPTS, MISTRAL_MAX_LEN, MISTRAL_STEPS = [4300, 4210], 4480, 15
EP_PROMPTS, EP_MAX_LEN, EP_STEPS = [1000, 960], 1088, 20
MIXTRAL_EP_DEPTH = 4  # of 32 layers


def parallel_prompts(vocab: int, lens) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def parallel_comp(cfg, method: str, bits: int):
    from gear_tpu_torch.config import CompressionConfig

    return CompressionConfig(num_layers=cfg.num_layers,
                             compress_method=method, quantize_bit=bits,
                             group_size=64, rank=2, prefill_rank=4, loop=3,
                             left=0.02)


def parallel_engine(cfg, params, method, batch, max_len, mode="fused"):
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine

    return InferenceEngine(cfg, params, parallel_comp(cfg, method, 4),
                           EngineConfig(max_len=max_len, mode=mode),
                           batch_size=batch)


def lockstep_run(torch, eng, prompts, n_steps, feed=None, times=None,
                 draws=None):
    """What ``eng.generate(prompts, n_steps + 1)`` runs (its stages, the
    generator seeded 0), fed the tokens ``feed`` (one [B] tensor a position)
    in place of its own greedy ones when given. Returns the greedy tokens
    and the logits (CPU float32) at the prompt's last position and every
    step, the caches, the left padding and the state to go on from; each
    step's host ms is appended to ``times``. The power-iteration inits are
    drawn as the engine draws them (uniform from the generator, at the
    shape asked for), and each draw's site, shape and sum is appended to
    ``draws``: a sharded engine asks for the whole batch's and heads'."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def init(site, shape):
        x = torch.rand(shape, generator=gen, device="cuda",
                       dtype=torch.float32)
        draws.append((tuple(int(v) if isinstance(v, torch.Tensor) else v
                            for v in site), tuple(shape),
                       float(x.double().sum())))
        return x

    init = None if draws is None else init
    s = eng.bucket_len(max(len(p) for p in prompts))
    tokens, mask = eng.left_pad(prompts, 0, s)
    logits, caches = eng.prefill(tokens, mask, init=init, generator=gen)
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad = (s - prompt_len).to(torch.int32)
    outs, toks = [logits[:, -1].float().cpu()], [logits[:, -1].argmax(-1)]
    del logits
    if eng.seq_mesh is not None:
        from gear_tpu_torch.parallel import context

        n = eng.seq_mesh.axis_size(eng.seq_axis)
        caches = context.split_cache(eng.spec, caches, n)[
            eng.seq_mesh.index(eng.seq_axis)]
    for i in range(n_steps):
        cur = toks[-1] if feed is None else feed[i].cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, lg, caches = eng.decode_step(caches, cur, prompt_len + i, pad,
                                          step=i, init=init, generator=gen,
                                          n_tokens=s + i)
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg.float().cpu())
        toks.append(nxt)
    state = dict(caches=caches, cur=toks[-1], prompt_len=prompt_len, pad=pad,
                 gen=gen, s=s, step=n_steps)
    return [t.cpu() for t in toks], outs, state


def compare_lockstep(torch, ref_logits, got_logits):
    """The worst |got - ref| / max |ref| over the positions, the share of
    greedy tokens alike, and where they part: for each parting its
    position, row, the place of the other run's token in each run's order
    (0 the top: ``ref_rank`` of got's token among the reference's logits,
    ``got_rank`` of the reference's token among got's), the reference's
    margin between the two, and the row's largest |got - ref| (``err``).
    :func:`near_tie` judges a parting; :func:`top_two` is reported."""
    worst, same, total, parts = 0.0, 0, 0, []
    for i, (r, g) in enumerate(zip(ref_logits, got_logits)):
        d = (g - r).abs()
        worst = max(worst, float(d.max()) / float(r.abs().max()))
        rt, gt = r.argmax(-1), g.argmax(-1)
        same += int((rt == gt).sum())
        total += rt.numel()
        for row in (rt != gt).nonzero().flatten().tolist():
            a, b = int(rt[row]), int(gt[row])
            parts.append(dict(
                pos=i, row=row, ref_rank=int((r[row] > r[row, b]).sum()),
                got_rank=int((g[row] > g[row, a]).sum()),
                margin=round(float(r[row, a] - r[row, b]), 4),
                err=round(float(d[row].max()), 4)))
    return worst, same / total, parts


def near_tie(part: dict) -> bool:
    """Whether a parting of :func:`compare_lockstep` is one at a near-tie:
    the reference's margin lies within the row's largest |got - ref|. (Two
    errors of at most ``err`` can swap tokens up to twice that apart, so
    this fails where both tokens' errors had to be near the row's largest,
    in opposite directions.)"""
    return part["margin"] <= part["err"]


def top_two(part: dict) -> bool:
    """The eval phase's rule for a parting (card against CPU): each run's
    token is the other's second, so the two are the top two of both runs.
    Reported only: near-uniform logits over 32,000 tokens put a third token
    between the two at some partings."""
    return part["ref_rank"] == 1 and part["got_rank"] == 1


def check_generated(key, tokens, ref_toks, got_toks, parts):
    """``tokens`` (what the sharded ``generate`` returned, every row) must
    be the reference's greedy tokens up to each row's first parting in
    lockstep; at that parting, the reference's token or the sharded
    lockstep run's own (both stand at a near-tie); after it the runs have
    parted and nothing is compared. Returns the tokens compared."""
    first, compared = {}, 0
    for p in parts:  # parts come in position order
        first.setdefault(p["row"], p["pos"])
    for row, got_row in enumerate(tokens):
        ref_row = [int(t[row]) for t in ref_toks]
        upto = first.get(row, len(ref_row))
        check(len(got_row) == len(ref_row)
              and got_row[:upto] == ref_row[:upto],
              f"parallel {key}: row {row} of the sharded generate equals the "
              f"unsharded tokens up to its first parting ({upto})")
        if upto < len(ref_row):
            check(got_row[upto] in (ref_row[upto], int(got_toks[upto][row])),
                  f"parallel {key}: row {row} parts at {upto} to one of the "
                  f"two tied tokens")
        compared += min(upto + 1, len(ref_row))
    return compared


def continue_steps(eng, state, torch):
    """A decode step function that goes on from ``lockstep_run``'s state
    with its own greedy tokens."""
    def step():
        i = state["step"]
        state["cur"], _, state["caches"] = eng.decode_step(
            state["caches"], state["cur"], state["prompt_len"] + i,
            state["pad"], step=i, generator=state["gen"],
            n_tokens=state["s"] + i)
        state["step"] += 1
    return step


def collective_ms(torch, mesh, axis, calls, n=20) -> float:
    """Host ms of one step's collectives alone: ``calls`` [(shape, op)]
    each an ``all_reduce`` of a float32 tensor on the card, synchronised
    before and after, a mean over ``n`` repeats."""
    from gear_tpu_torch.parallel import distributed

    bufs = [(torch.ones(shape, device="cuda"), op) for shape, op in calls]
    distributed.all_reduce(bufs[0][0], mesh, axis)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        for x, op in bufs:
            distributed.all_reduce(x, mesh, axis, op)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def parallel_references(torch, llama_cut, mixtral_cfg) -> dict:
    """The unsharded runs the ranks are held against, in lockstep: the
    Llama-2-7B cell fused and raw, the 8,000-token prompt fused, Mistral-7B
    at the TP rows' batch, and Mixtral's dense mixture over the compressed
    cache. Each engine's own ``generate`` must return the greedy tokens of
    :func:`lockstep_run`, which the ranks' ``generate`` is held against."""
    from gear_tpu_torch.models import llama, mistral, mixtral

    refs = {}

    def ref(key, eng, prompts, n_steps):
        draws = []
        toks, outs, _ = lockstep_run(torch, eng, prompts, n_steps,
                                     draws=draws)
        want = eng.generate(prompts, n_steps + 1)
        check(want == torch.stack(toks, dim=1).tolist(),
              f"parallel {key}: the unsharded generate repeats the "
              f"reference's greedy tokens")
        refs[key] = dict(toks=toks, logits=outs, draws=draws)

    params = llama.init_params(llama_cut, seed=0)
    prompts = parallel_prompts(llama_cut.vocab_size, TP_PROMPTS)
    for mode in ("fused", "raw"):
        ref(f"tp {mode}", parallel_engine(llama_cut, params, "GEARL", 4,
                                          1152, mode), prompts, 79)
    ref("seq", parallel_engine(llama_cut, params, "GEARL", 1, SEQ_MAX_LEN),
        parallel_prompts(llama_cut.vocab_size, [SEQ_PROMPT]), 79)
    del params
    torch.cuda.empty_cache()
    mcut = dataclasses.replace(mistral.mistral_7b(), num_layers=EARLIER_DEPTH)
    params = llama.init_params(mcut, seed=0)
    ref("tp mistral", parallel_engine(mcut, params, "GEAR", 2,
                                      MISTRAL_MAX_LEN),
        parallel_prompts(mcut.vocab_size, MISTRAL_PROMPTS), MISTRAL_STEPS)
    del params
    torch.cuda.empty_cache()

    params = mixtral.init_params(mixtral_cfg, seed=0)
    toks, outs, _ = mixtral_lockstep(torch, mixtral_cfg, params, None)
    refs["ep"] = dict(toks=toks, logits=outs)
    # one layer's mixture, for moe_block_ep to be held against
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((2, 64, mixtral_cfg.hidden_size), generator=gen,
                    device="cuda").bfloat16()
    lp = llama._layer_slice(params["layers"], 0)
    refs["moe"] = dict(x=x.cpu(), out=mixtral.moe_block(
        x, lp["router"], lp["wg"], lp["wu"], lp["wd"],
        mixtral_cfg.experts_per_token).cpu())
    del params, lp
    torch.cuda.empty_cache()
    return refs


def mixtral_lockstep(torch, cfg, params, feed, ep_mesh=None, times=None):
    """Mixtral's prefill and ``EP_STEPS`` decode steps through
    ``models.mixtral`` (GEAR int2, 2% outliers), optionally fed ``feed``:
    (tokens, logits) as :func:`lockstep_run` gives them, and a step
    function that goes on with its own greedy tokens."""
    from gear_tpu_torch.models import mixtral

    spec = cfg.cache_spec(2, EP_MAX_LEN, parallel_comp(cfg, "GEAR", 2)
                          .layer(0))
    prompts = parallel_prompts(cfg.vocab_size, EP_PROMPTS)
    s = 1024
    tokens = torch.zeros((2, s), dtype=torch.int64)
    mask = torch.zeros((2, s), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, s - len(p):] = torch.tensor(p)
        mask[i, s - len(p):] = 1
    tokens, mask = tokens.cuda(), mask.cuda()
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad = (s - prompt_len).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits, caches = mixtral.forward_prefill(params, cfg, tokens, positions,
                                             mask, spec, generator=gen,
                                             ep_mesh=ep_mesh)
    outs, toks = [logits[:, -1].float().cpu()], [logits[:, -1].argmax(-1)]
    del logits
    state = {"caches": caches, "i": 0}

    def step(cur=None):
        i = state["i"]
        lg, state["caches"] = mixtral.forward_decode(
            params, cfg, toks[-1] if cur is None else cur, prompt_len + i,
            state["caches"], spec=spec, pad_start=pad, generator=gen, step=i,
            ep_mesh=ep_mesh)
        toks.append(lg.argmax(-1))
        state["i"] += 1
        return lg

    for i in range(EP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = step(None if feed is None else feed[i].cuda())
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg.float().cpu())
    return [t.cpu() for t in toks], outs, step


def phase_parallel(torch, record, counts, llama_cut):
    """Tensor, sequence and expert parallelism through the port's entry
    points, as ``PARALLEL_RANKS`` processes on the one card over gloo
    (NCCL refuses two ranks on one card): the unsharded references run
    here first, then the ranks (this script with ``--parallel-rank``) run
    every path and are held against them in lockstep. Any rank that fails,
    raises or outlives ``PARALLEL_TIMEOUT`` fails the phase."""
    import dataclasses as dc

    from gear_tpu_torch.models import mixtral

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"parallel: backend gloo, {PARALLEL_RANKS} ranks on cuda:0, card "
        f"compute mode {mode}")
    mcfg = dc.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                      num_layers=MIXTRAL_EP_DEPTH)
    t0 = time.perf_counter()
    refs = parallel_references(torch, llama_cut, mcfg)
    ref_path = OUT / "parallel_refs.pt"
    torch.save(refs, ref_path)
    del refs
    torch.cuda.empty_cache()
    log(f"parallel: unsharded references in {time.perf_counter() - t0:.1f} s")
    init = OUT / "parallel_rendezvous"
    init.unlink(missing_ok=True)
    logs = [OUT / f"parallel_rank{r}.log" for r in range(PARALLEL_RANKS)]
    results = [OUT / f"parallel_rank{r}.json" for r in range(PARALLEL_RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    procs = []
    for r in range(PARALLEL_RANKS):
        env = {**os.environ, "WORLD_SIZE": str(PARALLEL_RANKS),
               "RANK": str(r)}
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--parallel-rank", f"file://{init}", str(ref_path)],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    t0 = time.perf_counter()
    try:
        for p in procs:
            left = PARALLEL_TIMEOUT - (time.perf_counter() - t0)
            p.wait(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ref_path.unlink(missing_ok=True)
    res = []
    for r, p in enumerate(procs):
        if results[r].exists():
            res.append(json.loads(results[r].read_text()))
            for line in res[-1]["lines"]:
                log(f"parallel rank {r}: {line}")
        if p.returncode != 0:
            log(f"parallel rank {r} exited {p.returncode}; its log's end:\n"
                f"{logs[r].read_text()[-3000:]}")
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"parallel rank {r} ran every path and "
              f"held it")
    counts["tp"] = {m: res[0]["counts"][f"tp {m}"] for m in ("fused", "raw")}
    counts["tp_mistral"] = {"fused": res[0]["counts"]["tp mistral"]}
    row = record.get("decode_attention_tp")
    if row:  # the decode phase's case and both ranks' live caches
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [rr["b1_err"] for rr in res])
    log(f"parallel: every path held in {time.perf_counter() - t0:.1f} s "
        f"({PARALLEL_NOTE})")


def parallel_rank(init: str, ref_path: str) -> int:
    """One rank of the parallel phase: every path, its checks, and what it
    measured, written to ``_build/parallel_rank<r>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from gear_tpu_torch import kernels
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.api import GearLM
    from gear_tpu_torch.engine import EngineConfig
    from gear_tpu_torch.kernels import decode as TK
    from gear_tpu_torch.models import llama, mistral, mixtral
    from gear_tpu_torch.parallel import distributed as D
    from gear_tpu_torch.parallel import sharding as S

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.initialize_from_env("gloo", init_method=init)
    rank = dist.get_rank()
    tp, seq, ep = S.make_mesh(model=2), D.Mesh({"seq": 2}), D.Mesh(
        {"expert": 2})
    refs = torch.load(ref_path)
    card = nvidia_smi()
    out = {"lines": [D.describe(tp)], "counts": {}}
    lines = out["lines"]
    llama_cut = dataclasses.replace(llama.ModelConfig.llama2_7b(),
                                    num_layers=EARLIER_DEPTH)
    n_l = llama_cut.num_layers

    failed = []  # the lockstep checks that failed, raised after every path

    def held(key, got_logits, steps_ms, step_fn, mesh, axis, calls, *,
             got_toks=None, tokens=None, draws=None):
        """Lockstep against the unsharded run (``tokens``, what the sharded
        ``generate`` returned, held against its greedy tokens; ``draws``,
        the inits the rank drew, against the unsharded run's), then a
        step's device time, collectives and memory, as lines."""
        worst, agree, parts = compare_lockstep(torch, refs[key]["logits"],
                                               got_logits)
        lines.append(
            f"{key}: lockstep partings (position, row, got's token's place "
            f"in ref, ref's in got, ref margin, row max|diff|): "
            f"{[tuple(p.values()) for p in parts]}")
        log(lines[-1])
        if worst >= LOCKSTEP_LIMIT:
            failed.append(f"{key}: lockstep logits within {LOCKSTEP_LIMIT} "
                          f"(worst {worst:.3e})")
        ties = [p for p in parts if near_tie(p)]
        if len(ties) < len(parts):
            failed.append(f"{key}: tokens part only where the reference's "
                          f"margin lies within the row's largest error: "
                          f"{[p for p in parts if not near_tie(p)]}")
        # the top-two rule is reported, not held: at random weights a
        # third token lies within the noise at a few partings (PERF.md)
        tops = [p for p in parts if top_two(p)]
        if draws is not None and draws != refs[key]["draws"]:
            failed.append(f"{key}: the rank drew the unsharded run's "
                          f"inits ({len(draws)} draws against "
                          f"{len(refs[key]['draws'])})")
        gen_note = "" if draws is None else (
            f"inits drawn as the unsharded run's ({len(draws)} draws); ")
        if tokens is not None:
            n = check_generated(key, tokens, refs[key]["toks"], got_toks,
                                parts)
            gen_note += (f"sharded generate equal to the unsharded tokens "
                        f"up to each row's first parting ({n} tokens); ")
        device_ms, launches, _, heavy = profile_steps(torch, step_fn)
        coll = collective_ms(torch, mesh, axis, calls)
        steady = sorted(steps_ms)
        lines.append(
            f"{key}: lockstep vs unsharded over {len(got_logits)} positions "
            f"max|diff|/max|ref| {worst:.3e} (limit {LOCKSTEP_LIMIT}), greedy "
            f"agreement {agree:.3f}, partings {len(parts)}: within the "
            f"row's largest error {len(ties)}, at the top two of both runs "
            f"{len(tops)}; {gen_note}"
            f"device_ms_per_step={device_ms:.2f} "
            f"device_launches_per_step={launches:.0f} "
            f"collective_ms_per_step={coll:.2f} ({len(calls)} all_reduce "
            f"alone) median_step_ms={steady[len(steady) // 2]:.2f} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
            f"heaviest: {heavy} [{card}; {PARALLEL_NOTE}]")
        log(lines[-1])

    # 1. tensor parallelism, Llama-2-7B at full width (8 layers), GEARL int4
    params = llama.init_params(llama_cut, seed=0)
    prompts = parallel_prompts(llama_cut.vocab_size, TP_PROMPTS)
    hid, vocab = llama_cut.hidden_size, llama_cut.vocab_size
    tp_calls = [((4, 1, hid), "sum")] * (2 * n_l) + [((4, vocab), "sum")]
    for mode in ("fused", "raw"):
        torch.cuda.reset_peak_memory_stats()
        lm = GearLM(cfg=llama_cut, params=params,
                    comp=parallel_comp(llama_cut, "GEARL", 4),
                    engine_cfg=EngineConfig(max_len=1152, mode=mode),
                    batch_size=4).shard(tp)
        kernels.reset_launch_counts()
        toks = lm.generate(prompts, 80)  # the main path
        c = kernels.launch_counts()
        out["counts"][f"tp {mode}"] = c
        kern = "decode_attention" if mode == "fused" else "flash_decode"
        other = "flash_decode" if mode == "fused" else "decode_attention"
        check(c[kern] == n_l * 79 and c[other] == 0,
              f"tp {mode}: the rank launched its kernel a layer a step")
        check(c["quant_pack_channels"] == c["quant_pack_tokens"] ==
              (n_l if mode == "fused" else 0),
              f"tp {mode}: the packs once a layer in the prefill")
        eng, times, draws = lm.engine, [], []
        check(eng.spec.num_kv_heads == 16, "tp: 16 kv heads a rank")
        got_toks, got, state = lockstep_run(
            torch, eng, prompts, 79, feed=refs[f"tp {mode}"]["toks"],
            times=times, draws=draws)
        if mode == "fused":  # B1 on layer 0's local cache
            gen = torch.Generator(device="cuda").manual_seed(30 + rank)
            q = torch.randn((4, 16, 1, 128), generator=gen, device="cuda")
            lc = state["caches"].layer(0)
            a = TK.attend_fused(eng.spec, lc, q, pad_start=state["pad"])
            b = TC.attend(eng.spec, lc, q, pad_start=state["pad"])
            out["b1_err"] = float((a - b).abs().max())
            check(torch.allclose(a, b, **TOL_DECODE),
                  "tp: B1 on the rank's 16 kv heads within tolerance")
        held(f"tp {mode}", got, times, continue_steps(eng, state, torch),
             tp, "model", tp_calls, got_toks=got_toks, tokens=toks,
             draws=draws)
        del lm, eng, state

    # 2. sequence parallelism: 2 time shards of 4,096 tokens, batch 1
    torch.cuda.reset_peak_memory_stats()
    sprompt = parallel_prompts(vocab, [SEQ_PROMPT])
    eng = parallel_engine(llama_cut, params, "GEARL", 1,
                          SEQ_MAX_LEN).shard_seq(seq)
    kernels.reset_launch_counts()
    toks = eng.generate(sprompt, 80)  # the main path
    out["counts"]["seq"] = c = kernels.launch_counts()
    check(c["quant_pack_tokens"] == n_l and c["decode_attention"] == 0,
          "seq: the whole prefill packs once a layer; the sharded decode "
          "attends through the plain partials")
    times, draws = [], []
    got_toks, got, state = lockstep_run(torch, eng, sprompt, 79,
                                        feed=refs["seq"]["toks"], times=times,
                                        draws=draws)
    check(state["caches"].comp_len == (3968 if rank == 1 else 4096),
          "seq: the flush landed on the last shard")
    held("seq", got, times, continue_steps(eng, state, torch), seq, "seq",
         [((1, 32, 1), "max"), ((1, 32, 1, 129), "sum")] * n_l,
         got_toks=got_toks, tokens=toks, draws=draws)
    del eng, state, params
    torch.cuda.empty_cache()

    # 3. Mistral-7B at TP 2: B1 at 4 kv heads a rank, GQ 4, the window
    torch.cuda.reset_peak_memory_stats()
    mcut = dataclasses.replace(mistral.mistral_7b(), num_layers=EARLIER_DEPTH)
    params = llama.init_params(mcut, seed=0)
    lm = GearLM(cfg=mcut, params=params, comp=parallel_comp(mcut, "GEAR", 4),
                engine_cfg=EngineConfig(max_len=MISTRAL_MAX_LEN),
                batch_size=2).shard(tp)
    check(lm.engine.spec.num_kv_heads == 4, "tp mistral: 4 kv heads a rank")
    mprompts = parallel_prompts(mcut.vocab_size, MISTRAL_PROMPTS)
    kernels.reset_launch_counts()
    toks = lm.generate(mprompts, MISTRAL_STEPS + 1)  # the main path
    out["counts"]["tp mistral"] = c = kernels.launch_counts()
    check(c["decode_attention"] == n_l * MISTRAL_STEPS,
          "tp mistral: B1 a layer a step")
    times, draws = [], []
    got_toks, got, state = lockstep_run(
        torch, lm.engine, mprompts, MISTRAL_STEPS,
        feed=refs["tp mistral"]["toks"], times=times, draws=draws)
    lines.append(f"tp mistral: Mistral-7B GEAR int4 (8 layers, window 4096) "
                 f"at TP 2, batch 2, prompts {MISTRAL_PROMPTS}, "
                 f"{MISTRAL_STEPS + 1} tokens: launches {c}")
    held("tp mistral", got, times, continue_steps(lm.engine, state, torch),
         tp, "model", [((2, 1, mcut.hidden_size), "sum")] * (2 * n_l)
         + [((2, mcut.vocab_size), "sum")], got_toks=got_toks, tokens=toks,
         draws=draws)
    del lm, params, state
    torch.cuda.empty_cache()

    # 4. expert parallelism: Mixtral-8x7B, 4 of 8 experts a rank
    torch.cuda.reset_peak_memory_stats()
    mcfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                               num_layers=MIXTRAL_EP_DEPTH)
    params = mixtral.shard_experts(ep, mixtral.init_params(mcfg, seed=0))
    torch.cuda.empty_cache()
    lp = llama._layer_slice(params["layers"], 0)
    x = refs["moe"]["x"].cuda()
    want = refs["moe"]["out"].cuda()
    got = mixtral.moe_block_ep(x, lp["router"], lp["wg"], lp["wu"], lp["wd"],
                               mcfg.experts_per_token, ep)
    moe_err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=5e-2, atol=5e-3),
          "ep: moe_block_ep equals moe_block (rtol 5e-2, atol 5e-3)")
    del lp, got
    kernels.reset_launch_counts()
    times = []
    got_toks, got, ep_step = mixtral_lockstep(
        torch, mcfg, params, refs["ep"]["toks"], ep_mesh=ep, times=times)
    out["counts"]["ep"] = c = kernels.launch_counts()
    check(c["decode_attention"] == MIXTRAL_EP_DEPTH * EP_STEPS
          and c["quant_pack_tokens"] == MIXTRAL_EP_DEPTH,
          "ep: B1 a layer a step, the packs once a layer")
    lines.append(f"ep: moe_block_ep vs moe_block on [2, 64, 4096] bf16, "
                 f"layer 0: max|diff| {moe_err:.3e} (rtol 5e-2, atol 5e-3); "
                 f"launches {c}")
    held("ep", got, times, ep_step, ep, "expert",
         [((2, 1, mcfg.hidden_size), "sum")] * MIXTRAL_EP_DEPTH)
    (OUT / f"parallel_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    check(not failed, "parallel lockstep: " + "; ".join(failed))
    return 0


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of phase_parallel
        return parallel_rank(*sys.argv[2:4])
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
    # the earlier slices' 7B paths at full width and a cut depth, so that the
    # whole script stays near five minutes; h2o / sink keep all 32 layers
    llama_cut = dataclasses.replace(llama_cfg, num_layers=EARLIER_DEPTH)
    mistral_cut = dataclasses.replace(mistral.mistral_7b(),
                                      num_layers=EARLIER_DEPTH)
    phases = {
        "pack": lambda: phase_pack(torch, timer, record),
        "flush": lambda: phase_flush(torch, timer, record),
        "decode": lambda: phase_decode(torch, timer, record),
        "flash": lambda: phase_flash(torch, timer, record),
        # the Mistral-7B path (GQA, window 4096): the full GEAR
        # recipe, prompts past the window so that it binds from step one
        "e2e mistral": lambda: counts.update(mistral=phase_e2e(
            torch, "Mistral-7B", mistral_cut, "GEAR", 2, [4300, 4210], 80,
            4480, "of 32")),
        # the Llama-2-7B path: GEARL, raw mode on the flash kernel
        "e2e llama": lambda: counts.update(llama=phase_e2e(
            torch, "Llama-2-7B", llama_cut, "GEARL", 4,
            [1000, 1024, 977, 1011], 80, 1152, "of 32")),
        # the simulated mode's path (the accuracy path): raw cache, prompt
        # and cache recompressed by fake quantization, the flash kernel
        "e2e simulated": lambda: counts.update(
            simulated={"simulated": phase_simulated(torch, llama_cut)}),
        "small gearl": lambda: phase_small(torch, "GEARL"),
        "small gear": lambda: phase_small(torch, "GEAR"),
        "paged": lambda: phase_paged(torch, timer, record),
        # the paged slice's path: continuous batching over the page pool
        "e2e serving": lambda: counts.update(
            serving={"paged": phase_serving(torch, llama_cut, timer,
                                            record)}),
        "small serving": lambda: phase_small_serving(torch),
        # the evaluation slice: its kernels' shapes, the accuracy protocol
        # on the mid-scale checkpoint, training, and engine modes h2o and
        # sink
        "eval kernels": lambda: phase_eval_kernels(torch, timer, record),
        "eval": lambda: phase_eval(torch, counts),
        "train": lambda: phase_train(torch),
        "e2e h2o sink": lambda: phase_evict(torch, llama_cfg),
        "small h2o sink": lambda: phase_small_evict(torch),
        # the Mixtral slice: a sparse MoE over the compressed cache at int2
        # and ~8k context, with a KV snapshot and resume mid-decode
        "e2e mixtral": lambda: counts.update(mixtral=phase_mixtral(
            torch, timer, record)),
        "small mixtral": lambda: (phase_small(torch, "GEARL", "mixtral"),
                                  phase_small(torch, "GEAR", "mixtral")),
        # the parallel slice: tensor, sequence and expert parallelism as
        # two gloo ranks on the card, held against the unsharded port
        "parallel": lambda: phase_parallel(torch, record, counts,
                                           llama_cut),
    }
    for name, run in phases.items():
        t0 = time.perf_counter()
        run()
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
        ("decode_attention_eval", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "eval", "fused GEARL-int4"),
        ("decode_attention_eval_gear", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "eval", "fused GEAR-int4"),
        ("quant_pack_channels_eval", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "eval", "fused GEARL-int4"),
        ("quant_pack_tokens_eval", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "eval", "fused GEARL-int4"),
        ("flash_decode_eval", "flash_decode", "gear_tpu_torch/csrc/flash.cu",
         "gear_tpu/kernels/flash.py:32", "eval", "simulated"),
        ("flash_decode_eval_d32", "flash_decode",
         "gear_tpu_torch/csrc/flash.cu", "gear_tpu/kernels/flash.py:32",
         "eval_cli", "simulated"),
        ("decode_attention_mixtral", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "mixtral", "fused"),
        ("quant_pack_channels_mixtral", "quant_pack_channels",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:90",
         "mixtral", "fused"),
        ("quant_pack_tokens_mixtral", "quant_pack_tokens",
         "gear_tpu_torch/csrc/pack.cu", "gear_tpu/kernels/pack.py:67",
         "mixtral", "fused"),
        ("flash_decode_mixtral", "flash_decode",
         "gear_tpu_torch/csrc/flash.cu", "gear_tpu/kernels/flash.py:32",
         "mixtral", "raw"),
        ("decode_attention_tp", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "tp", "fused"),
        ("flush", "flush", "gear_tpu_torch/csrc/flush.cu",
         "none: gear_tpu/cache.py:796 _flush is jitted XLA", "mistral",
         "fused"),
        ("flush_mixtral", "flush", "gear_tpu_torch/csrc/flush.cu",
         "none: gear_tpu/cache.py:796 _flush is jitted XLA", "mixtral",
         "fused"),
        ("decode_attention_tp_mistral", "decode_attention",
         "gear_tpu_torch/csrc/decode.cu", "gear_tpu/kernels/decode.py:132",
         "tp_mistral", "fused"),
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
