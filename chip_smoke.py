#!/usr/bin/env python3
"""Smoke run of gear_tpu_torch (the PyTorch/CUDA port) on one CUDA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printing lines of its own:
  1. the card (nvidia-smi name and power limit) and the kernels' build time;
  2. the pack kernels against their plain versions at Llama-2-7B shapes
     (B=4, H=32, D=128, S=2048, group 64, v_group 64, bits 2/4/8): words,
     scales and minima must be bit-equal;
  3. the decode kernel against the plain ``cache.attend`` on full-width
     caches built by the port's own prefill + append across a flush (bits
     2/4/8, GQA 32/8 heads, left padding with a partly filled residual);
  4. end to end through ``GearLM``: Llama-2-7B width and depth with seeded
     random weights, GEARL int4 (group 64, rank 2, prefill rank 4, loop 3),
     batch 4, prompts of ~1,000 tokens, 80 new tokens, in ``fused`` and
     ``raw`` mode, plus int8 fused vs raw greedy agreement;
  5. a small model in fused mode, decoding in lockstep on the card (kernels)
     and on the CPU (plain path) from one prefill: the logits must agree.

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

    def events(self, fn, iters: int = 20) -> float:
        """Mean ms per call from CUDA events around back-to-back calls (L2
        warm): for a library call whose kernels the profiler may not see."""
        torch = self.torch
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_pack(torch, timer, record):
    from gear_tpu_torch.kernels import pack as TP

    n, s, d, g = 4 * 32, 2048, 128, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((n, s, d), generator=gen, device="cuda")
    for bits in (2, 4, 8):
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
                      f"{kern.__name__} bits={bits} bit-equal to plain")
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got, want))
            ms = timer(lambda: kern(x, bits=bits, **kw), names=(
                "token_kernel" if kern is TP.quant_pack_tokens
                else "channel_kernel",))
            plain_ms = timer(lambda: plain(x, bits=bits, **kw), iters=5)
            nbytes = x.numel() * 4 + n * s * wd * 4 + 2 * side * 4
            bms, by = bound_ms(nbytes, 8 * x.numel())
            log(f"pack {kern.__name__} bits={bits} [{n}x{s}x{d}] bit-equal "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bms:.4f} ({by})")
            if bits == 4:
                record[kern.__name__] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)


def phase_decode(torch, timer, record):
    import torch.nn.functional as F

    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.kernels import decode as TK

    b, d, t, g = 4, 128, 2048, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [  # (bits, kv heads, q heads, pad_start)
        (2, 32, 32, None), (4, 32, 32, None), (8, 32, 32, None),
        (4, 8, 32, None), (4, 32, 32, [0, 100, 257, 1000])]
    for bits, hkv, hq, pad in cases:
        spec = TC.CacheSpec(batch=b, num_kv_heads=hkv, head_dim=d,
                            max_len=t, bits=bits, group=g, rank=2,
                            prefill_rank=4, lowrank_loop=3)
        shape = (b, hkv, 1900, d)  # 1856 compressed + 44 residual
        k = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        v = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        cache = TC.prefill(spec, k, v, generator=gen)
        for _ in range(30):  # one flush (comp 1920), 10 residual tokens
            kn = torch.randn((b, hkv, 1, d), generator=gen, device="cuda")
            vn = torch.randn((b, hkv, 1, d), generator=gen, device="cuda")
            TC.append(spec, cache, kn.bfloat16(), vn.bfloat16(), generator=gen)
        check(cache.comp_len == 1920 and cache.resid_len == 10,
              "decode cache lengths")
        q = torch.randn((b, hq, 1, d), generator=gen, device="cuda")
        gq = hq // hkv
        pad_t = None if pad is None else torch.tensor(
            pad, dtype=torch.int32, device="cuda")
        got = TK.attend_fused(spec, cache, q, pad_start=pad_t)
        want = TC.attend(spec, cache, q, pad_start=pad_t)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-6)).max())
        check(bool(torch.isfinite(got).all()), "decode output finite")
        ok = torch.allclose(got, want, **TOL_DECODE)
        ms = timer(lambda: TK.attend_fused(spec, cache, q, pad_start=pad_t),
                   names=("decode_split_kernel", "decode_merge_kernel"))
        plain_ms = timer(lambda: TC.attend(spec, cache, q, pad_start=pad_t),
                         iters=5)
        bh, r, c, rl = b * hkv, spec.r_store, cache.comp_len, cache.resid_len
        # distinct P bases: the prefill's blocks all hold one copy of its P
        n_p = (cache.prefill_len > 0) + (c - cache.prefill_len) // g
        nbytes = (2 * bh * spec.v_words * c * 4           # K, V codes
                  + 2 * bh * (c // g) * d * 2             # K scale, mn
                  + 2 * bh * spec.v_groups_per_token * c * 2  # V scale, mn
                  + 2 * bh * r * c * 2                    # kqt, vqt
                  + 2 * bh * n_p * r * d * 2              # kpt, vpt
                  + 2 * bh * rl * d * 2                   # residual tier
                  + 2 * bh * gq * d * 4)                  # q in, out
        ops = bh * gq * (c * (4 * d + 4 * r) + rl * 4 * d)
        bms, by = bound_ms(nbytes, ops)
        kr = torch.randn((b, hkv, c + rl, d), generator=gen,
                         device="cuda").bfloat16().repeat_interleave(gq, 1)
        qs = q.bfloat16()
        sdpa_ms = timer.events(
            lambda: F.scaled_dot_product_attention(qs, kr, kr))
        log(f"decode bits={bits} hkv={hkv} hq={hq} pad={pad} comp={c} "
            f"resid={rl} max_abs_err={err:.3e} max_rel_err={rel:.3e} "
            f"tol(rtol={TOL_DECODE['rtol']}, atol={TOL_DECODE['atol']}) "
            f"{'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"| reference only, not the same function: SDPA over a bf16 raw "
            f"cache of {c + rl} tokens {sdpa_ms:.4f} ms (CUDA events, "
            f"back-to-back calls, L2 warm)")
        check(ok, f"decode kernel within tolerance (bits={bits} hkv={hkv} "
                  f"pad={pad})")
        if bits == 4 and hkv == 32 and pad is None:
            record["decode_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)
        else:
            rec = record.setdefault("decode_attention_cases", [])
            rec.append(err)


def phase_e2e(torch, record):
    import numpy as np

    from gear_tpu_torch import kernels
    from gear_tpu_torch.api import GearLM
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig
    from gear_tpu_torch.models import llama

    cfg = llama.ModelConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"e2e model Llama-2-7B width: hidden {cfg.hidden_size}, heads "
        f"{cfg.num_heads}, layers {cfg.num_layers} (depth not cut), "
        f"{cfg.dtype}; random init {time.perf_counter() - t0:.1f} s")
    batch, n_new, max_len = 4, 80, 1152
    rng = np.random.default_rng(0)
    lens = [1000, 1024, 977, 1011]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]

    def lm_for(mode, bits):
        comp = CompressionConfig(num_layers=cfg.num_layers,
                                 compress_method="GEARL", quantize_bit=bits,
                                 group_size=64, rank=2, prefill_rank=4,
                                 loop=3)
        return GearLM(cfg=cfg, params=params, comp=comp,
                      engine_cfg=EngineConfig(max_len=max_len, mode=mode),
                      batch_size=batch)

    results = {}
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
        if mode == "fused":
            kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.generate(prompts, n_new)  # the main path
        total_ms = (time.perf_counter() - t0) * 1e3
        if mode == "fused":
            counts = kernels.launch_counts()
        check(len(out) == batch and all(len(o) == n_new for o in out),
              f"{mode} output shape")
        check(all(0 <= x < cfg.vocab_size for o in out for x in o),
              f"{mode} tokens in range")
        steps = n_new - 1
        step_ms = (total_ms - prefill_ms) / steps
        results[mode] = out
        spec = eng.spec
        kv = (spec.bytes_compressed() if mode == "fused"
              else spec.bytes_fp16_baseline()) * cfg.num_layers
        log(f"e2e {mode}: prefill_ms={prefill_ms:.1f} "
            f"per_step_ms={step_ms:.2f} tokens_per_s={batch / step_ms * 1e3:.1f} "
            f"generate_ms={total_ms:.1f} kv_bytes={kv} "
            f"(bf16 baseline {spec.bytes_fp16_baseline() * cfg.num_layers})")
        del lm, eng

    log(f"e2e launch counts on the fused main path: {counts}")
    check(counts["decode_attention"] == cfg.num_layers * steps,
          "decode kernel launched layers x decode steps")
    check(counts["quant_pack_tokens"] == cfg.num_layers
          and counts["quant_pack_channels"] == cfg.num_layers,
          "pack kernels launched once per layer per prefill")
    for name in ("decode_attention", "quant_pack_tokens",
                 "quant_pack_channels"):
        record[name]["launches"] = counts[name]

    horizon = 12
    fused8 = lm_for("fused", 8).generate(prompts, horizon)
    agree = float(np.mean([a == b for rf, rr in zip(fused8, results["raw"])
                           for a, b in zip(rf, rr[:horizon])]))
    log(f"e2e int8 fused vs raw greedy agreement over {horizon} tokens: "
        f"{agree:.3f}")


def phase_small(torch):
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
                             compress_method="GEARL", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=3)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=128, mode="fused"), batch_size=2)

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
    log(f"small model, fused: card (kernels) vs CPU (plain path) over 20 "
        f"decode steps, max |logit diff| / max |logit| = {worst:.3e} "
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

    timer = Timer(torch)
    record: dict = {}
    phases = {"pack": lambda: phase_pack(torch, timer, record),
              "decode": lambda: phase_decode(torch, timer, record),
              "e2e": lambda: phase_e2e(torch, record),
              "small": lambda: phase_small(torch)}
    for name in phases:
        t0 = time.perf_counter()
        phases[name]()
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")

    info = {
        "decode_attention": ("gear_tpu_torch/csrc/decode.cu",
                             "gear_tpu/kernels/decode.py:132"),
        "quant_pack_channels": ("gear_tpu_torch/csrc/pack.cu",
                                "gear_tpu/kernels/pack.py:90"),
        "quant_pack_tokens": ("gear_tpu_torch/csrc/pack.cu",
                              "gear_tpu/kernels/pack.py:67"),
    }
    cases = record.pop("decode_attention_cases", [])
    if "decode_attention" in record and cases:
        record["decode_attention"]["max_abs_err"] = max(
            [record["decode_attention"]["max_abs_err"], *cases])
    kern = []
    for name, (src, rep) in info.items():
        if name not in record:
            continue
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": None, **record[name]})
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
