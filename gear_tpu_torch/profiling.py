"""Profiling and roofline accounting; the counterpart of
``gear_tpu/profiling.py``.

``torch.profiler`` trace capture (a Chrome trace, with the card's kernels
when there is one), a timer that reads CUDA events for work on the card and
the host clock for work on the CPU, and an analytic roofline for the fused
decode attention and for the raw bf16 baseline, so that a measured time can
be judged against the card's speed of light.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (host, and the card's kernels when
    CUDA is available); on exit the Chrome trace is written to
    ``log_dir/trace.json`` (chrome://tracing or Perfetto). Yields the
    profiler, whose ``key_averages()`` sum the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def timeit(fn, *args, iters: int = 3, inner: int = 1) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after one
    warm-up, divided by ``inner`` (for calls that loop inside). Where the
    warm-up's output (its first tensor) lies on the card, each call is timed
    by CUDA events around it; elsewhere by the host clock, with no sync."""
    out = _first_tensor(fn(*args))
    cuda = out is not None and out.is_cuda
    if cuda:
        torch.cuda.synchronize(out.device)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / inner)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) / inner)
    return float(np.median(times))


# -- hardware model ---------------------------------------------------------

@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float       # device memory bandwidth, GB/s
    bf16_tflops: float    # dense bf16 tensor-core peak, TFLOP/s
    fp32_tflops: float    # float32 peak outside the tensor cores, TFLOP/s

    def bound_s(self, nbytes: float, fp32_ops: float) -> tuple[float, str]:
        """The least seconds for work that moves ``nbytes`` of device
        memory and does ``fp32_ops`` float32 operations outside the tensor
        cores, and which of the two binds: "bytes" or "operations"."""
        t_bytes = nbytes / (self.hbm_gbps * 1e9)
        t_ops = fp32_ops / (self.fp32_tflops * 1e12)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16
# (without sparsity) and 67 TFLOP/s float32, all at the 700 W power limit.
H100_SXM = ChipSpec("h100_sxm", hbm_gbps=3350.0, bf16_tflops=989.0,
                    fp32_tflops=67.0)


@dataclass
class Roofline:
    bytes_accessed: int
    flops: int
    chip: ChipSpec

    @property
    def mem_time_s(self) -> float:
        return self.bytes_accessed / (self.chip.hbm_gbps * 1e9)

    @property
    def compute_time_s(self) -> float:
        return self.flops / (self.chip.bf16_tflops * 1e12)

    @property
    def sol_time_s(self) -> float:
        return max(self.mem_time_s, self.compute_time_s)

    def efficiency(self, measured_s: float) -> float:
        """Fraction of speed-of-light achieved."""
        return self.sol_time_s / measured_s


def decode_attention_roofline(spec, batch: int, q_heads: int,
                              chip: ChipSpec = H100_SXM) -> Roofline:
    """Roofline for one fused decode-attention step over a full cache.

    Bytes = the compressed cache (read once: the kernel's one-pass
    contract) + q/out; FLOPs = QK^T + PV + low-rank + dequant-fold ops.
    """
    t, d = spec.max_len, spec.head_dim
    h = spec.num_kv_heads
    b = batch
    bytes_accessed = spec.bytes_compressed() + 2 * b * q_heads * d * 4
    flops = 2 * b * q_heads * t * d * 2          # QK^T + PV
    flops += 2 * b * q_heads * t * spec.r_store * 2  # low-rank corrections
    flops += b * h * t * d * 2 * 2               # scale folds
    return Roofline(bytes_accessed, int(flops), chip)


def raw_decode_attention_roofline(spec, batch: int, q_heads: int,
                                  chip: ChipSpec = H100_SXM) -> Roofline:
    """Roofline for one uncompressed bf16 decode-attention step (the
    baseline fused mode is measured against): bytes = the bf16 K+V read
    once + q/out; FLOPs = QK^T + PV."""
    t, d = spec.max_len, spec.head_dim
    b = batch
    bytes_accessed = spec.bytes_fp16_baseline() + 2 * b * q_heads * d * 4
    flops = 2 * b * q_heads * t * d * 2
    return Roofline(bytes_accessed, int(flops), chip)


def report(label: str, measured_s: float, roof: Roofline) -> str:
    eff = roof.efficiency(measured_s)
    return (f"{label}: {measured_s*1e6:.1f} us "
            f"(SoL {roof.sol_time_s*1e6:.1f} us, {eff*100:.0f}% of "
            f"{roof.chip.name} speed-of-light; "
            f"{roof.bytes_accessed/measured_s/1e9:.0f} GB/s effective)")
