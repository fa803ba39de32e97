#!/usr/bin/env python3
"""Time versions of the channel pack kernel (B2) on one card, in turns.

    python3 gear_tpu_torch/tools/ab_pack.py A.cu B.cu [C.cu ...]

Each argument is a version of ``gear_tpu_torch/csrc/pack.cu`` (with this
tree's C interface). All are compiled side by side into shared libraries
under ``gear_tpu_torch/_build/``, and their registers and spills printed
(``ptxas -v``). Then, in the order given and again in reverse (so that
drift of the card shows), each version's ``gear_quant_pack_channels`` is
bound in place of the built library's and timed with ``chip_smoke.Timer``
at the main paths' shapes (Llama-2-7B bf16 K as a strided view and as
float32, Mistral-7B and a serving admission on outlier-cleaned float32
blocks) and at int2 / int8; every output is held bit-equal to the plain
version first. Prints one line per case with each version's two times.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# (name, (batch, kv heads, tokens), bits, outlier-cleaned, input type)
CASES = (
    ("llama bf16", (4, 32, 1024), 4, False, "bfloat16"),
    ("llama f32", (4, 32, 1024), 4, False, "float32"),
    ("mistral", (2, 8, 4352), 4, True, "float32"),
    ("serving", (1, 32, 3008), 4, True, "float32"),
    ("int2 f32", (4, 32, 2048), 2, False, "float32"),
    ("int8 f32", (4, 32, 2048), 8, False, "float32"),
    ("int2 bf16", (4, 32, 1024), 2, False, "bfloat16"),
    ("int8 bf16", (4, 32, 1024), 8, False, "bfloat16"),
)


def build(sources):
    """Compile every source at once -> {source: loaded library}."""
    from gear_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        so = _build.BUILD_DIR / f"ab_pack_{i}.so"
        procs.append((src, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", src, "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for src, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        usage = {k: v for k, v in _build.ptxas_usage(out).items()
                 if k.startswith("channel_kernel")}
        print(src, "(registers, spill stores, spill loads):", usage,
              flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.gear_quant_pack_channels
        fn.argtypes = _build.SIGNATURES["gear_quant_pack_channels"]
        fn.restype = ctypes.c_int
        libs[src] = lib
    return libs


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import chip_smoke as cs
    from gear_tpu_torch.kernels import _build
    from gear_tpu_torch.kernels import pack as TP

    if not torch.cuda.is_available():
        print("ab_pack: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    sources = sys.argv[1:]
    libs = build(sources)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for name, (b, h, s), bits, cleaned, dtype in CASES:
        x = torch.randn((b * h, s, 128), generator=gen, device="cuda")
        x = x.bfloat16().float()
        if cleaned:
            x = cs.cleaned_blocks(torch, x, h)
        x = x.to(getattr(torch, dtype))
        if dtype == "bfloat16":  # the model's K: [B, H, S, D] over [B, S, H, D]
            x = x.reshape(b, h, s, 128).transpose(1, 2).contiguous()
            x = x.transpose(1, 2)
        want = TP.quant_pack_channels_plain(x, bits=bits, group=64)
        cases.append((name, x, bits, want))
    times = {}
    for src in sources + sources[::-1]:
        _build.library = lambda lib=libs[src]: lib
        for name, x, bits, want in cases:
            got = TP.quant_pack_channels(x, bits=bits, group=64)
            torch.cuda.synchronize()
            cs.check(all(torch.equal(a, w) for a, w in zip(got, want)),
                     f"{src} {name}: bit-equal to the plain version")
            ms = timer(lambda: TP.quant_pack_channels(x, bits=bits, group=64),
                       names=("channel_kernel",))
            times.setdefault(name, {}).setdefault(src, []).append(ms)
    for name, by_src in times.items():
        print(name, " | ".join(
            f"{Path(src).name} {' '.join(f'{t:.4f}' for t in by_src[src])}"
            for src in sources), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
