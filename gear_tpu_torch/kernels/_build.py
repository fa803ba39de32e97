"""Build the port's CUDA kernels and bind them with ctypes.

The sources under ``gear_tpu_torch/csrc/`` have a plain C interface. At first
use they are compiled for Hopper (``sm_90a``), one ``nvcc`` process per
unit (a source, or ``decode.cu`` once per code width and form: dense cache
or page pool), all started together,
and linked into one shared library under ``gear_tpu_torch/_build/`` (listed
in ``.gitignore``). The library's name
carries a hash of the sources, so an edited source is rebuilt. Nothing here
runs at import time: the CPU tests import every module on a machine with no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
DECODE_BITS = (2, 4, 8)
# (source, extra flags, object name): decode.cu holds 8 instantiations per
# code width and form (dense cache, page pool) and takes the longest, so each
# width and form is a unit of its own
UNITS = (("pack.cu", (), "pack.o"), ("flash.cu", (), "flash.o"),
         ("flush.cu", (), "flush.o")) + tuple(
    ("decode.cu", (f"-DGEAR_DECODE_BITS={b}", f"-DGEAR_DECODE_PAGED={p}"),
     f"decode{'_paged' if p else ''}_b{b}.o")
    for b in DECODE_BITS for p in (0, 1))
FILES = ("pack.cu", "decode.cu", "flash.cu", "flush.cu", "attn_common.cuh",
         "quant_common.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never truncates them to 32 bits).
SIGNATURES = {
    "gear_quant_pack_tokens": [_P, _I, _P, _P, _P, _I64, _I, _I, _I, _P],
    "gear_quant_pack_channels": [_P, _I, _P, _P, _P, _I64, _I, _I64, _I64,
                                 _I64, _I64, _I, _I, _I, _P],
    **{f"gear_decode_attention{form}_b{b}": [_P] * 29 + [_I] * 17 + [_P]
       for b in DECODE_BITS for form in ("", "_paged")},
    "gear_flash_decode": [_P] * 8 + [_I] * 7 + [_P],
    "gear_flush": [_P] * 24 + [_I] * 16 + [_P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of gear_tpu_torch are built on first use")


def _source_tag() -> str:
    h = hashlib.sha256()
    for name in FILES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile (if needed) -> (path of the shared library, compiler log,
    kept beside the library for later callers)."""
    so = BUILD_DIR / f"libgear_kernels_{_source_tag()}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        return so, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src, flags, obj_name in UNITS:
            name, obj = obj_name[:-2], Path(tmp) / obj_name
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / src), "-o",
                   str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log_path.write_text(log)
        os.replace(tmp_so, so)  # atomic: concurrent builders never see half a file
    return so, log


_TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def _template_args(mangled: str) -> list[str]:
    """The template arguments of a mangled kernel name after its ``I``:
    integer and bool literals (``Li4E``, ``Lb0E``) as their values, the
    input types of the pack kernel (``f``, ``13__nv_bfloat16``) by name."""
    args, i = [], 1
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":
            end = mangled.index("E", i)
            args.append(mangled[i + 2:end])
            i = end + 1
        elif mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group()
            key = n + mangled[i + len(n):i + len(n) + int(n)]
            args.append(_TYPES.get(key, key[len(n):]))
            i += len(key)
        else:
            args.append(_TYPES.get(mangled[i], mangled[i]))
            i += 1
    return args


def ptxas_usage(log: str) -> dict[str, tuple[int, int, int]]:
    """Registers a thread, spill stores and spill loads (bytes) of every
    kernel in a build log (``ptxas -v``), by name with its template
    arguments, e.g. ``decode_split_kernel<4,1,0,1>`` (bits, GQ, int8 bases,
    paged), ``flash_split_kernel<4>`` (GQ), ``token_kernel<bf16,4,1>``
    (input type, bits, groups on lane boundaries),
    ``channel_kernel<float,4>`` (input type, bits) or
    ``flush_kernel<4,1,0>`` (bits, outliers, int8 bases)."""
    usage, cur, spill = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = re.search(r"\d([a-z][a-z_]*?_kernel)(I.*)?", m.group(1))
            args = _template_args(name.group(2)) if name.group(2) else []
            cur = name.group(1) + (f"<{','.join(args)}>" if args else "")
            spill = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            usage[cur] = (int(m.group(1)), *spill)
            cur = None
    return usage


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
