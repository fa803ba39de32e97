"""Compressed-KV cache snapshots (checkpoint / resume), PyTorch port of
``gear_tpu/runtime/kvstore.py``.

A cache tree (see ``runtime.tree``) is written as one CRC-framed file,
``[magic u32][len u64][crc u32][payload]``, the payload a JSON header
``{"leaves": [{"dtype", "shape"}, ...]}`` behind its u64 length, then every
leaf's bytes in gear_tpu's flatten order. The file is gear_tpu's file: a
snapshot written by either package loads in the other, and the two write the
same bytes for the same cache. The port's host-int lengths are written as
the int32 leaves gear_tpu writes (``()`` for one layer, ``[L]`` for a
stack). bfloat16 is written as ``"bfloat16"`` and read without ml_dtypes.

The framing and its CRC32 go through ``native/libgearkv.so`` (ctypes, as
built by ``make -C native``) and fall back to the same framing in numpy when
the library is absent or does not load. This is a host codec; the device is
not involved beyond the copies to and from it.
"""
from __future__ import annotations

import ctypes
import functools
import json
import zlib
from pathlib import Path

import numpy as np
import torch

from .tree import walk

_MAGIC = 0x47454152  # "GEAR"


@functools.cache
def _find_lib():
    cand = Path(__file__).resolve().parents[2] / "native" / "libgearkv.so"
    if not cand.exists():
        return None
    try:
        lib = ctypes.CDLL(str(cand))
    except OSError:  # built for another platform
        return None
    lib.gear_crc32.restype = ctypes.c_uint32
    lib.gear_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gear_frame_write.restype = ctypes.c_int
    lib.gear_frame_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.gear_frame_read.restype = ctypes.c_int64
    lib.gear_frame_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    return lib


def native_available() -> bool:
    """Whether the native codec serves the framing (else numpy does)."""
    return _find_lib() is not None


def _write_frame(path: Path, payload: bytes) -> None:
    lib = _find_lib()
    if lib is not None:
        rc = lib.gear_frame_write(str(path).encode(), payload, len(payload), 0)
        if rc != 0:
            raise IOError(f"gear_frame_write failed: {rc}")
        return
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    with open(path, "wb") as f:
        f.write(_MAGIC.to_bytes(4, "little"))
        f.write(len(payload).to_bytes(8, "little"))
        f.write(crc.to_bytes(4, "little"))
        f.write(payload)


def _read_frame(path: Path) -> bytes:
    lib = _find_lib()
    size = path.stat().st_size
    if lib is not None:
        buf = ctypes.create_string_buffer(size)
        n = lib.gear_frame_read(str(path).encode(), 0, buf, size)
        if n < 0:
            raise IOError(f"gear_frame_read failed: {n}")
        return buf.raw[:n]
    with open(path, "rb") as f:
        if int.from_bytes(f.read(4), "little") != _MAGIC:
            raise IOError("bad magic")
        n = int.from_bytes(f.read(8), "little")
        crc = int.from_bytes(f.read(4), "little")
        payload = f.read(n)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise IOError("crc mismatch")
    return payload


def _leaf_bytes(value, layers) -> tuple[dict, bytes]:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ({"dtype": "bfloat16", "shape": list(t.shape)},
                    t.view(torch.int16).numpy().tobytes())
        a = t.numpy()
    else:  # a host-int length
        a = np.full((layers,) if layers is not None else (), value, np.int32)
    return {"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes()


def save_cache(path: str | Path, caches) -> Path:
    """Write a cache tree (one layer or stacked, fused or raw) to one framed
    snapshot file; returns its path."""
    path = Path(path)
    metas, chunks = [], []

    def emit(_path, value, layers):
        meta, data = _leaf_bytes(value, layers)
        metas.append(meta)
        chunks.append(data)
        return value

    walk(caches, emit)
    header = json.dumps({"leaves": metas}).encode()
    _write_frame(path, len(header).to_bytes(8, "little") + header
                 + b"".join(chunks))
    return path


def load_cache(path: str | Path, like):
    """Restore a snapshot into the structure of ``like`` (a tree of the same
    layout, e.g. a fresh ``cache.init_stacked``): every tensor in the
    snapshot's dtype, on the device of ``like``'s tensor in its place.
    Raises ``ValueError`` when the snapshot's leaves do not fit ``like``."""
    payload = _read_frame(Path(path))
    hlen = int.from_bytes(payload[:8], "little")
    metas = json.loads(payload[8:8 + hlen])["leaves"]
    body = memoryview(payload)[8 + hlen:]
    pos = {"leaf": 0, "byte": 0}

    def take(where, ref, layers):
        i = pos["leaf"]
        if i >= len(metas):
            raise ValueError(f"snapshot has {len(metas)} leaves; {where} "
                             "has none left")
        meta = metas[i]
        shape = tuple(meta["shape"])
        bf16 = meta["dtype"] == "bfloat16"
        dt = np.dtype(np.int16 if bf16 else meta["dtype"])
        n = int(np.prod(shape)) * dt.itemsize
        arr = np.frombuffer(body[pos["byte"]:pos["byte"] + n], dtype=dt)
        pos["leaf"], pos["byte"] = i + 1, pos["byte"] + n
        if isinstance(ref, torch.Tensor):
            if shape != tuple(ref.shape):
                raise ValueError(f"{where}: snapshot shape {shape}, expected "
                                 f"{tuple(ref.shape)}")
            t = torch.from_numpy(arr.reshape(shape).copy())
            return (t.view(torch.bfloat16) if bf16 else t).to(ref.device)
        want = (layers,) if layers is not None else ()
        if shape != want or len(set(arr.tolist())) > 1:
            raise ValueError(f"{where}: lengths {arr.tolist()} of shape "
                             f"{shape}; the port keeps one length of shape "
                             f"{want}")
        return int(arr.reshape(-1)[0])

    out = walk(like, take)
    if pos["leaf"] != len(metas):
        raise ValueError(f"snapshot has {len(metas)} leaves, the structure "
                         f"{pos['leaf']}")
    return out
