"""Run metrics: TensorBoard-compatible scalar event files + JSONL mirror.

A copy of ``gear_tpu/metrics.py`` (which imports no JAX) kept in the port,
so that the port imports nothing of gear_tpu: the same scalars give the
same event bytes in both packages.

The reference logs eval accuracy to TensorBoard (SummaryWriter scalars,
evaluation_gsm8k.py:351,540; per-task in evaluation_bbh_cot.py:441) and
per-run JSON. No tensorboard package is needed: this module writes
the TensorBoard wire format directly — TFRecord framing (length + masked
CRC32C) around hand-encoded ``Event``/``Summary`` protobuf messages — which
any stock TensorBoard install can read. Scalars are also mirrored to a
``scalars.jsonl`` for grepability.

Only the scalar subset is implemented (that is all the reference uses).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import time
from pathlib import Path

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-based — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding for Event{wall_time, step, summary|file_version}.
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = struct.pack("<Bd", 0x09, wall_time)        # field 1, double
    msg += b"\x10" + _varint(step)                   # field 2, int64
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode())              # Value.tag
    val += struct.pack("<Bf", 0x15, value)           # Value.simple_value
    return _field_bytes(1, val)                      # Summary.value (rep.)


class ScalarWriter:
    """Append-only scalar logger: TensorBoard event file + scalars.jsonl.

    >>> w = ScalarWriter(out_dir)
    >>> w.scalar("accuracy", 0.41, step=0)
    >>> w.close()
    """

    def __init__(self, out_dir: str | os.PathLike, *,
                 _ts: float | None = None, _host: str | None = None):
        # _ts/_host: deterministic injection for the golden-bytes test only.
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        ts = time.time() if _ts is None else _ts
        host = (socket.gethostname() or "local") if _host is None else _host
        self._f = open(self.dir / f"events.out.tfevents.{int(ts)}.{host}",
                       "wb")
        self._jsonl = open(self.dir / "scalars.jsonl", "a")
        self._record(_event(ts, 0, file_version="brain.Event:2"))

    def _record(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int = 0,
               *, _ts: float | None = None):
        now = time.time() if _ts is None else _ts
        self._record(_event(now, step, summary=_scalar_summary(tag,
                                                               float(value))))
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": now}) + "\n")

    def flush(self):
        self._f.flush()
        self._jsonl.flush()

    def close(self):
        self.flush()
        self._f.close()
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
