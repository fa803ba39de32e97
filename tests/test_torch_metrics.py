"""The port's copy of the run metrics (``gear_tpu_torch.metrics``) writes
the same TensorBoard event bytes and JSONL mirror as ``gear_tpu.metrics``
for the same scalars, and its CRC32C meets the known vectors of
``tests/test_metrics.py``."""
import json

import pytest

from gear_tpu import metrics as JM
from gear_tpu_torch import metrics as TM


@pytest.mark.parametrize("data,want", [
    (b"\x00" * 32, 0x8A9136AA), (b"", 0), (b"123456789", 0xE3069283),
    (b"a", 0xC1D04330)])
def test_crc32c_known_vectors(data, want):
    assert TM.crc32c(data) == want == JM.crc32c(data)


SCALARS = [("accuracy", 0.25, 3, 1000.5), ("loss/total", -1.5, 4, 1001.0),
           ("accuracy/gsm8k", 0.41, 0, 1002.25), ("big", 1e30, 2 ** 40, 0.0)]


def test_same_event_bytes_as_reference(tmp_path):
    for mod, sub in ((JM, "jax"), (TM, "torch")):
        with mod.ScalarWriter(tmp_path / sub, _ts=1000.0, _host="h") as w:
            for tag, value, step, ts in SCALARS:
                w.scalar(tag, value, step=step, _ts=ts)
    name = "events.out.tfevents.1000.h"
    assert ((tmp_path / "torch" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())
    rows = [json.loads(line) for line in
            (tmp_path / "torch" / "scalars.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in rows] == [
        (t, s) for t, _, s, _ in SCALARS]
    assert ((tmp_path / "torch" / "scalars.jsonl").read_text()
            == (tmp_path / "jax" / "scalars.jsonl").read_text())


def test_records_frame_with_masked_crcs(tmp_path):
    import struct

    with TM.ScalarWriter(tmp_path) as w:
        w.scalar("accuracy/macro", 0.5)
    data = next(tmp_path.glob("events.out.tfevents.*")).read_bytes()
    pos, n = 0, 0
    while pos < len(data):
        (ln,) = struct.unpack_from("<Q", data, pos)
        assert struct.unpack_from("<I", data, pos + 8)[0] == TM._masked_crc(
            data[pos:pos + 8])
        payload = data[pos + 12:pos + 12 + ln]
        assert struct.unpack_from("<I", data, pos + 12 + ln)[0] == \
            TM._masked_crc(payload)
        pos, n = pos + 16 + ln, n + 1
    assert n == 2  # the file version and one scalar
