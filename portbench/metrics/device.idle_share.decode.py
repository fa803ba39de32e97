"""device.idle_share.decode: the share of the traced stretch of decode
steps in which no device record ran: 1 - (the union of the records'
intervals) / (the stretch's wall time), in percent. Layer: device."""
from __future__ import annotations


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or not t["records"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
