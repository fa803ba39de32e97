"""comm.bytes_per_step: the bytes rank 0's collectives reduced in a decode
step of the traced stretch, from the program's counter
(``parallel.distributed.collective_counts``: each call's tensor once; a
replayed graph adds its capture's). None where the program counts none.
Layer: collectives."""
from __future__ import annotations


def read(ctx):
    return ctx.get("comm_bytes_per_step")
