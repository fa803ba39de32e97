"""b1.roofline: the dense GEAR decode kernel (``kernels.decode``,
``csrc/decode.cu`` built without ``GEAR_DECODE_PAGED``): its bound a call
over its device time a call in the traced stretch. A call is the split
kernel and its share of the merge kernel it launches. Layer: kernels."""
from __future__ import annotations

from portbench.metrics import _attention

PATTERNS = [r"decode_split_kernel<\s*\d+,\s*\d+,\s*(true|false),\s*false\s*>"]
SHARED = [r"attn_merge_kernel"]


def read(ctx):
    return _attention.roofline(ctx, PATTERNS, SHARED)
