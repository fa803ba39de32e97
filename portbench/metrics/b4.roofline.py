"""b4.roofline: the bf16 flash-decode kernel of raw mode (``kernels.flash``,
``csrc/flash.cu``): its bound a call
over its device time a call in the traced stretch. A call is the split
kernel and its share of the merge kernel it launches. Layer: kernels."""
from __future__ import annotations

from portbench.metrics import _attention

PATTERNS = [r"flash_split_kernel"]
SHARED = [r"attn_merge_kernel"]


def read(ctx):
    return _attention.roofline(ctx, PATTERNS, SHARED)
