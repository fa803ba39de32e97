"""bf16 flash-decode attention over the raw (uncompressed) KV cache (CUDA,
sm_90a).

Port of ``gear_tpu/kernels/flash.py``: the Pallas ``_flash_kernel`` becomes
``csrc/flash.cu``. Two roles, as in the reference: the attention of the
engine's ``raw`` mode (the bf16 baseline that fused mode is measured
against), and the like-for-like baseline of the compressed decode kernel
(``kernels.decode``): same split-and-merge structure, no codes.

:func:`raw_attend_flash` is the drop-in for ``models.llama.raw_attend``: on a
CPU tensor it computes that plain version; on a CUDA tensor it launches the
kernel through :func:`flash_decode`, or raises.

Bound on the card: bytes. The K and V rows between ``pad_start`` and
``length`` are read once (2 x 2 x D bytes per token and kv head). A block
keeps its next K or V rows in flight while it computes (a ring of two
half-tiles, ``csrc/flash.cu``); :func:`flash_decode` plans the token splits
for ``BLOCKS_PER_SM`` such blocks on each SM.
"""
from __future__ import annotations

import torch

from . import _build
from . import decode as _dec

BLOCKS_PER_SM = 3   # token splits aim at this many blocks per SM: what a
                    # block's ring of two half-tiles lets fit
SLOTS = 2           # half-tiles (K or V rows of 128 tokens) in a block's ring
ROW_PAD = 8         # bf16 of padding per staged row


def flash_smem_bytes(gq: int, d: int) -> int:
    """Shared memory of one block of the flash kernel: the ring of SLOTS
    half-tiles of padded rows, q, p and the softmax scratch
    (csrc/flash.cu ``flash_smem_bytes``, which checks this count)."""
    return (SLOTS * _dec.TILE * (d + ROW_PAD) * 2 + gq * d * 4
            + gq * _dec.TILE * 4 + 2 * gq * 4 * 4)


def flash_decode(length: int, pad_start: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the flash-decode kernel.

    ``length``: valid tokens (a host int); pad_start int32 [BH], the first
    attended token per row; q [BH, GQ, D] f32 with sm_scale folded in (GQ in
    1, 2, 4, 8); k, v bf16 [BH, T, D] (D <= 128, a multiple of 8).
    Returns the normalised output [BH, GQ, D] f32; rows with no attended
    token come back zero.
    """
    bh, gq, d = q.shape
    t = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode needs CUDA tensors, got {dev}")
    _dec.check_operands(dev, {
        "q": (q, torch.float32, (bh, gq, d)),
        "k": (k, torch.bfloat16, (bh, t, d)),
        "v": (v, torch.bfloat16, (bh, t, d)),
        "pad_start": (pad_start, torch.int32, (bh,)),
    })
    _dec.check_aligned({"k": k, "v": v})
    if gq not in _dec.GQ_SIZES or d > _dec.TILE or d % 8:
        raise ValueError(f"unsupported GQ={gq} / head_dim={d}")
    if not 0 <= length <= t:
        raise ValueError(f"length {length} outside the cache of {t} tokens")
    n_split, per = _dec.splits(length, bh, _dec.sm_count(dev), BLOCKS_PER_SM)
    n_split = max(n_split, 1)
    part_acc = torch.empty((bh, n_split, gq, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((bh, n_split, gq, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((bh, gq, d), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.gear_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_start.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        bh, gq, d, t, length, n_split, per, flash_smem_bytes(gq, d),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gear_flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def raw_attend_flash(spec, c, q: torch.Tensor, *,
                     sm_scale: float | None = None,
                     pad_start: torch.Tensor | None = None,
                     window: int | None = None) -> torch.Tensor:
    """Drop-in for ``models.llama.raw_attend``: q [B, Hq, Qn, D] against the
    RawLayerCache ``c`` -> [B, Hq, Qn, D].

    ``window`` (Mistral's sliding window at decode) folds into ``pad_start``:
    ``pad = max(pad_start, length - window)``. The raw cache has one tier,
    so this is exact. The reference's wrapper has no ``window`` argument: its
    raw mode masks the window in ``raw_attend``; taking it here keeps Mistral
    in raw mode on the kernel.
    """
    if q.device.type == "cpu":
        from ..models import llama

        return llama.raw_attend(spec, c, q, sm_scale=sm_scale,
                                pad_start=pad_start, window=window)
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    qf, gq_n = _dec.pad_query(q, hkv, sm_scale)
    pad = _dec.fold_window(pad_start, window, c.length, b, q.device)
    pad_bh = pad.repeat_interleave(hkv) if hkv > 1 else pad
    bhn = b * hkv
    out = flash_decode(c.length, pad_bh, qf,
                       c.k.reshape(bhn, *c.k.shape[2:]),
                       c.v.reshape(bhn, *c.v.shape[2:]))
    out = out.reshape(b, hkv, -1, d)[:, :, :gq_n]
    return out.reshape(b, hq, qn, d).to(q.dtype)
