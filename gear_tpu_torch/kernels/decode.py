"""Fused decode attention over the two-tier compressed cache (CUDA, sm_90a).

Port of ``gear_tpu/kernels/decode.py`` for GEARL caches: the Pallas
``_decode_kernel`` becomes ``csrc/decode.cu``. :func:`attend_fused` is the
drop-in for ``cache.attend``; :func:`decode_attention` is the launching
wrapper over flattened ``[BH, ...]`` operands.

On a CPU tensor :func:`attend_fused` computes the plain version,
``gear_tpu_torch.cache.attend``; on a CUDA tensor it launches the kernel, or
raises. The kernel takes bf16 sidebands, bases and residual tier (the model
dtype), head_dim <= 128, ``128 % group == 0`` and GQ = Hq/Hkv <= 8; caches
with COO outliers, int8 bases or a sliding window are a later slice.
"""
from __future__ import annotations

import torch

from .. import cache as kvcache
from . import _build

TILE = 128          # tokens per thread block (csrc/decode.cu kTile)
BLOCKS_PER_SM = 16  # token splits aim at this many blocks per SM
_GQ_SIZES = (1, 2, 4, 8)


def _splits(comp_len: int, bh: int, device) -> tuple[int, int]:
    """(number of token splits, tiles per split): enough blocks for about
    BLOCKS_PER_SM per SM when BH rows alone are too few."""
    n_tiles = -(-comp_len // TILE)
    if n_tiles == 0:
        return 0, 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-BLOCKS_PER_SM * sms // bh))
    n_split = min(n_tiles, want)
    per = -(-n_tiles // n_split)
    return -(-n_tiles // per), per


def decode_attention(q, k_codes, k_scale, k_mn, kpt, kqt, v_codes, v_scale,
                     v_mn, vqt, vpt, k_resid, v_resid, pad_start, *,
                     comp_len: int, resid_len: int, hkv: int, bits: int,
                     group: int, v_group: int) -> torch.Tensor:
    """Launch the decode kernel.

    q [BH, GQ, D] f32 with sm_scale folded in (GQ in 1, 2, 4, 8);
    k/v_codes int32 [BH, D//fpi, T]; k_scale/k_mn bf16 [BH, NB, D];
    v_scale/v_mn bf16 [BH, NGV, T]; kpt/vpt bf16 [BH, NB, R, D];
    kqt/vqt bf16 [BH, R, T]; k/v_resid bf16 [BH, G, D]; pad_start int32 [B]
    (row i of BH belongs to sequence i // hkv).
    Returns the normalised output [BH, GQ, D] f32.
    """
    bh, gq, d = q.shape
    t = k_codes.shape[-1]
    nb, r = kpt.shape[1], kpt.shape[2]
    ngv = d // v_group
    wd = d * bits // 32
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention needs CUDA tensors, got {dev}")
    expect = {
        "q": (q, torch.float32, (bh, gq, d)),
        "k_codes": (k_codes, torch.int32, (bh, wd, t)),
        "k_scale": (k_scale, torch.bfloat16, (bh, nb, d)),
        "k_mn": (k_mn, torch.bfloat16, (bh, nb, d)),
        "kpt": (kpt, torch.bfloat16, (bh, nb, r, d)),
        "kqt": (kqt, torch.bfloat16, (bh, r, t)),
        "v_codes": (v_codes, torch.int32, (bh, wd, t)),
        "v_scale": (v_scale, torch.bfloat16, (bh, ngv, t)),
        "v_mn": (v_mn, torch.bfloat16, (bh, ngv, t)),
        "vqt": (vqt, torch.bfloat16, (bh, r, t)),
        "vpt": (vpt, torch.bfloat16, (bh, nb, r, d)),
        "k_resid": (k_resid, torch.bfloat16, (bh, group, d)),
        "v_resid": (v_resid, torch.bfloat16, (bh, group, d)),
        "pad_start": (pad_start, torch.int32, (bh // hkv,)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bits not in (2, 4, 8) or gq not in _GQ_SIZES or bh % hkv:
        raise ValueError(f"unsupported bits={bits} / GQ={gq} / hkv={hkv}")
    if d > TILE or TILE % group or group > TILE or d % v_group:
        raise ValueError(f"unsupported head_dim={d} / group={group} / "
                         f"v_group={v_group}")
    if not (0 <= comp_len <= t and 0 <= resid_len <= group
            and comp_len % group == 0 and nb * group == t):
        raise ValueError(f"bad lengths comp_len={comp_len} resid_len={resid_len}")

    n_split, per = _splits(comp_len, bh, dev)
    ns = n_split + 1
    part_acc = torch.empty((bh, ns, gq, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((bh, ns, gq, 2), dtype=torch.float32, device=dev)
    out = torch.empty((bh, gq, d), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.gear_decode_attention(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), k_mn.data_ptr(),
        kpt.data_ptr(), kqt.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), vpt.data_ptr(), vqt.data_ptr(), k_resid.data_ptr(),
        v_resid.data_ptr(), pad_start.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(),
        bh, hkv, gq, d, t, nb, r, group, v_group, bits,
        comp_len, resid_len, n_split, per,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gear_decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def attend_fused(spec: kvcache.CacheSpec, cache: kvcache.LayerCache,
                 q: torch.Tensor, *, sm_scale: float | None = None,
                 pad_start: torch.Tensor | None = None,
                 window: int | None = None) -> torch.Tensor:
    """Drop-in for ``cache.attend``: q [B, Hq, Qn, D] -> [B, Hq, Qn, D].

    CPU tensors take the plain version (``cache.attend``); CUDA tensors go
    through :func:`decode_attention`.
    """
    if window is not None:
        raise NotImplementedError(
            "sliding-window decode over the compressed cache is not ported "
            "yet")
    if q.device.type == "cpu":
        return kvcache.attend(spec, cache, q, sm_scale=sm_scale,
                              pad_start=pad_start)
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    gq_n = (hq // hkv) * qn
    gq_pad = next((g for g in _GQ_SIZES if g >= gq_n), None)
    if gq_pad is None:
        raise ValueError(f"{gq_n} query rows per kv head exceed "
                         f"{_GQ_SIZES[-1]}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    bhn = b * hkv
    qf = (q.reshape(b, hkv, gq_n, d).float() * sm_scale)
    if gq_pad != gq_n:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, gq_pad - gq_n))
    if pad_start is None:
        pad = torch.zeros((b,), dtype=torch.int32, device=q.device)
    else:
        pad = pad_start.to(device=q.device, dtype=torch.int32).contiguous()

    def flat(x):
        return x.reshape(bhn, *x.shape[2:])

    out = decode_attention(
        flat(qf).contiguous(), flat(cache.k_codes), flat(cache.k_scale),
        flat(cache.k_mn), flat(cache.kpt), flat(cache.kqt),
        flat(cache.v_codes), flat(cache.v_scale), flat(cache.v_mn),
        flat(cache.vqt), flat(cache.vpt), flat(cache.k_resid),
        flat(cache.v_resid), pad,
        comp_len=cache.comp_len, resid_len=cache.resid_len, hkv=hkv,
        bits=spec.bits, group=spec.group, v_group=spec.v_group)
    out = out.reshape(b, hkv, gq_pad, d)[:, :, :gq_n]
    return out.reshape(b, hq, qn, d).to(q.dtype)
