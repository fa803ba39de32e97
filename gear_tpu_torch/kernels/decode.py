"""Fused decode attention over the two-tier compressed cache (CUDA, sm_90a).

Port of ``gear_tpu/kernels/decode.py``: the Pallas ``_decode_kernel`` becomes
``csrc/decode.cu``, with its whole contract (2/4/8-bit codes, K and V
sidebands, bf16 or int8 low-rank bases, sorted COO outliers, the residual
tier, ``pad_start`` and the sliding window). :func:`attend_fused` is the
drop-in for ``cache.attend``; :func:`decode_attention` is the launching
wrapper over flattened ``[BH, ...]`` operands.

On a CPU tensor :func:`attend_fused` computes the plain version,
``gear_tpu_torch.cache.attend``; on a CUDA tensor it launches the kernel, or
raises. The kernel takes bf16 sidebands, residual tier and outlier deltas
(the model dtype), bases in bf16 or int8, head_dim <= 128,
``128 % group == 0`` and GQ = Hq/Hkv <= 8.

Bound on the card: bytes. One call reads the live part of a layer's cache
once; with GEAR's outliers each quant block and tensor adds ``ko_store`` x 4
bytes of entries and a 512-byte boundary table, int8 bases halve the base
bytes and add four f32 scales per (block, rank). ``chip_smoke.py`` counts
these from the call's shapes.

The TPU kernel's ``kcvt`` and ``dual_region`` fast paths (one score product
over the prefill region, whose K scale and P basis are shared by all its
blocks) are speed, not semantics: a KCVT cache stores its whole-span scale
replicated per block row, and the kernel reads it like any other.
"""
from __future__ import annotations

import torch

from .. import cache as kvcache
from . import _build

TILE = 128          # tokens per thread block (csrc/attn_common.cuh kTile)
BLOCKS_PER_SM = 16  # token splits aim at this many blocks per SM
GQ_SIZES = (1, 2, 4, 8)
BND_LANES = 128     # width of an outlier boundary table


def splits(n_tokens: int, bh: int, device) -> tuple[int, int]:
    """(number of token splits, tiles per split): enough blocks for about
    BLOCKS_PER_SM per SM when BH rows alone are too few."""
    n_tiles = -(-n_tokens // TILE)
    if n_tiles == 0:
        return 0, 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-BLOCKS_PER_SM * sms // bh))
    n_split = min(n_tiles, want)
    per = -(-n_tiles // n_split)
    return -(-n_tiles // per), per


def check_operands(dev, expect: dict) -> None:
    """Raise unless every ``name: (tensor, dtype, shape)`` lies on ``dev``,
    contiguous, with that dtype and shape."""
    for name, (x, dtype, shape) in expect.items():
        if x is None:
            raise ValueError(f"{name} is missing")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def decode_attention(q, k_codes, k_scale, k_mn, kpt, kqt, v_codes, v_scale,
                     v_mn, vqt, vpt, k_resid, v_resid, pad_start, *,
                     kpt_scale=None, kqt_scale=None, vqt_scale=None,
                     vpt_scale=None, k_out_idx=None, k_out_val=None,
                     v_out_idx=None, v_out_val=None, k_out_bnd=None,
                     v_out_bnd=None, out_pad: int = 0,
                     comp_len: int, resid_len: int, hkv: int, bits: int,
                     group: int, v_group: int) -> torch.Tensor:
    """Launch the decode kernel.

    q [BH, GQ, D] f32 with sm_scale folded in (GQ in 1, 2, 4, 8);
    k/v_codes int32 [BH, D//fpi, T]; k_scale/k_mn bf16 [BH, NB, D];
    v_scale/v_mn bf16 [BH, NGV, T]; kpt/vpt [BH, NB, R, D] and kqt/vqt
    [BH, R, T], all four bf16 or all four int8; k/v_resid bf16 [BH, G, D];
    pad_start int32 [B] (row i of BH belongs to sequence i // hkv).
    int8 bases need their f32 scales as stored in the cache: kpt/vpt_scale
    [BH, NB, R], kqt/vqt_scale [BH, R, NB]. COO outliers (all six or none):
    k/v_out_idx int32 [BH, NB, KO//2], k/v_out_val bf16 [BH, NB, KO],
    k/v_out_bnd int32 [BH, NB, 128]; ``out_pad`` says how many of the KO
    stored entries of every block are padding (idx 0, delta 0, the last of
    token 0's and channel 0's segments, where ``cache._sort_outliers`` puts
    them): the kernel does not walk them.
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
    base8 = kpt.dtype == torch.int8
    base_dt = torch.int8 if base8 else torch.bfloat16
    expect = {
        "q": (q, torch.float32, (bh, gq, d)),
        "k_codes": (k_codes, torch.int32, (bh, wd, t)),
        "k_scale": (k_scale, torch.bfloat16, (bh, nb, d)),
        "k_mn": (k_mn, torch.bfloat16, (bh, nb, d)),
        "kpt": (kpt, base_dt, (bh, nb, r, d)),
        "kqt": (kqt, base_dt, (bh, r, t)),
        "v_codes": (v_codes, torch.int32, (bh, wd, t)),
        "v_scale": (v_scale, torch.bfloat16, (bh, ngv, t)),
        "v_mn": (v_mn, torch.bfloat16, (bh, ngv, t)),
        "vqt": (vqt, base_dt, (bh, r, t)),
        "vpt": (vpt, base_dt, (bh, nb, r, d)),
        "k_resid": (k_resid, torch.bfloat16, (bh, group, d)),
        "v_resid": (v_resid, torch.bfloat16, (bh, group, d)),
        "pad_start": (pad_start, torch.int32, (bh // hkv,)),
    }
    scales = (kpt_scale, kqt_scale, vqt_scale, vpt_scale)
    if base8:
        expect.update({
            "kpt_scale": (kpt_scale, torch.float32, (bh, nb, r)),
            "kqt_scale": (kqt_scale, torch.float32, (bh, r, nb)),
            "vqt_scale": (vqt_scale, torch.float32, (bh, r, nb)),
            "vpt_scale": (vpt_scale, torch.float32, (bh, nb, r)),
        })
    elif any(x is not None for x in scales):
        raise ValueError("base scales given with bases that are not int8")
    outl = (k_out_idx, k_out_val, v_out_idx, v_out_val, k_out_bnd, v_out_bnd)
    ko = 0
    if any(x is not None for x in outl):
        if k_out_val is None:
            raise ValueError("k_out_val is missing")
        ko = k_out_val.shape[-1]
        if ko % 2:
            raise ValueError(f"odd outlier count {ko}")
        if not 0 <= out_pad <= ko:
            raise ValueError(f"out_pad={out_pad} outside [0, {ko}]")
        expect.update({
            "k_out_idx": (k_out_idx, torch.int32, (bh, nb, ko // 2)),
            "k_out_val": (k_out_val, torch.bfloat16, (bh, nb, ko)),
            "v_out_idx": (v_out_idx, torch.int32, (bh, nb, ko // 2)),
            "v_out_val": (v_out_val, torch.bfloat16, (bh, nb, ko)),
            "k_out_bnd": (k_out_bnd, torch.int32, (bh, nb, BND_LANES)),
            "v_out_bnd": (v_out_bnd, torch.int32, (bh, nb, BND_LANES)),
        })
    check_operands(dev, expect)
    if bits not in (2, 4, 8) or gq not in GQ_SIZES or bh % hkv:
        raise ValueError(f"unsupported bits={bits} / GQ={gq} / hkv={hkv}")
    if d > TILE or TILE % group or group > TILE or d % v_group:
        raise ValueError(f"unsupported head_dim={d} / group={group} / "
                         f"v_group={v_group}")
    if not (0 <= comp_len <= t and 0 <= resid_len <= group
            and comp_len % group == 0 and nb * group == t):
        raise ValueError(f"bad lengths comp_len={comp_len} resid_len={resid_len}")

    n_split, per = splits(comp_len, bh, dev)
    ns = n_split + 1
    part_acc = torch.empty((bh, ns, gq, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((bh, ns, gq, 2), dtype=torch.float32, device=dev)
    out = torch.empty((bh, gq, d), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = getattr(lib, f"gear_decode_attention_b{bits}")(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), k_mn.data_ptr(),
        kpt.data_ptr(), kqt.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        v_mn.data_ptr(), vpt.data_ptr(), vqt.data_ptr(), k_resid.data_ptr(),
        v_resid.data_ptr(), pad_start.data_ptr(),
        _ptr(kpt_scale), _ptr(kqt_scale), _ptr(vpt_scale), _ptr(vqt_scale),
        _ptr(k_out_idx), _ptr(k_out_val), _ptr(k_out_bnd),
        _ptr(v_out_idx), _ptr(v_out_val), _ptr(v_out_bnd),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        bh, hkv, gq, d, t, nb, r, group, v_group, int(base8), ko, out_pad,
        comp_len, resid_len, n_split, per,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gear_decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def fold_window(pad_start, window: int | None, total_len: int, batch: int,
                device) -> torch.Tensor:
    """int32 [B] first attended position: ``pad_start`` (zeros if None)
    raised to ``total_len - window``. Host integers only, so no sync."""
    if pad_start is None:
        pad = torch.zeros((batch,), dtype=torch.int32, device=device)
    else:
        pad = pad_start.to(device=device, dtype=torch.int32)
    if window is not None:
        pad = pad.clamp(min=total_len - window)
    return pad.contiguous()


def pad_query(q: torch.Tensor, hkv: int, sm_scale: float | None):
    """q [B, Hq, Qn, D] -> (f32 [B*Hkv, GQ, D] with sm_scale folded in and GQ
    padded up to a size the kernels take, rows per kv head before padding)."""
    b, hq, qn, d = q.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    gq_n = (hq // hkv) * qn
    gq_pad = next((g for g in GQ_SIZES if g >= gq_n), None)
    if gq_pad is None:
        raise ValueError(f"{gq_n} query rows per kv head exceed "
                         f"{GQ_SIZES[-1]}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = q.reshape(b, hkv, gq_n, d).float() * sm_scale
    if gq_pad != gq_n:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, gq_pad - gq_n))
    return qf.reshape(b * hkv, gq_pad, d).contiguous(), gq_n


def attend_fused(spec: kvcache.CacheSpec, cache: kvcache.LayerCache,
                 q: torch.Tensor, *, sm_scale: float | None = None,
                 pad_start: torch.Tensor | None = None,
                 window: int | None = None) -> torch.Tensor:
    """Drop-in for ``cache.attend``: q [B, Hq, Qn, D] -> [B, Hq, Qn, D].

    CPU tensors take the plain version (``cache.attend``); CUDA tensors go
    through :func:`decode_attention`. ``window`` (Mistral's sliding window
    at decode) folds into ``pad_start`` over the compressed prefix:
    ``pad = max(pad_start, comp_len + resid_len - window)``. That needs
    ``window >= group``, so that the residual tier (at most ``group`` of the
    newest tokens) always lies inside the window.
    """
    if window is not None and window < spec.group:
        raise ValueError(
            f"window {window} < group {spec.group}: the window is masked "
            "through pad_start over the compressed prefix only; the residual "
            "tier (<= group tokens) must fit inside it")
    if q.device.type == "cpu":
        return kvcache.attend(spec, cache, q, sm_scale=sm_scale,
                              pad_start=pad_start, window=window)
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    qf, gq_n = pad_query(q, hkv, sm_scale)
    pad = fold_window(pad_start, window, cache.total_len, b, q.device)

    def flat(x):
        return x.reshape(b * hkv, *x.shape[2:])

    extra = {}
    if spec.base_bits == 8:
        extra.update({f: flat(getattr(cache, f)) for f in
                      ("kpt_scale", "kqt_scale", "vqt_scale", "vpt_scale")})
    if spec.outliers_per_block:
        extra.update({f: flat(getattr(cache, f)) for f in
                      ("k_out_idx", "k_out_val", "v_out_idx", "v_out_val",
                       "k_out_bnd", "v_out_bnd")})
        extra["out_pad"] = spec.ko_store - spec.outliers_per_block
    out = decode_attention(
        qf, flat(cache.k_codes), flat(cache.k_scale),
        flat(cache.k_mn), flat(cache.kpt), flat(cache.kqt),
        flat(cache.v_codes), flat(cache.v_scale), flat(cache.v_mn),
        flat(cache.vqt), flat(cache.vpt), flat(cache.k_resid),
        flat(cache.v_resid), pad, **extra,
        comp_len=cache.comp_len, resid_len=cache.resid_len, hkv=hkv,
        bits=spec.bits, group=spec.group, v_group=spec.v_group)
    out = out.reshape(b, hkv, -1, d)[:, :, :gq_n]
    return out.reshape(b, hq, qn, d).to(q.dtype)
