"""Fused decode attention over the two-tier compressed cache (CUDA, sm_90a).

Port of ``gear_tpu/kernels/decode.py``: the Pallas ``_decode_kernel`` becomes
``csrc/decode.cu``, with its whole contract (2/4/8-bit codes, K and V
sidebands, bf16 or int8 low-rank bases, sorted COO outliers, the residual
tier, ``pad_start`` and the sliding window). :func:`attend_fused` is the
drop-in for ``cache.attend``; :func:`decode_attention` is the launching
wrapper over flattened ``[BH, ...]`` operands. The paged form of the TPU
kernel (``decode_attention_paged`` / ``attend_paged`` there) is the same
source built with ``-DGEAR_DECODE_PAGED=1``: :func:`decode_attention_paged`
reads the physical page pool through per-sequence block tables, with each
sequence's lengths taken from device memory; :func:`attend_paged` is the
drop-in for ``paged.attend_gathered``.

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

Like the TPU kernel's ``dual_region`` path, the kernel reads the prefill's
P basis (replicated over the prefill's blocks by ``cache.prefill``) once
per row for the tiles that lie wholly inside the prefill; the TPU kernel's
``kcvt`` path (one K scale over the prefill) is not taken: a KCVT cache
stores its whole-span scale replicated per block row, and the kernel reads
it like any other.
"""
from __future__ import annotations

import torch

from .. import cache as kvcache
from . import _build

TILE = 128          # tokens per thread block (csrc/attn_common.cuh kTile)
BLOCKS_PER_SM = 3   # token splits aim at this many blocks per SM: what a
                    # block's shared memory lets fit at int2/int4, GQ <= 4
MAX_TILES = 4       # tiles a split walks at most: rows of unequal length
                    # (a paged batch) then end together
GQ_SIZES = (1, 2, 4, 8)
BND_LANES = 128     # width of an outlier boundary table
STAGES = 2          # tiles in the ring of one block (csrc/decode.cu kStages)
SMEM_MAX = 232448   # shared memory a block can have on an H100
SM_SMEM = 233472    # shared memory of an SM on an H100


def splits(n_tokens: int, bh: int, sms: int, blocks_per_sm: float,
           max_tiles: int | None = None) -> tuple[int, int]:
    """(number of token splits, tiles per split) for ``bh`` rows of
    ``n_tokens`` tokens on a card of ``sms`` SMs: split a row while the rows
    alone give fewer than ``blocks_per_sm`` blocks per SM, or while a split
    would walk more than ``max_tiles`` tiles; every split walks the same
    number of tiles but the last."""
    n_tiles = -(-n_tokens // TILE)
    if n_tiles == 0:
        return 0, 1
    want = max(1, int(blocks_per_sm * sms) // max(bh, 1))
    per = -(-n_tiles // min(n_tiles, want))
    if max_tiles is not None:
        per = min(per, max_tiles)
    return -(-n_tiles // per), per


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stage_bytes(d: int, bits: int, r: int, group: int, v_group: int,
                ko: int, base8: bool) -> int:
    """Bytes of one stage of the decode kernel's ring: everything one tile
    of 128 tokens reads, each piece on 16 bytes (csrc/decode.cu
    ``stage_layout``)."""
    nbt, ngv, wd = TILE // group, d // v_group, d * bits // 32
    bel = 1 if base8 else 2
    sc = nbt * r * 4 if base8 else 0
    bnd = nbt * BND_LANES * 4 if ko else 0
    pieces = (wd * TILE * 4, wd * (TILE + 4) * 4,        # K, V code words
              ngv * TILE * 2, ngv * TILE * 2,            # V scales, minima
              r * TILE * bel, r * TILE * bel,            # kqt, vqt
              nbt * d * 2, nbt * d * 2,                  # K scales, minima
              nbt * r * d * bel, nbt * r * d * bel,      # kpt, vpt
              sc, sc, sc, sc,                            # int8 base scales
              nbt * (ko // 2) * 4, nbt * (ko // 2) * 4,  # outlier indices
              nbt * ko * 2, nbt * ko * 2,                # outlier deltas
              bnd, bnd)                                  # boundary tables
    return sum((n + 15) // 16 * 16 for n in pieces)


def blocks_per_sm(smem: int) -> int:
    """Blocks of the decode kernel an SM holds at ``smem`` bytes each
    (228 KB an SM, 1 KB of it reserved a block), at most BLOCKS_PER_SM."""
    return min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024))


def decode_smem_bytes(gq: int, d: int, bits: int, r: int, group: int,
                      v_group: int, ko: int, base8: bool,
                      paged: bool) -> int:
    """Shared memory of one block of the decode kernel: the ring of STAGES
    stages (or, as large, the residual tier's K and V rows that split 0
    stages there), the prefill's P rows of K and V, the float32 working
    buffers and, paged, the page lookups (csrc/decode.cu
    ``split_smem_bytes``, which checks this count)."""
    nbt, ngv = TILE // group, d // v_group
    # the per-tile sums of the K side and of the V side share their floats;
    # the outlier terms' buffer only at GQ <= 2 (csrc/decode.cu
    # ``term_buffer``), the int8 bases' prefill scales only with them
    sums = max(nbt * gq * (1 + r), gq * (ngv + nbt * r))
    floats = (gq * d + nbt * gq * d + gq * ngv * TILE + gq * TILE + sums
              + 2 * gq * 4 + 2 * gq * r + (4 * r if base8 else 0)
              + (nbt * ko * gq if gq <= 2 else 0))
    if paged:
        floats += 2 * STAGES * nbt
    region = max(STAGES * stage_bytes(d, bits, r, group, v_group, ko, base8),
                 2 * group * d * 2)
    pre = (2 * r * d * (1 if base8 else 2) + 15) // 16 * 16
    bars = 8 * STAGES  # an mbarrier a stage
    return region + pre + bars + 4 * floats


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


def check_aligned(tensors: dict) -> None:
    """Raise unless every ``name: tensor`` starts on 16 bytes: the kernels
    stage tiles with 16-byte asynchronous copies."""
    for name, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_cache_leaves(dev, lead: tuple, nbs: int, ts: int, d: int,
                        bits: int, v_group: int, out_pad: int,
                        leaves: dict) -> tuple[bool, int]:
    """Check the compressed leaves of a dense cache (``lead = (BH,)``, a
    row's ``nbs`` blocks and ``ts`` tokens) or of a page pool (``lead =
    (P, H)``, a page's): all on ``dev``, contiguous, of the types and shapes
    the kernel takes. int8 bases need their four scales, outliers come all
    six or none. Returns (bases are int8, stored outliers per block)."""
    kpt = leaves["kpt"]
    r = kpt.shape[-2]
    ngv, wd = d // v_group, d * bits // 32
    base8 = kpt.dtype == torch.int8
    base_dt = torch.int8 if base8 else torch.bfloat16
    bf = torch.bfloat16
    expect = {
        "k_codes": (torch.int32, (wd, ts)), "v_codes": (torch.int32, (wd, ts)),
        "k_scale": (bf, (nbs, d)), "k_mn": (bf, (nbs, d)),
        "v_scale": (bf, (ngv, ts)), "v_mn": (bf, (ngv, ts)),
        "kpt": (base_dt, (nbs, r, d)), "vpt": (base_dt, (nbs, r, d)),
        "kqt": (base_dt, (r, ts)), "vqt": (base_dt, (r, ts)),
    }
    scales = ("kpt_scale", "kqt_scale", "vqt_scale", "vpt_scale")
    if base8:
        expect.update({
            "kpt_scale": (torch.float32, (nbs, r)),
            "vpt_scale": (torch.float32, (nbs, r)),
            "kqt_scale": (torch.float32, (r, nbs)),
            "vqt_scale": (torch.float32, (r, nbs)),
        })
    elif any(leaves.get(f) is not None for f in scales):
        raise ValueError("base scales given with bases that are not int8")
    outl = ("k_out_idx", "k_out_val", "v_out_idx", "v_out_val", "k_out_bnd",
            "v_out_bnd")
    ko = 0
    if any(leaves.get(f) is not None for f in outl):
        if leaves.get("k_out_val") is None:
            raise ValueError("k_out_val is missing")
        ko = leaves["k_out_val"].shape[-1]
        if ko % 2:
            raise ValueError(f"odd outlier count {ko}")
        if not 0 <= out_pad <= ko:
            raise ValueError(f"out_pad={out_pad} outside [0, {ko}]")
        expect.update({
            "k_out_idx": (torch.int32, (nbs, ko // 2)),
            "v_out_idx": (torch.int32, (nbs, ko // 2)),
            "k_out_val": (bf, (nbs, ko)), "v_out_val": (bf, (nbs, ko)),
            "k_out_bnd": (torch.int32, (nbs, BND_LANES)),
            "v_out_bnd": (torch.int32, (nbs, BND_LANES)),
        })
    check_operands(dev, {f: (leaves.get(f), dt, lead + shape)
                         for f, (dt, shape) in expect.items()})
    check_aligned({f: leaves.get(f) for f in expect})
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported bits={bits}")
    group = ts // nbs
    if d > TILE or d % 8 or TILE % group or d % v_group:
        raise ValueError(f"unsupported head_dim={d} / group={group} / "
                         f"v_group={v_group}")
    return base8, ko


# The order in which both C entry points take the cache's leaves.
_LEAF_ORDER = ("k_codes", "k_scale", "k_mn", "kpt", "kqt", "v_codes",
               "v_scale", "v_mn", "vpt", "vqt")
_EXTRA_ORDER = ("kpt_scale", "kqt_scale", "vpt_scale", "vqt_scale",
                "k_out_idx", "k_out_val", "k_out_bnd", "v_out_idx",
                "v_out_val", "v_out_bnd")


def _launch(entry: str, q, leaves: dict, k_resid, v_resid, pad_start, lens,
            block_table, ints: tuple, n_split: int) -> torch.Tensor:
    """Allocate the splits' partial states and the output, call the C entry
    point on the current stream, raise on a CUDA error."""
    bh, gq, d = q.shape
    dev = q.device
    ns = n_split + 1
    part_acc = torch.empty((bh, ns, gq, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((bh, ns, gq, 2), dtype=torch.float32, device=dev)
    out = torch.empty((bh, gq, d), dtype=torch.float32, device=dev)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), *[leaves[f].data_ptr() for f in _LEAF_ORDER],
        k_resid.data_ptr(), v_resid.data_ptr(), pad_start.data_ptr(),
        *[_ptr(leaves.get(f)) for f in _EXTRA_ORDER],
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        _ptr(lens), _ptr(block_table), *ints,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    return out


def decode_attention(q, k_codes, k_scale, k_mn, kpt, kqt, v_codes, v_scale,
                     v_mn, vqt, vpt, k_resid, v_resid, pad_start, *,
                     kpt_scale=None, kqt_scale=None, vqt_scale=None,
                     vpt_scale=None, k_out_idx=None, k_out_val=None,
                     v_out_idx=None, v_out_val=None, k_out_bnd=None,
                     v_out_bnd=None, out_pad: int = 0,
                     comp_len: int, resid_len: int, prefill_len: int,
                     hkv: int, bits: int, group: int,
                     v_group: int) -> torch.Tensor:
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
    them): the kernel does not walk them. ``prefill_len``: the tokens of
    the prefill block, whose quant blocks all hold one P basis (and int8
    scales): the kernel reads it once per row for the tiles inside it.
    Returns the normalised output [BH, GQ, D] f32.
    """
    bh, gq, d = q.shape
    t = k_codes.shape[-1]
    nb, r = kpt.shape[1], kpt.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention needs CUDA tensors, got {dev}")
    leaves = dict(
        k_codes=k_codes, k_scale=k_scale, k_mn=k_mn, kpt=kpt, kqt=kqt,
        v_codes=v_codes, v_scale=v_scale, v_mn=v_mn, vqt=vqt, vpt=vpt,
        kpt_scale=kpt_scale, kqt_scale=kqt_scale, vqt_scale=vqt_scale,
        vpt_scale=vpt_scale, k_out_idx=k_out_idx, k_out_val=k_out_val,
        v_out_idx=v_out_idx, v_out_val=v_out_val, k_out_bnd=k_out_bnd,
        v_out_bnd=v_out_bnd)
    if nb * group != t or group > TILE:
        raise ValueError(f"bad group={group} for {nb} blocks of {t} tokens")
    base8, ko = _check_cache_leaves(dev, (bh,), nb, t, d, bits, v_group,
                                    out_pad, leaves)
    check_operands(dev, {
        "q": (q, torch.float32, (bh, gq, d)),
        "k_resid": (k_resid, torch.bfloat16, (bh, group, d)),
        "v_resid": (v_resid, torch.bfloat16, (bh, group, d)),
        "pad_start": (pad_start, torch.int32, (bh // hkv,)),
    })
    if gq not in GQ_SIZES or bh % hkv:
        raise ValueError(f"unsupported GQ={gq} / hkv={hkv}")
    if not (0 <= comp_len <= t and 0 <= resid_len <= group
            and comp_len % group == 0 and 0 <= prefill_len <= comp_len
            and prefill_len % group == 0):
        raise ValueError(f"bad lengths comp_len={comp_len} resid_len="
                         f"{resid_len} prefill_len={prefill_len}")
    check_aligned({"k_resid": k_resid, "v_resid": v_resid})

    smem = decode_smem_bytes(gq, d, bits, r, group, v_group, ko, base8, False)
    n_split, per = splits(comp_len, bh, sm_count(dev), blocks_per_sm(smem),
                          MAX_TILES)
    out = _launch(
        f"gear_decode_attention_b{bits}", q, leaves, k_resid, v_resid,
        pad_start, None, None,
        (bh, hkv, gq, d, t, nb, r, group, v_group, int(base8), ko, out_pad,
         comp_len, resid_len, prefill_len, n_split, per, 0, 0, smem),
        n_split)
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
        comp_len=cache.comp_len, resid_len=cache.resid_len,
        prefill_len=cache.prefill_len, hkv=hkv,
        bits=spec.bits, group=spec.group, v_group=spec.v_group)
    out = out.reshape(b, hkv, -1, d)[:, :, :gq_n]
    return out.reshape(b, hq, qn, d).to(q.dtype)


def decode_attention_paged(lens, pad_start, block_table, q, kpt, k_codes,
                           k_scale, k_mn, kqt, v_codes, v_scale, v_mn, vqt,
                           vpt, k_resid, v_resid, *, kpt_scale=None,
                           kqt_scale=None, vqt_scale=None, vpt_scale=None,
                           k_out_idx=None, k_out_val=None, v_out_idx=None,
                           v_out_val=None, k_out_bnd=None, v_out_bnd=None,
                           out_pad: int = 0, max_comp_len: int, bits: int,
                           group: int, v_group: int,
                           page_blocks: int) -> torch.Tensor:
    """Launch the paged decode kernel: :func:`decode_attention`'s arithmetic
    read straight from the physical page pool.

    lens int32 [B, 3] (comp_len, resid_len, prefill_len per sequence, read on
    the device); pad_start int32 [B]; block_table int32 [B, MAXP] (negative
    entries are clamped to page 0 and masked by comp_len); q [B * H, GQ, D]
    f32 with sm_scale folded in. Pool leaves [P, H, ...]: k/v_codes int32
    [P, H, D//fpi, PT]; k_scale/k_mn bf16 [P, H, PB, D]; v_scale/v_mn bf16
    [P, H, NGV, PT]; kpt/vpt [P, H, PB, R, D] and kqt/vqt [P, H, R, PT], all
    four bf16 or all four int8, int8 with f32 scales kpt/vpt_scale
    [P, H, PB, R] and kqt/vqt_scale [P, H, R, PB] (blocks in lanes, as the
    pool stores them); outliers (all six or none) k/v_out_idx int32
    [P, H, PB, KO//2], k/v_out_val bf16 [P, H, PB, KO], k/v_out_bnd int32
    [P, H, PB, 128]. k/v_resid bf16 [B, H, G, D]. ``max_comp_len`` is a host
    bound on every comp_len: it sizes the grid, so no length is fetched.
    Returns [B * H, GQ, D] f32.
    """
    bh, gq, d = q.shape
    b, maxp = block_table.shape
    n_pages, hkv = k_codes.shape[0], k_codes.shape[1]
    pb = page_blocks
    pt = pb * group
    r = kpt.shape[3]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_paged needs CUDA tensors, got {dev}")
    leaves = dict(
        k_codes=k_codes, k_scale=k_scale, k_mn=k_mn, kpt=kpt, kqt=kqt,
        v_codes=v_codes, v_scale=v_scale, v_mn=v_mn, vqt=vqt, vpt=vpt,
        kpt_scale=kpt_scale, kqt_scale=kqt_scale, vqt_scale=vqt_scale,
        vpt_scale=vpt_scale, k_out_idx=k_out_idx, k_out_val=k_out_val,
        v_out_idx=v_out_idx, v_out_val=v_out_val, k_out_bnd=k_out_bnd,
        v_out_bnd=v_out_bnd)
    if group > TILE:
        raise ValueError(f"unsupported group={group}")
    base8, ko = _check_cache_leaves(dev, (n_pages, hkv), pb, pt, d, bits,
                                    v_group, out_pad, leaves)
    check_operands(dev, {
        "lens": (lens, torch.int32, (b, 3)),
        "pad_start": (pad_start, torch.int32, (b,)),
        "block_table": (block_table, torch.int32, (b, maxp)),
        "q": (q, torch.float32, (b * hkv, gq, d)),
        "k_resid": (k_resid, torch.bfloat16, (b, hkv, group, d)),
        "v_resid": (v_resid, torch.bfloat16, (b, hkv, group, d)),
    })
    if gq not in GQ_SIZES:
        raise ValueError(f"unsupported GQ={gq}")
    t = maxp * pt
    if not (0 <= max_comp_len <= t and max_comp_len % group == 0):
        raise ValueError(f"bad max_comp_len={max_comp_len}")
    check_aligned({"k_resid": k_resid, "v_resid": v_resid})

    smem = decode_smem_bytes(gq, d, bits, r, group, v_group, ko, base8, True)
    n_split, per = splits(max_comp_len, bh, sm_count(dev), blocks_per_sm(smem),
                          MAX_TILES)
    out = _launch(
        f"gear_decode_attention_paged_b{bits}", q, leaves, k_resid, v_resid,
        pad_start, lens, block_table,
        (bh, hkv, gq, d, t, maxp * pb, r, group, v_group, int(base8), ko,
         out_pad, max_comp_len, 0, 0, n_split, per, maxp, pb, smem),
        n_split)
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0


def attend_paged(pspec, pool, seqs, q: torch.Tensor, *,
                 sm_scale: float | None = None,
                 pad_start: torch.Tensor | None = None,
                 window: int | None = None) -> torch.Tensor:
    """Decode attention for a batch of paged sequences
    (``gear_tpu_torch.paged``), q [B, Hq, Qn, D] -> [B, Hq, Qn, D]; every row
    masks by its own lengths.

    CPU tensors take the plain version (``paged.attend_gathered``); CUDA
    tensors go through :func:`decode_attention_paged`. ``window`` folds into
    ``pad_start`` per sequence, from the device lengths (no sync):
    ``pad = max(pad_start, comp_len + resid_len - window)``; it needs
    ``window >= group`` (see :func:`attend_fused`).
    """
    from .. import paged

    spec = pspec.spec
    if window is not None and window < spec.group:
        raise ValueError(f"window {window} < group {spec.group}")
    if q.device.type == "cpu":
        return paged.attend_gathered(pspec, pool, seqs, q, sm_scale=sm_scale,
                                     pad_start=pad_start, window=window)
    b, hq, qn, d = q.shape
    qf, gq_n = pad_query(q, spec.num_kv_heads, sm_scale)
    if pad_start is None:
        pad = torch.zeros((b,), dtype=torch.int32, device=q.device)
    else:
        pad = pad_start.to(device=q.device, dtype=torch.int32)
    if window is not None:
        pad = torch.maximum(pad, seqs.comp_len + seqs.resid_len - window)

    extra = {}
    if spec.base_bits == 8:
        extra.update({f: getattr(pool, f) for f in
                      ("kpt_scale", "kqt_scale", "vqt_scale", "vpt_scale")})
    if spec.outliers_per_block:
        extra.update({f: getattr(pool, f) for f in
                      ("k_out_idx", "k_out_val", "v_out_idx", "v_out_val",
                       "k_out_bnd", "v_out_bnd")})
        extra["out_pad"] = spec.ko_store - spec.outliers_per_block
    out = decode_attention_paged(
        seqs.lens, pad.contiguous(), seqs.block_table, qf, pool.kpt,
        pool.k_codes, pool.k_scale, pool.k_mn, pool.kqt, pool.v_codes,
        pool.v_scale, pool.v_mn, pool.vqt, pool.vpt, seqs.k_resid,
        seqs.v_resid, **extra,
        max_comp_len=int(seqs.host_lens[:, paged.COMP].max()),
        bits=spec.bits, group=spec.group, v_group=spec.v_group,
        page_blocks=pspec.page_blocks)
    out = out.reshape(b, spec.num_kv_heads, -1, d)[:, :, :gq_n]
    return out.reshape(b, hq, qn, d).to(q.dtype)
