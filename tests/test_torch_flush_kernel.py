"""The flush kernel (``kernels.flush``, ``csrc/flush.cu``) against its plain
version, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture). Run on the H100 with ``python -m pytest -c /dev/null --noconftest
--rootdir . tests/test_torch_flush_kernel.py -q``.

What must agree, from the same cache state and the same starts: codes away
from the outlier positions bit for bit (at an outlier position the code is
the block mean's, which the two sum in different orders: one step at most),
sidebands, outlier indices and boundary tables bit for bit, deltas within
one bf16 ulp where the codes agree, the low-rank term P Q^T within 1e-3 of
its Frobenius norm, and every byte outside the flushed block.
"""
import zlib

import pytest
import torch

from gear_tpu_torch import cache as TC
from gear_tpu_torch import kernels
from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.core import quant
from gear_tpu_torch.engine import EngineConfig, InferenceEngine
from gear_tpu_torch.kernels import flush as TFL
from gear_tpu_torch.models import llama, mistral

pytestmark = pytest.mark.cuda

GEAR4 = dict(batch=16, num_kv_heads=8, head_dim=128, bits=4, group=64,
             rank=2, prefill_rank=4, lowrank_loop=3, outliers_per_block=162)
# name: (spec, compressed length before the flush, use_lowrank)
CASES = {
    "gear4_cell": (dict(GEAR4, max_len=4608), 4352, True),
    "mixtral_rank": (dict(GEAR4, num_kv_heads=2, bits=2, max_len=8448),
                     8192, True),
    "gearl": (dict(GEAR4, outliers_per_block=0, max_len=512), 256, True),
    "base8": (dict(GEAR4, base_bits=8, max_len=512), 192, True),
    "rank_v_0_int8": (dict(GEAR4, rank_v=0, bits=8, max_len=512), 64, True),
    "no_lowrank": (dict(GEAR4, max_len=512), 128, False),
    "d64_g32": (dict(GEAR4, head_dim=64, group=32, outliers_per_block=40,
                     max_len=256), 96, True),
    "batch_1": (dict(GEAR4, batch=1, max_len=512), 320, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def full_cache(spec, c0, device, seed):
    """A layer's cache with every leaf filled (so that a write outside the
    flushed block shows), ``c0`` tokens compressed and a full residual tier
    of bf16 values with a few heavy channels and a run of ties."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cache = TC.init_layer_cache(spec, device=device)
    for f in TC.TENSOR_FIELDS:
        x = getattr(cache, f)
        if x.dtype.is_floating_point:
            x.copy_(torch.randn(x.shape, generator=gen, device=device))
        else:
            hi = 127 if x.dtype == torch.int8 else 1 << 30
            x.copy_(torch.randint(-hi, hi, x.shape, generator=gen,
                                  device=device, dtype=torch.int64))
    shape = cache.k_resid.shape
    for f in ("k_resid", "v_resid"):
        x = torch.randn(shape, generator=gen, device=device)
        x[..., 3] *= 6.0                    # a heavy channel
        x[:, :, 5, :8] = x[:, :, 5, :1]     # ties inside a token
        # more ties at the top and at the bottom of row 0, head 0 than
        # either side takes: the lower indices first
        flat = x[0, 0].reshape(-1)
        n = spec.outliers_per_block
        flat[0:50 * n:50] = 9.0
        flat[25:50 * n:50] = -9.0
        if x.shape[0] > 1:  # a constant group: every smallest entry a
            x[1, 0] = 0.5   # duplicate of a largest one, steps of 0
        getattr(cache, f).copy_(x)
    cache.comp_len, cache.resid_len = c0, spec.group
    return cache


def clone(cache):
    return TC.LayerCache(**{f: getattr(cache, f).clone()
                            for f in TC.TENSOR_FIELDS},
                         comp_len=cache.comp_len, resid_len=cache.resid_len,
                         prefill_len=cache.prefill_len)


def site_p0(device):
    def p0(which, shape):
        gen = torch.Generator(device=device).manual_seed(
            zlib.crc32(repr((which, shape)).encode()))
        return torch.rand(shape, generator=gen, device=device)
    return p0


def outlier_mask(spec, resid):
    """[B, H, G*D] bool: the block's outlier positions, as the plain
    version chooses them."""
    b, h, g, d = resid.shape
    mask = torch.zeros((b, h, g * d), dtype=torch.bool, device=resid.device)
    if spec.outliers_per_block:
        _, idx, _, _ = TC._extract_outliers(spec, resid.float())
        mask.scatter_(-1, idx[:, :, 0, :spec.outliers_per_block], True)
    return mask


def block_views(spec, cache, x, c0):
    """The flushed block's part of tensor ``x`` ('k' or 'v'): codes [B, H,
    G, D], sidebands, outlier index / delta / boundary rows, P^T, Q^T and
    their scales."""
    g, blk = spec.group, c0 // spec.group
    words = getattr(cache, f"{x}_codes")[..., c0:c0 + g].transpose(-1, -2)
    if x == "k":
        side = (cache.k_scale[:, :, blk], cache.k_mn[:, :, blk])
    else:
        side = (cache.v_scale[..., c0:c0 + g], cache.v_mn[..., c0:c0 + g])
    return dict(
        codes=quant.unpack_codes_bytestrided(words, spec.bits),
        scale=side[0], mn=side[1],
        idx=getattr(cache, f"{x}_out_idx")[:, :, blk],
        val=getattr(cache, f"{x}_out_val")[:, :, blk],
        bnd=getattr(cache, f"{x}_out_bnd")[:, :, blk],
        pt=getattr(cache, f"{x}pt")[:, :, blk],
        qt=getattr(cache, f"{x}qt")[..., c0:c0 + g],
        pt_scale=getattr(cache, f"{x}pt_scale")[:, :, blk],
        qt_scale=getattr(cache, f"{x}qt_scale")[..., blk])


def low_rank_term(spec, v):
    """Q P^T of the block [B, H, G, D], float32, the int8 scales applied."""
    pt = v["pt"].float() * v["pt_scale"][..., None]
    qt = v["qt"].float() * v["qt_scale"][..., None]
    return qt.transpose(-1, -2) @ pt


def compare(spec, before, want, got, c0, use_lowrank=True):
    """Hold ``got`` (the kernel's flush of ``before``) to ``want`` (the plain
    version's)."""
    g = spec.group
    touched = {f: torch.ones(getattr(want, f).shape, dtype=torch.bool,
                             device=want.k_codes.device)
               for f in TC.TENSOR_FIELDS}
    for x in ("k", "v"):
        w = block_views(spec, want, x, c0)
        k = block_views(spec, got, x, c0)
        for f in ("scale", "mn", "idx", "bnd"):
            assert torch.equal(k[f], w[f]), (x, f)
        mask = outlier_mask(spec, getattr(before, f"{x}_resid")).reshape(
            w["codes"].shape)
        diff = (k["codes"] - w["codes"]).abs()
        assert not diff[~mask].any(), x
        assert diff.max() <= 1, x
        # deltas: one bf16 ulp where the entry's code agrees; where the mean's
        # code moved by a step, the kernel's delta restores the exact value
        if spec.outliers_per_block:
            pos = TC._unpack_oidx(w["idx"]).reshape(*w["idx"].shape[:2], -1)
            same = torch.gather((diff == 0).reshape(*diff.shape[:2], -1), -1,
                                pos)
            wv, kv = w["val"].float(), k["val"].float()
            ulp = torch.maximum(wv.abs(), kv.abs()) * 2.0 ** -7 + 1e-30
            assert ((kv - wv).abs() <= ulp)[same].all(), x
            assert (same | ((kv - wv).abs() <= 2 * w["scale"].float().amax()
                            + ulp)).all(), x
        if use_lowrank and max(spec.rank, spec.rank_v_eff) > 0:
            lw, lk = low_rank_term(spec, w), low_rank_term(spec, k)
            err = (lk - lw).norm() / lw.norm().clamp_min(1e-30)
            assert err <= 1e-3, (x, float(err))
            if spec.base_bits == 16:
                assert torch.equal(k["pt_scale"], w["pt_scale"])
                assert torch.equal(k["qt_scale"], w["qt_scale"])
            rank = spec.rank if x == "k" else spec.rank_v_eff
            assert not k["pt"][:, :, rank:].any()
            assert not k["qt"][:, :, rank:].any()
        # the block's part of each leaf, compared above; the rest below
        blk = c0 // g
        touched[f"{x}_codes"][..., c0:c0 + g] = False
        if x == "k":
            touched["k_scale"][:, :, blk] = touched["k_mn"][:, :, blk] = False
        else:
            touched["v_scale"][..., c0:c0 + g] = False
            touched["v_mn"][..., c0:c0 + g] = False
        for f in ("_out_idx", "_out_val", "_out_bnd"):
            touched[f"{x}{f}"][:, :, blk] = False
        touched[f"{x}pt"][:, :, blk] = False
        touched[f"{x}qt"][..., c0:c0 + g] = False
        touched[f"{x}pt_scale"][:, :, blk] = False
        touched[f"{x}qt_scale"][..., blk] = False
    for f, keep in touched.items():
        assert torch.equal(getattr(got, f)[keep], getattr(want, f)[keep]), f


@pytest.mark.parametrize("name", list(CASES))
def test_flush_kernel_matches_the_plain_version(cuda, name):
    kw, c0, use_lowrank = CASES[name]
    spec = TC.CacheSpec(**kw)
    before = full_cache(spec, c0, cuda, seed=len(name))
    want, got = clone(before), clone(before)
    ptrs = {f: getattr(got, f).data_ptr() for f in TC.TENSOR_FIELDS}
    TFL.flush_plain(spec, want, site_p0(cuda), None, use_lowrank)
    n = TFL.flush.launches
    TC._flush(spec, got, site_p0(cuda), None, use_lowrank)
    torch.cuda.synchronize()
    assert TFL.flush.launches == n + 1
    assert (got.comp_len, got.resid_len) == (c0 + spec.group, 0)
    assert ptrs == {f: getattr(got, f).data_ptr() for f in TC.TENSOR_FIELDS}
    compare(spec, before, want, got, c0, use_lowrank)


def test_flush_kernel_draws_what_the_plain_version_draws(cuda):
    """Without ``p0`` both routes draw their starts from the generator, K's
    then V's, and leave it in the same state."""
    spec = TC.CacheSpec(**CASES["batch_1"][0])
    before = full_cache(spec, 64, cuda, seed=3)
    want, got = clone(before), clone(before)
    gw = torch.Generator(device=cuda).manual_seed(11)
    gk = torch.Generator(device=cuda).manual_seed(11)
    TFL.flush_plain(spec, want, None, gw)
    TFL.flush(spec, got, None, gk)
    compare(spec, before, want, got, 64)
    assert torch.equal(gw.get_state(), gk.get_state())


def test_flush_kernel_refuses_what_it_does_not_take(cuda):
    spec = TC.CacheSpec(batch=1, num_kv_heads=1, head_dim=64, max_len=128,
                        group=32, dtype=torch.float32,
                        sideband_dtype=torch.float32)
    cache = TC.init_layer_cache(spec, device=cuda)
    n = TFL.flush.launches
    with pytest.raises(TypeError):
        TFL.flush(spec, cache)
    assert TFL.flush.launches == n


def test_engine_flushes_through_the_kernel_once_a_layer(cuda):
    """A fused greedy run on the card: every flush of every layer is one
    launch of the kernel, and the graph's counts are the ones the
    benchmark's window relies on (a capture, a replay for every step that
    neither flushes nor comes before the capture)."""
    cfg = mistral.tiny(head_dim=32, hidden_size=128, num_heads=4,
                       sliding_window=160)
    params = llama.init_params(cfg, device=cuda)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=2,
                             left=0.05)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=192, mode="fused"),
                          batch_size=2)
    tokens, mask = eng.left_pad([list(range(3, 113)), list(range(40, 70))],
                                0, 112)
    logits, caches = eng.prefill(tokens, mask, init=site_p0(cuda))
    cur = logits[:, -1].argmax(-1)
    pad = (112 - mask.sum(1)).to(torch.int32)
    kernels.reset_launch_counts()
    for j in range(70):
        cur, _, caches = eng.decode_step(caches, cur, 112 - pad + j, pad,
                                         step=j, init=lambda s, sh: site_p0(
                                             cuda)(repr(s), sh))
    flushes = 70 // 16
    assert kernels.launch_counts()["flush"] == cfg.num_layers * flushes
    assert caches.comp_len == 112 + 16 * flushes
    assert eng.graph_captures == 1
    assert eng.graph_replays == 70 - flushes - 2
    assert eng.eager_steps == flushes + 1
