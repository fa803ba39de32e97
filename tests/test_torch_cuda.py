"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture, so all workers collect the same tests). Run on the H100, where
there is no JAX for ``tests/conftest.py`` to import, with
``python -m pytest -c /dev/null --noconftest --rootdir . tests/test_torch_cuda.py -q``.
"""
import zlib

import chip_smoke
import pytest
import torch

from gear_tpu_torch import cache as TC
from gear_tpu_torch import kernels, paged
from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine
from gear_tpu_torch.kernels import decode as TK
from gear_tpu_torch.kernels import flash as TF
from gear_tpu_torch.kernels import pack as TP
from gear_tpu_torch.models import llama, mistral
from gear_tpu_torch.serving import PagedServingEngine, ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_kernels_bit_exact(cuda, bits):
    gen = torch.Generator(device=cuda).manual_seed(bits)
    x = torch.randn((8, 256, 128), generator=gen, device=cuda)
    for kern, plain, kw in ((TP.quant_pack_tokens, TP.quant_pack_tokens_plain,
                             dict(v_group=64)),
                            (TP.quant_pack_channels,
                             TP.quant_pack_channels_plain, dict(group=64))):
        before = kern.launches
        got = kern(x, bits=bits, **kw)
        want = plain(x, bits=bits, **kw)
        assert kern.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits,d,v_group", [
    (4, 128, 64), (2, 128, 32), (8, 128, 128), (4, 64, 16), (2, 48, 12),
    (4, 96, 24), (8, 36, 3), (4, 40, 40), (2, 16, 2), (8, 4, 1)])
def test_token_pack_kernel_bit_exact(cuda, dtype, bits, d, v_group):
    """B3 at either input type, head dims and V groups that are not powers
    of two, and a row count that is not a multiple of the rows a block
    takes (16 or 32): words, scales and minima equal the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(bits * d + v_group)
    x = torch.randn((3, 35, d), generator=gen, device=cuda).to(dtype)
    x[0, 0, :v_group] = 0.75   # constant groups: the scale == 0 guard
    x[2, 34, d - v_group:] = -2.0
    before = TP.quant_pack_tokens.launches
    got = TP.quant_pack_tokens(x, bits=bits, v_group=v_group)
    want = TP.quant_pack_tokens_plain(x.float(), bits=bits, v_group=v_group)
    assert TP.quant_pack_tokens.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_token_pack_kernel_at_half_steps(cuda, bits):
    """B3 takes the code from the step's reciprocal and divides only near a
    half-integer: values at (k + 1/2) steps above the group's minimum and
    one ulp either side, over steps from 1 to the ends of the float range,
    pack as the plain version's IEEE quotient does."""
    levels, d, v_group = (1 << bits) - 1, 128, 64
    inv = torch.tensor(1.0 / levels, dtype=torch.float32)
    rows = []
    for hi in (float(levels), 3.7, 1e-3, 1e-36, 1e31, 3e31):
        step = torch.tensor(hi, dtype=torch.float32) * inv
        k = torch.arange(v_group - 2, dtype=torch.float32) % levels
        mid = (k + 0.5) * step
        for x in (mid, torch.nextafter(mid, mid + step),
                  torch.nextafter(mid, mid - step)):
            group = torch.cat([torch.zeros(1), x.clamp(0.0, hi),
                               torch.tensor([hi], dtype=torch.float32)])
            rows.append(torch.cat([group, -group]))
    x = torch.stack(rows).to(cuda)
    got = TP.quant_pack_tokens(x, bits=bits, v_group=v_group)
    want = TP.quant_pack_tokens_plain(x, bits=bits, v_group=v_group)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,group,bits,layout", [
    # the three main paths' shapes: Llama-2-7B prefill (K as the model's
    # strided view), Mistral-7B prefill, a serving admission
    ((4, 32, 1024, 128), 64, 4, "bshd"), ((2, 8, 4352, 128), 64, 4, "bhsd"),
    ((1, 32, 3008, 128), 64, 4, "bhsd"),
    # rows past the registers' steps, ragged row slots, odd head dims, rows
    # wider than a block (chunks of words), tiny groups
    ((2, 4, 512, 128), 128, 2, "bshd"), ((1, 2, 280, 128), 70, 8, "bhsd"),
    ((1, 3, 200, 96), 100, 4, "bshd"), ((1, 2, 60, 48), 10, 4, "bhsd"),
    ((1, 1, 32, 2048), 8, 4, "bhsd"), ((1, 1, 12, 1152), 3, 8, "bhsd"),
    ((3, 5, 64, 16), 64, 2, "bshd"), ((1, 1, 4, 8), 1, 8, "bhsd")])
def test_channel_pack_kernel_bit_exact(cuda, dtype, shape, group, bits,
                                       layout):
    """B2 at either input type, contiguous or as a [B, H, S, D] view of
    [B, S, H, D] memory: words, scales and minima equal the plain
    version's, constant channels (the scale == 0 guard) included."""
    b, h, s, d = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + group)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x[0, 0, :group, : min(d, 5)] = 0.75
    x[-1, -1, s - group:, -1] = -2.0
    if layout == "bshd":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    before = TP.quant_pack_channels.launches
    got = TP.quant_pack_channels(x, bits=bits, group=group)
    want = TP.quant_pack_channels_plain(x, bits=bits, group=group)
    assert TP.quant_pack_channels.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert float(got[1][0, 0, 0, 0, 0]) == 0.0


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_channel_pack_kernel_at_half_steps(cuda, bits):
    """B2 takes the code from the step's reciprocal and divides only near a
    half-integer: channels whose values sit at (k + 1/2) steps above the
    group's minimum and one ulp either side, over steps from 1 to the ends
    of the float range, pack as the plain version's IEEE quotient does."""
    levels, group = (1 << bits) - 1, 64
    inv = torch.tensor(1.0 / levels, dtype=torch.float32)
    cols = []
    for hi in (float(levels), 3.7, 1e-3, 1e-36, 1e31, 3e31):
        step = torch.tensor(hi, dtype=torch.float32) * inv
        k = torch.arange(group - 2, dtype=torch.float32) % levels
        mid = (k + 0.5) * step
        for x in (mid, torch.nextafter(mid, mid + step),
                  torch.nextafter(mid, mid - step)):
            col = torch.cat([torch.zeros(1), x.clamp(0.0, hi),
                             torch.tensor([hi], dtype=torch.float32)])
            cols += [col, -col]
    x = torch.stack((cols * 4)[:128], dim=1).to(cuda)  # [group, 128]
    got = TP.quant_pack_channels(x, bits=bits, group=group)
    want = TP.quant_pack_channels_plain(x, bits=bits, group=group)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_channel_pack_kernel_refuses(cuda):
    """What B2 does not take raises before any launch."""
    x = torch.randn((2, 4, 128, 64), device=cuda)
    before = TP.quant_pack_channels.launches
    with pytest.raises(ValueError, match="multiple of group"):
        TP.quant_pack_channels(x[:, :, :100], bits=4, group=64)
    with pytest.raises(ValueError, match="16 bytes"):
        TP.quant_pack_channels(x.flatten()[1:8193].view(1, 128, 64), bits=4,
                               group=64)
    with pytest.raises(ValueError, match="16 bytes"):  # rows 520 B apart
        TP.quant_pack_channels(torch.randn((64, 130), device=cuda)[:, :128],
                               bits=4, group=64)
    with pytest.raises(ValueError, match="contiguous"):
        TP.quant_pack_channels(x.transpose(-1, -2), bits=4, group=64)
    with pytest.raises(ValueError, match="head dim"):
        TP.quant_pack_channels(x[..., :60].contiguous(), bits=4, group=64)
    with pytest.raises(ValueError, match="expected"):
        TP.quant_pack_channels(x[None], bits=4, group=64)
    with pytest.raises(TypeError):
        TP.quant_pack_channels(x.half(), bits=4, group=64)
    assert TP.quant_pack_channels.launches == before


@pytest.mark.parametrize("bits,hkv,hq,pad", [
    (2, 4, 4, None), (4, 4, 4, [0, 100]), (8, 2, 8, [37, 0]),
])
def test_decode_kernel_matches_plain(cuda, bits, hkv, hq, pad):
    gen = torch.Generator(device=cuda).manual_seed(0)
    spec = TC.CacheSpec(batch=2, num_kv_heads=hkv, head_dim=128, max_len=512,
                        bits=bits, group=64)
    shape = (2, hkv, 300, 128)
    k = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    cache = TC.prefill(spec, k, v, generator=gen)
    for _ in range(30):  # crosses a flush, leaves a partly filled residual
        kn = torch.randn((2, hkv, 1, 128), generator=gen, device=cuda)
        TC.append(spec, cache, kn, kn * 0.5, generator=gen)
    q = torch.randn((2, hq, 1, 128), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    got = TK.attend_fused(spec, cache, q, pad_start=pad_t)
    want = TC.attend(spec, cache, q, pad_start=pad_t)
    # both in float32; only the order of the sums differs
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_fused_engine_launches_kernels(cuda):
    cfg = llama.ModelConfig.tiny(head_dim=32, hidden_size=128, num_heads=4)
    params = llama.init_params(cfg, device=cuda)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEARL", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=2)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=64, mode="fused"), batch_size=2)
    kernels.reset_launch_counts()
    out = eng.generate([[1, 5, 9, 12, 3], [3, 7]], 20)
    counts = kernels.launch_counts()
    assert [len(o) for o in out] == [20, 20]
    assert counts["decode_attention"] == cfg.num_layers * 19
    assert counts["quant_pack_tokens"] == cfg.num_layers
    assert counts["quant_pack_channels"] == cfg.num_layers


def test_simulated_engine_on_the_card_matches_the_cpu(cuda):
    """Simulated mode on a small model: the card (the flash kernel on every
    decode step) and the CPU (the plain path) with the same inits give the
    same greedy tokens across three recompressions (int8 GEAR, so that the
    bf16 projections' rounding, which differs between the two, moves no
    code far)."""
    cfg = llama.ModelConfig.tiny(head_dim=32, hidden_size=128, num_heads=4)
    params = llama.init_params(cfg, device=cuda)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=8,
                             group_size=16, rank=2, prefill_rank=4, loop=2,
                             left=0.1, streaming_gap=4)

    def init(site, shape):
        gen = torch.Generator().manual_seed(hash(site) % (1 << 31))
        return torch.rand(shape, generator=gen)

    prompts = [[1, 5, 9, 12, 3, 8, 2, 6, 4, 7, 11], [3, 7, 10]]
    outs = {}
    for dev, p in ((cuda, params), ("cpu", cpu_params)):
        eng = InferenceEngine(cfg, p, comp,
                              EngineConfig(max_len=64, mode="simulated"),
                              batch_size=2, device=dev)
        kernels.reset_launch_counts()
        outs[str(dev)] = eng.generate(prompts, 14, init=init)
        if dev is cuda:
            counts = kernels.launch_counts()
            assert counts["flash_decode"] == cfg.num_layers * 13
            assert counts["decode_attention"] == 0
    assert outs["cuda"] == outs["cpu"]


GEAR_CASES = {
    # name: (spec kwargs, kv heads, q heads, pad_start, window)
    "outliers_int4": (dict(outliers_per_block=162), 4, 4, None, None),
    "outliers_int2_pad": (dict(outliers_per_block=162, bits=2), 4, 4,
                          [0, 100], None),
    "base8": (dict(base_bits=8), 4, 4, [37, 0], None),
    "all_three": (dict(outliers_per_block=162, base_bits=8,
                       kcvt_prefill=True), 2, 8, None, None),
    "window_cuts_prefix": (dict(), 4, 4, [0, 290], 200),
    "gqa_outliers_window": (dict(outliers_per_block=162), 2, 8, [5, 0], 150),
    "ranks_zero": (dict(outliers_per_block=162, rank=0, prefill_rank=0), 4, 4,
                   None, None),
    "group32_d64": (dict(outliers_per_block=40, group=32, head_dim=64), 4, 8,
                    [0, 33], 100),
}


@pytest.mark.parametrize("name", list(GEAR_CASES))
def test_decode_kernel_full_recipe_matches_plain(cuda, name):
    kw, hkv, hq, pad, window = GEAR_CASES[name]
    kw = dict(kw)
    d = kw.pop("head_dim", 128)
    gen = torch.Generator(device=cuda).manual_seed(1)
    spec = TC.CacheSpec(batch=2, num_kv_heads=hkv, head_dim=d, max_len=512,
                        **{"bits": 4, "group": 64, **kw})
    shape = (2, hkv, 300, d)
    k = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    cache = TC.prefill(spec, k, v, generator=gen)
    for _ in range(30):  # crosses a flush, leaves a partly filled residual
        kn = torch.randn((2, hkv, 1, d), generator=gen, device=cuda)
        TC.append(spec, cache, kn, kn * 0.5, generator=gen)
    q = torch.randn((2, hq, 1, d), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    before = TK.decode_attention.launches
    got = TK.attend_fused(spec, cache, q, pad_start=pad_t, window=window)
    assert TK.decode_attention.launches == before + 1
    want = TC.attend(spec, cache, q, pad_start=pad_t, window=window)
    # both in float32 over the same stored state; only sum orders differ
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    if spec.outliers_per_block:  # the deltas matter: without them it fails
        bare = TC.LayerCache(**{**{f: getattr(cache, f)
                                   for f in TC.TENSOR_FIELDS},
                                "k_out_val": torch.zeros_like(cache.k_out_val),
                                "v_out_val": torch.zeros_like(cache.v_out_val)},
                             comp_len=cache.comp_len,
                             resid_len=cache.resid_len)
        off = TK.attend_fused(spec, bare, q, pad_start=pad_t, window=window)
        assert not torch.allclose(off, want, rtol=1e-3, atol=1e-4)


# name: (spec kwargs, q heads over 4 kv heads, prompt, appended tokens,
# pad_start, window, residual length set by hand or None)
PREFILL_CASES = {
    # 896 of 1088: tiles 0-6 wholly inside the prefill, 7-8 past it
    "tiles_in_and_past": (dict(), 4, 900, 190, None, None, None),
    # 960: tile 7 straddles the prefill's end (block 14 in, 15 past)
    "tile_straddles": (dict(), 8, 960, 100, None, None, None),
    "pad_into_prefill": (dict(), 16, 960, 100, [300, 0], None, None),
    "window_into_prefill": (dict(outliers_per_block=162), 32, 960, 100,
                            [0, 77], 400, None),
    "resid_0": (dict(), 4, 640, 0, None, None, 0),
    "resid_1": (dict(bits=2), 8, 640, 0, None, None, 1),
    "resid_63": (dict(bits=8), 16, 640, 0, [5, 0], None, 63),
    "resid_64": (dict(outliers_per_block=162), 32, 640, 0, None, None, 64),
    "gq2_int8_bases": (dict(base_bits=8), 8, 900, 190, [0, 129], None, None),
    "gq8_gear_int8_bases": (dict(base_bits=8, outliers_per_block=162), 32,
                            900, 190, None, None, None),
    "rank_0": (dict(rank=0, prefill_rank=0), 16, 900, 190, None, None, None),
    "gq4_int2_gear": (dict(bits=2, outliers_per_block=162), 16, 900, 190,
                      None, None, None),
    "ties_gear": (dict(outliers_per_block=162), 16, 900, 190, None, None,
                  None),
}


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_decode_kernel_prefill_region(cuda, name):
    """B1 reads the prefill's one P basis for the tiles wholly inside the
    prefill and each block's own past it; each token's and channel's
    outlier segment, ties included; the residual tier staged in one batch,
    at every length it can have."""
    kw, hq, n_prefill, n_append, pad, window, resid = PREFILL_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(11)
    hkv, d = 4, 128
    spec = TC.CacheSpec(batch=2, num_kv_heads=hkv, head_dim=d, max_len=1152,
                        **{"bits": 4, "group": 64, "rank": 2,
                           "prefill_rank": 4, **kw})
    k = torch.randn((2, hkv, n_prefill, d), generator=gen, device=cuda)
    v = torch.randn((2, hkv, n_prefill, d), generator=gen, device=cuda)
    if name == "ties_gear":  # a coarse grid: outlier candidates tie
        k, v = (k * 2).round() / 2, (v * 2).round() / 2
    cache = TC.prefill(spec, k.bfloat16(), v.bfloat16(), generator=gen)
    for _ in range(n_append):
        kn = torch.randn((2, hkv, 1, d), generator=gen, device=cuda)
        TC.append(spec, cache, kn.bfloat16(), (kn * 0.5).bfloat16(),
                  generator=gen)
    if resid is not None:  # a residual tier of this length, by hand
        cache.k_resid.copy_(torch.randn(cache.k_resid.shape, generator=gen,
                                        device=cuda).bfloat16())
        cache.v_resid.copy_(torch.randn(cache.v_resid.shape, generator=gen,
                                        device=cuda).bfloat16())
        cache.resid_len = resid
    q = torch.randn((2, hq, 1, d), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    got = TK.attend_fused(spec, cache, q, pad_start=pad_t, window=window)
    want = TC.attend(spec, cache, q, pad_start=pad_t, window=window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def _mma_cache(dev, *, bits, hkv, gq, b=2, t=640, n_prefill=512,
               n_append=20, seed=3, coarse=False, **kw):
    """A cache at the tensor-core form's shape (head_dim 128, group 64,
    rank 2 / prefill rank 4) built by the port's prefill and appends, and
    float32 queries for it; ``coarse``: a prompt on a grid of 0.5, whose
    outlier candidates tie."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = TC.CacheSpec(batch=b, num_kv_heads=hkv, head_dim=128, max_len=t,
                        **{"bits": bits, "group": 64, "rank": 2,
                           "prefill_rank": 4, **kw})
    shape = (b, hkv, n_prefill, 128)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    if coarse:
        k, v = (k * 2).round() / 2, (v * 2).round() / 2
    cache = TC.prefill(spec, k.bfloat16(), v.bfloat16(), generator=gen)
    for _ in range(n_append):
        kn = torch.randn((b, hkv, 1, 128), generator=gen, device=dev)
        TC.append(spec, cache, kn.bfloat16(), (kn * 0.5).bfloat16(),
                  generator=gen)
    q = torch.randn((b, hkv * gq, 1, 128), generator=gen, device=dev)
    return spec, cache, q


def _hold_mma(spec, cache, q, what, pad=None, window=None):
    """The kernel against the plain ``cache.attend``, at the card tests'
    tolerance; the launch must take the tensor-core products."""
    dev = q.device
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=dev)
    gq = q.shape[1] // spec.num_kv_heads
    assert TK.mma_form(spec.bits, gq, spec.head_dim, spec.group,
                       spec.v_group, spec.r_store)
    before = kernels.launch_counts()["decode_attention_mma"]
    got = TK.attend_fused(spec, cache, q, pad_start=pad_t, window=window)
    assert kernels.launch_counts()["decode_attention_mma"] == before + 1
    want = TC.attend(spec, cache, q, pad_start=pad_t, window=window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4,
                               msg=lambda m: f"{what}: {m}")


def _set_codes(spec, cache, which, codes):
    """Overwrite K's or V's codes with ``codes`` [B, H, T, D] (the stored
    byte-strided words, [B, H, D * bits / 32, T])."""
    from gear_tpu_torch.core import quant

    words = quant.pack_codes_bytestrided(codes, spec.bits).transpose(-1, -2)
    getattr(cache, which).copy_(words)


MMA_SHAPES = {
    # name: (bits, kv heads, GQ, batch, max_len, prompt, appended, pad,
    # window, outliers)
    "cell_gear4": (4, 8, 4, 16, 4608, 4352, 70,
                   [52 + 25 * i for i in range(16)], 4096, 162),
    "cell_mixtral_rank": (2, 2, 4, 16, 8448, 8192, 70,
                          [42 + 23 * i for i in range(16)], None, 162),
    "int4_gq2": (4, 4, 2, 2, 640, 512, 20, [0, 70], None, 162),
    "int2_gq2": (2, 4, 2, 2, 640, 512, 20, None, None, 0),
    "int4_gq8": (4, 2, 8, 2, 640, 512, 20, None, 300, 162),
    "int2_gq8": (2, 2, 8, 2, 640, 512, 20, [3, 0], None, 162),
}


@pytest.mark.parametrize("name", list(MMA_SHAPES))
def test_decode_mma_products_at_their_shapes(cuda, name):
    """The tensor-core products at the GEAR cells' shapes (70 steps into
    their windows) and at every (bits, GQ) the selector sends them."""
    bits, hkv, gq, b, t, n_prefill, n_append, pad, window, ko = \
        MMA_SHAPES[name]
    spec, cache, q = _mma_cache(cuda, bits=bits, hkv=hkv, gq=gq, b=b, t=t,
                                n_prefill=n_prefill, n_append=n_append,
                                outliers_per_block=ko)
    _hold_mma(spec, cache, q, name, pad, window)


@pytest.mark.parametrize("bits", [2, 4])
def test_decode_mma_one_hot_codes(cuda, bits):
    """Codes that are zero but for one channel (K: the contraction axis of
    the scores; V: the rows of PV) or one token (K: the scores' rows; V: PV's
    contraction axis), at the largest code: a fragment that takes a word,
    byte or field from the wrong place fails, by that channel or token."""
    spec, cache, q = _mma_cache(cuda, bits=bits, hkv=2, gq=4, b=1,
                                n_prefill=128 * 3, n_append=0)
    shape = (1, 2, spec.max_len, 128)
    top = (1 << bits) - 1
    for which in ("k_codes", "v_codes"):
        keep = getattr(cache, which).clone()
        for ch in (0, 1, 2, 3, 4, 5, 17, 31, 32, 63, 64, 66, 95, 127):
            codes = torch.zeros(shape, dtype=torch.int32, device=cuda)
            codes[..., ch] = top
            _set_codes(spec, cache, which, codes)
            _hold_mma(spec, cache, q, f"{which} channel {ch}")
        for tok in (0, 1, 2, 3, 4, 7, 8, 9, 15, 16, 31, 63, 64, 65, 127, 128,
                    255, 300):
            codes = torch.zeros(shape, dtype=torch.int32, device=cuda)
            codes[..., tok, :] = top
            _set_codes(spec, cache, which, codes)
            _hold_mma(spec, cache, q, f"{which} token {tok}")
        getattr(cache, which).copy_(keep)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("fill", ["zero", "top"])
def test_decode_mma_codes_at_their_ends(cuda, bits, fill):
    """Every code 0, or every code 2^bits - 1: the bf16 bias under the
    codes comes off exactly."""
    spec, cache, q = _mma_cache(cuda, bits=bits, hkv=2, gq=4,
                                outliers_per_block=162)
    value = 0 if fill == "zero" else (1 << bits) - 1
    codes = torch.full((2, 2, spec.max_len, 128), value, dtype=torch.int32,
                       device=cuda)
    for which in ("k_codes", "v_codes"):
        _set_codes(spec, cache, which, codes)
    _hold_mma(spec, cache, q, f"codes {fill}")


# name: (bits, prompt, appended, residual length by hand or None, kwargs)
MMA_EDGES = {
    "resid_0": (4, 640, 0, 0, {}),
    "resid_1": (2, 640, 0, 1, {}),
    "resid_63": (4, 640, 0, 63, dict(outliers_per_block=162)),
    "resid_64": (2, 640, 0, 64, dict(outliers_per_block=162)),
    "tile_straddles_prefill": (4, 960, 100, None, {}),   # tile 7: 14 in, 15 past
    "tiles_past_prefill": (2, 900, 190, None, dict(outliers_per_block=162)),
    "outlier_ties": (4, 900, 190, None, dict(outliers_per_block=162)),
    "rank_0": (4, 900, 190, None, dict(rank=0, prefill_rank=0)),
    "int8_bases": (4, 900, 190, None, dict(base_bits=8,
                                           outliers_per_block=162)),
}


@pytest.mark.parametrize("name", list(MMA_EDGES))
def test_decode_mma_edges(cuda, name):
    """The tensor-core products at the residual tier's every length, on
    tiles inside, across and past the prefill's end (its one P, then each
    block's own), with outlier ties, rank 0 and int8 bases."""
    bits, n_prefill, n_append, resid, kw = MMA_EDGES[name]
    spec, cache, q = _mma_cache(cuda, bits=bits, hkv=4, gq=4, t=1152,
                                n_prefill=n_prefill, n_append=n_append,
                                seed=11, coarse=name == "outlier_ties", **kw)
    if resid is not None:  # a residual tier of this length, by hand
        gen = torch.Generator(device=cuda).manual_seed(13)
        cache.k_resid.copy_(torch.randn(cache.k_resid.shape, generator=gen,
                                        device=cuda).bfloat16())
        cache.v_resid.copy_(torch.randn(cache.v_resid.shape, generator=gen,
                                        device=cuda).bfloat16())
        cache.resid_len = resid
    _hold_mma(spec, cache, q, name)


def test_decode_mma_counter(cuda):
    """``decode_attention_mma`` counts the launches that take the
    tensor-core products: one a call at the cells' instantiations (int4
    and int2 at GQ 4), none at int8 codes, GQ 1 or head_dim 64."""
    for bits, gq, d, want in ((4, 4, 128, 1), (2, 4, 128, 1), (8, 4, 128, 0),
                              (4, 1, 128, 0), (4, 2, 64, 0)):
        gen = torch.Generator(device=cuda).manual_seed(5)
        spec = TC.CacheSpec(batch=1, num_kv_heads=2, head_dim=d, max_len=256,
                            bits=bits, group=64)
        k = torch.randn((1, 2, 200, d), generator=gen, device=cuda)
        cache = TC.prefill(spec, k.bfloat16(), k.bfloat16(), generator=gen)
        q = torch.randn((1, 2 * gq, 1, d), generator=gen, device=cuda)
        before = kernels.launch_counts()
        got = TK.attend_fused(spec, cache, q)
        after = kernels.launch_counts()
        assert after["decode_attention"] == before["decode_attention"] + 1
        assert (after["decode_attention_mma"]
                == before["decode_attention_mma"] + want), (bits, gq, d)
        torch.testing.assert_close(got, TC.attend(spec, cache, q),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("hkv,hq,length,pad,window", [
    (4, 4, 300, None, None), (2, 8, 512, [0, 130], None),
    (4, 4, 131, [130, 5], None), (2, 4, 400, [3, 9], 150),
    (1, 8, 77, None, 64),
])
def test_flash_kernel_matches_plain(cuda, hkv, hq, length, pad, window):
    gen = torch.Generator(device=cuda).manual_seed(2)
    spec = TC.CacheSpec(batch=2, num_kv_heads=hkv, head_dim=128, max_len=512)
    k = torch.randn((2, hkv, 512, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((2, hkv, 512, 128), generator=gen, device=cuda).bfloat16()
    c = llama.RawLayerCache(k=k, v=v, length=length)
    q = torch.randn((2, hq, 1, 128), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    before = TF.flash_decode.launches
    got = TF.raw_attend_flash(spec, c, q, pad_start=pad_t, window=window)
    assert TF.flash_decode.launches == before + 1
    want = llama.raw_attend(spec, c, q, pad_start=pad_t, window=window)
    # both in float32 over the same bf16 cache; only sum orders differ
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_mistral_gear_engine_launches_kernels(cuda, mode):
    cfg = mistral.tiny(head_dim=32, hidden_size=128, num_heads=4)
    params = llama.init_params(cfg, device=cuda)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=2,
                             left=0.05)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=96, mode=mode), batch_size=2)
    kernels.reset_launch_counts()
    out = eng.generate([list(range(1, 23)), [3, 7]], 30)
    counts = kernels.launch_counts()
    assert [len(o) for o in out] == [30, 30]
    fused = mode == "fused"
    assert counts["decode_attention"] == (cfg.num_layers * 29 if fused else 0)
    assert counts["flash_decode"] == (0 if fused else cfg.num_layers * 29)
    assert counts["quant_pack_tokens"] == (cfg.num_layers if fused else 0)


@pytest.mark.parametrize("kw", [
    dict(outliers_per_block=162), dict(outliers_per_block=162, base_bits=8,
                                       kcvt_prefill=True)],
    ids=["gear", "gear_base8_kcvt"])
def test_gear_prefill_on_the_card_matches_the_cpu(cuda, kw):
    """Prefill through the pack kernels and the delta recomputation on the
    card against the plain route on the CPU, same input and inits."""
    spec = TC.CacheSpec(batch=2, num_kv_heads=2, head_dim=128, max_len=256,
                        bits=4, group=64, lowrank_loop=2, **kw)
    gen = torch.Generator().manual_seed(5)
    k = torch.randn((2, 2, 200, 128), generator=gen).bfloat16()
    v = torch.randn((2, 2, 200, 128), generator=gen).bfloat16()

    def p0(which, shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(
            len(which) + shape[-1]))

    cpu = TC.prefill(spec, k, v, p0=p0)
    before = TP.quant_pack_tokens.launches
    card = TC.prefill(spec, k.to(cuda), v.to(cuda), p0=p0)
    assert TP.quant_pack_tokens.launches == before + 1
    for f in ("k_out_idx", "v_out_idx", "k_out_bnd", "v_out_bnd", "k_scale",
              "k_mn", "v_scale", "v_mn", "k_resid", "v_resid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    # codes at outlier positions hold the block mean, summed in another
    # order on the card; restored values agree to one bf16 rounding of a
    # delta (|delta| < 8: 2**-6), bases to float32 sums in another order
    for a, b in zip(TC.dequantize_kv(spec, card), TC.dequantize_kv(spec, cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2 ** -6)


def build_paged(gen, kw, hkv, page_blocks):
    """``chip_smoke.build_paged`` at a smaller size: rows of 670 and 270
    tokens on interleaved pages, a row sharing row 0's first page, a parked
    row."""
    kw = dict(kw)
    d, g = kw.pop("head_dim", 128), kw.pop("group", 64)
    return chip_smoke.build_paged(torch, gen, kw, hkv, page_blocks,
                                  (600, 200), max_len=1024, n_pages=24, d=d,
                                  g=g)


PAGED_CASES = {
    # name: (spec kwargs, kv heads, q heads, page_blocks, pad_start, window)
    "gearl_int4_pb1": (dict(), 4, 4, 1, None, None),
    "gearl_int4_pb4": (dict(), 4, 4, 4, None, None),
    "gear_int4": (dict(outliers_per_block=162), 4, 4, 1, None, None),
    "gear_int4_pb4_pad": (dict(outliers_per_block=162), 4, 4, 4,
                          [0, 100, 0, 0], None),
    "int2": (dict(bits=2), 4, 4, 2, None, None),
    "int8": (dict(bits=8), 4, 4, 2, None, None),
    "base8": (dict(base_bits=8), 4, 4, 1, None, None),
    "gear_base8_pb4": (dict(outliers_per_block=162, base_bits=8), 2, 8, 4,
                       None, None),
    "gqa": (dict(), 2, 8, 2, None, None),
    # cuts into the prefix of row 0 (670 tokens), not of row 1 (270)
    "window": (dict(), 4, 4, 1, [0, 30, 0, 0], 300),
    "group32_d64": (dict(outliers_per_block=40, group=32, head_dim=64), 4, 8,
                    2, None, 200),
}


@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_decode_kernel_matches_plain(cuda, name):
    kw, hkv, hq, pb, pad, window = PAGED_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(3)
    pspec, pool, seqs = build_paged(gen, kw, hkv, pb)
    b = seqs.batch
    assert len(set(seqs.host_lens[:, 0].tolist())) == b  # lengths differ
    q = torch.randn((b, hq, 1, pspec.spec.head_dim), generator=gen,
                    device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    before = TK.decode_attention_paged.launches
    got = TK.attend_paged(pspec, pool, seqs, q, pad_start=pad_t,
                          window=window)
    assert TK.decode_attention_paged.launches == before + 1
    want = paged.attend_gathered(pspec, pool, seqs, q, pad_start=pad_t,
                                 window=window)
    assert torch.isfinite(got).all()
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))  # the parked row
    # both in float32 over the same stored state; only sum orders differ
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    # the table matters: with row 0 pointed at row 1's pages it fails
    swapped = paged.PagedSeqs(seqs.block_table.clone(), seqs.lens,
                              seqs.k_resid, seqs.v_resid, seqs.host_table,
                              seqs.host_lens)
    swapped.block_table[0] = seqs.block_table[1, 0]
    off = TK.attend_paged(pspec, pool, swapped, q, pad_start=pad_t,
                          window=window)
    assert not torch.allclose(off[0], want[0], rtol=1e-3, atol=1e-4)


def test_paged_kernel_refuses_float32_pools(cuda):
    spec = TC.CacheSpec(batch=1, num_kv_heads=2, head_dim=128, max_len=256,
                        dtype=torch.float32, sideband_dtype=torch.float32)
    pspec = paged.PagedSpec(spec=spec, n_pages=4, page_blocks=2)
    pool = paged.init_pool(pspec, cuda)
    seqs = paged.init_seqs(pspec, 1, cuda)
    q = torch.randn((1, 2, 1, 128), device=cuda)
    with pytest.raises(TypeError):
        TK.attend_paged(pspec, pool, seqs, q)


def test_paged_serving_on_the_card(cuda):
    """Paged serving through the paged kernel: every request completes, the
    pool drains, and the tokens are the dense serving engine's."""
    cfg = llama.ModelConfig.tiny(head_dim=32, hidden_size=128, num_heads=4)
    params = llama.init_params(cfg, device=cuda)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=8,
                             group_size=16, rank=2, prefill_rank=2, loop=2,
                             left=0.05)

    def init(site, shape):
        gen = torch.Generator().manual_seed(hash(site) % (1 << 31))
        return torch.rand(shape, generator=gen)

    reqs = [(list(range(1, 20)), 40), ([9, 8, 7], 5), ([4, 5, 6, 7], 30)]
    eng = PagedServingEngine(cfg, params, comp, n_slots=2, max_len=128,
                             n_pages=16, page_blocks=2, init=init)
    rids = [eng.submit(p, n) for p, n in reqs]
    kernels.reset_launch_counts()
    out = eng.run()
    counts = kernels.launch_counts()
    assert [len(out[r]) for r in rids] == [40, 5, 30]
    assert eng.alloc.free_count() == 16
    assert counts["decode_attention_paged"] > 0
    assert counts["decode_attention_paged"] % cfg.num_layers == 0
    assert counts["decode_attention"] == 0
    assert counts["quant_pack_tokens"] == 3 * cfg.num_layers
    dense = ServingEngine(cfg, params, comp, n_slots=2, max_len=128,
                          init=init)
    rids_d = [dense.submit(p, n) for p, n in reqs]
    out_d = dense.run()
    agree = sum(a == b for r, rd in zip(rids, rids_d)
                for a, b in zip(out[r], out_d[rd]))
    assert agree >= 0.9 * 75  # random-weight logits sit near ties


# The kernels' tile pipelines at their edges: lengths that are not a
# multiple of the 128-token tile, pad_start inside a tile, and blocks that
# walk several tiles with an odd count or a short last split, forced by
# BLOCKS_PER_SM (0: one split per row, the whole row in one block).
@pytest.mark.parametrize("hkv,hq,length,pad,window,bps", [
    (4, 4, 300, None, None, 0),             # 3 tiles, the last of 44 tokens
    (2, 8, 640, [0, 130], None, 0),         # 5 tiles; pad inside tile 1
    (2, 8, 1000, [200, 7], 300, 0.2),       # splits of 3, 3 and 2 tiles
    (4, 4, 131, [130, 5], None, 0),         # a tile of 3 tokens
    (1, 4, 1000, [0, 0], None, None),       # the planner's own splits
])
def test_flash_pipeline_edges(cuda, monkeypatch, hkv, hq, length, pad,
                              window, bps):
    if bps is not None:
        monkeypatch.setattr(TF, "BLOCKS_PER_SM", bps)
    gen = torch.Generator(device=cuda).manual_seed(7)
    spec = TC.CacheSpec(batch=2, num_kv_heads=hkv, head_dim=128,
                        max_len=1024)
    k = torch.randn((2, hkv, 1024, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((2, hkv, 1024, 128), generator=gen, device=cuda).bfloat16()
    c = llama.RawLayerCache(k=k, v=v, length=length)
    q = torch.randn((2, hq, 1, 128), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    got = TF.raw_attend_flash(spec, c, q, pad_start=pad_t, window=window)
    want = llama.raw_attend(spec, c, q, pad_start=pad_t, window=window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kw,n_prefill,pad,window,bps", [
    (dict(), 300, None, None, 0),                       # 330: 3 tiles
    (dict(outliers_per_block=162), 900, [0, 200], None, 0),  # 7 tiles
    (dict(outliers_per_block=162, base_bits=8), 900, [70, 0], 500, 0.2),
    (dict(bits=2), 600, [0, 129], None, 0.2),
    (dict(base_bits=8, kcvt_prefill=True), 700, None, None, None),
], ids=["gearl_3_tiles", "gear_7_tiles_pad", "gear_base8_window_splits",
        "int2_pad_splits", "base8_kcvt_planned"])
def test_decode_pipeline_edges(cuda, monkeypatch, kw, n_prefill, pad, window,
                               bps):
    if bps is not None:
        monkeypatch.setattr(TK, "BLOCKS_PER_SM", bps)
    gen = torch.Generator(device=cuda).manual_seed(8)
    spec = TC.CacheSpec(batch=2, num_kv_heads=4, head_dim=128, max_len=1024,
                        **{"bits": 4, "group": 64, **kw})
    k = torch.randn((2, 4, n_prefill, 128), generator=gen, device=cuda)
    v = torch.randn((2, 4, n_prefill, 128), generator=gen, device=cuda)
    cache = TC.prefill(spec, k.bfloat16(), v.bfloat16(), generator=gen)
    for _ in range(30):  # crosses a flush, leaves a partly filled residual
        kn = torch.randn((2, 4, 1, 128), generator=gen, device=cuda)
        TC.append(spec, cache, kn.bfloat16(), (kn * 0.5).bfloat16(),
                  generator=gen)
    q = torch.randn((2, 4, 1, 128), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    got = TK.attend_fused(spec, cache, q, pad_start=pad_t, window=window)
    want = TC.attend(spec, cache, q, pad_start=pad_t, window=window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kw,pb,pad,window,bps", [
    (dict(), 1, None, None, 0),        # pages of 64: a tile spans two pages
    (dict(outliers_per_block=162), 1, [0, 100, 0, 0], None, 0),
    (dict(outliers_per_block=162, base_bits=8), 4, [0, 70, 0, 0], None, 0),
    (dict(outliers_per_block=162, base_bits=8), 2, None, 300, 0.2),
    (dict(bits=8), 4, [129, 0, 0, 0], None, 0.2),
], ids=["pages_of_64", "gear_pad_in_tile", "gear_base8", "base8_window",
        "int8_pad_splits"])
def test_paged_pipeline_edges(cuda, monkeypatch, kw, pb, pad, window, bps):
    """Rows of 670 and 270 tokens (5 and 2 tiles compressed), a row sharing
    row 0's first page, the parked row."""
    monkeypatch.setattr(TK, "BLOCKS_PER_SM", bps)
    gen = torch.Generator(device=cuda).manual_seed(9)
    pspec, pool, seqs = build_paged(gen, kw, 4, pb)
    q = torch.randn((seqs.batch, 4, 1, 128), generator=gen, device=cuda)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                   device=cuda)
    got = TK.attend_paged(pspec, pool, seqs, q, pad_start=pad_t,
                          window=window)
    want = paged.attend_gathered(pspec, pool, seqs, q, pad_start=pad_t,
                                 window=window)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))  # the parked row
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


# The evaluation path's shapes: the mid-scale checkpoint (runs/mid_arith:
# head_dim 64, 6 kv / 12 q heads, GQ 2) and the CLI's tiny_arith_hf (head_dim
# 32, 4 kv / 8 q heads), quant groups of 32 tokens and V groups of 32
# channels, prompts in buckets of 96 / 128 tokens.
@pytest.mark.parametrize("d,hkv", [(64, 6), (32, 4)], ids=["d64", "d32"])
@pytest.mark.parametrize("method", ["GEARL", "GEAR"])
def test_decode_kernel_at_eval_shapes(cuda, method, d, hkv):
    """B1 over a cache built by the port's prefill of 128 left-padded
    tokens and 47 appends (a flush at 160), GQ 2, int4, group 32; GEAR
    keeps ``int(0.02 * 32 * d)`` outliers a block (40 at d=64, 20 at 32)."""
    ko = int(0.02 * 32 * d) if method == "GEAR" else 0
    spec = TC.CacheSpec(batch=8, num_kv_heads=hkv, head_dim=d, max_len=512,
                        bits=4, group=32, rank=2, prefill_rank=4,
                        lowrank_loop=3, outliers_per_block=ko - ko % 2)
    gen = torch.Generator(device=cuda).manual_seed(d + ko)
    shape = (8, hkv, 128, d)
    k = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    cache = TC.prefill(spec, k, v, generator=gen)
    for _ in range(47):
        kn = torch.randn((8, hkv, 1, d), generator=gen, device=cuda)
        TC.append(spec, cache, kn.bfloat16(), (kn * 0.5).bfloat16(),
                  generator=gen)
    assert (cache.comp_len, cache.resid_len) == (160, 15)
    q = torch.randn((8, 2 * hkv, 1, d), generator=gen, device=cuda)
    pad = torch.tensor([22, 36, 30, 27, 33, 24, 29, 31], dtype=torch.int32,
                       device=cuda)
    before = TK.decode_attention.launches
    got = TK.attend_fused(spec, cache, q, pad_start=pad)
    assert TK.decode_attention.launches == before + 1
    want = TC.attend(spec, cache, q, pad_start=pad)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 32])
def test_pack_kernels_at_eval_shapes(cuda, dtype, d):
    """B3 (V groups of 32 channels) and B2 (groups of 32 tokens, K as the
    model's [B, H, S, D] view of [B, S, H, D]) on 8 rows of a 128-token
    bucket, bit-equal to their plain versions."""
    hkv = 6 if d == 64 else 4
    gen = torch.Generator(device=cuda).manual_seed(d)
    v = torch.randn((8 * hkv, 128, d), generator=gen, device=cuda).to(dtype)
    v[0, 0, :32] = 0.75  # a constant group
    k = torch.randn((8, 128, hkv, d), generator=gen, device=cuda).to(dtype)
    k[0, :32, 0, 0] = -2.0
    for kern, plain, kw, x in (
            (TP.quant_pack_tokens, TP.quant_pack_tokens_plain,
             dict(v_group=32), v),
            (TP.quant_pack_channels, TP.quant_pack_channels_plain,
             dict(group=32), k.transpose(1, 2))):
        before = kern.launches
        got = kern(x, bits=4, **kw)
        assert kern.launches == before + 1
        for a, b in zip(got, plain(x, bits=4, **kw)):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("d,hkv,t,length", [(64, 6, 512, 175),
                                            (32, 4, 2048, 383)],
                         ids=["d64", "d32"])
def test_flash_kernel_at_eval_shapes(cuda, d, hkv, t, length):
    """B4 at GQ 2 with head_dim 64 (simulated mode on the mid-scale
    checkpoint) and 32 (the CLI on tiny_arith_hf), left-padded rows."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    spec = TC.CacheSpec(batch=8, num_kv_heads=hkv, head_dim=d, max_len=t)
    k = torch.randn((8, hkv, t, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((8, hkv, t, d), generator=gen, device=cuda).bfloat16()
    c = llama.RawLayerCache(k=k, v=v, length=length)
    q = torch.randn((8, 2 * hkv, 1, d), generator=gen, device=cuda)
    pad = torch.tensor([22, 36, 30, 27, 33, 24, 29, 31], dtype=torch.int32,
                       device=cuda)
    before = TF.flash_decode.launches
    got = TF.raw_attend_flash(spec, c, q, pad_start=pad)
    assert TF.flash_decode.launches == before + 1
    want = llama.raw_attend(spec, c, q, pad_start=pad)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["h2o", "sink"])
def test_evicting_engine_on_the_card_matches_the_cpu(cuda, mode):
    """Modes h2o and sink on a small float32 model: the card's greedy tokens
    equal the CPU's through eviction and the ring's wrap."""
    cfg = llama.ModelConfig.tiny(head_dim=32, hidden_size=128, num_heads=4,
                                 dtype=torch.float32)
    params = llama.init_params(cfg, seed=1, device="cpu")
    comp = CompressionConfig(num_layers=cfg.num_layers, group_size=16,
                             important_size=6, recent_size=26, sink_size=3,
                             window_size=29)
    prompts = [[5, 9, 2, 7, 11, 3, 8, 4, 1, 6, 12, 13, 14, 15, 16, 17, 18,
                19, 21, 22], [4, 1, 6, 20, 30]]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        eng = InferenceEngine(cfg, p, comp, EngineConfig(max_len=64, mode=mode),
                              batch_size=2, device=dev)
        outs[dev.type] = eng.generate(prompts, 30)
    assert outs["cuda"] == outs["cpu"]


# The Mixtral-8x7B path's shapes (chip_smoke.py "e2e mixtral"): batch 2,
# 8 kv / 32 q heads, head_dim 128, GEAR int2 with 2% outliers (162 a block),
# group 64, prompts of 8,100 tokens (one left-padded by 200), max_len 8,320.
MIXTRAL_SPEC = dict(batch=2, num_kv_heads=8, head_dim=128, max_len=8320,
                    bits=2, group=64, rank=2, prefill_rank=4, lowrank_loop=3,
                    outliers_per_block=162)


def test_decode_kernel_at_mixtral_shapes(cuda):
    """B1 over a cache built by the port's prefill of 8,100 tokens and 30
    appends (the flush at the 28th), GQ 4, int2, 2% outliers, no window."""
    spec = TC.CacheSpec(**MIXTRAL_SPEC)
    gen = torch.Generator(device=cuda).manual_seed(8)
    shape = (2, 8, 8100, 128)
    k = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    cache = TC.prefill(spec, k, v, generator=gen)
    del k, v
    for _ in range(30):
        kn = torch.randn((2, 8, 1, 128), generator=gen, device=cuda)
        TC.append(spec, cache, kn.bfloat16(), (kn * 0.5).bfloat16(),
                  generator=gen)
    assert (cache.comp_len, cache.resid_len) == (8128, 2)
    q = torch.randn((2, 32, 1, 128), generator=gen, device=cuda)
    pad = torch.tensor([0, 200], dtype=torch.int32, device=cuda)
    before = TK.decode_attention.launches
    got = TK.attend_fused(spec, cache, q, pad_start=pad)
    assert TK.decode_attention.launches == before + 1
    want = TC.attend(spec, cache, q, pad_start=pad)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("which", ["tokens", "channels"])
def test_pack_kernels_at_mixtral_shapes(cuda, which):
    """B3 / B2 on the GEAR prefill's blocks, 2 x 8 rows of 8,064 tokens,
    outliers replaced by the block mean (the float32 block the GEAR route
    hands both), int2: bit-equal to their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((16, 8064, 128), generator=gen, device=cuda)
    x = chip_smoke.cleaned_blocks(torch, x.bfloat16().float(), 8)
    kern, plain, kw = ((TP.quant_pack_tokens, TP.quant_pack_tokens_plain,
                        dict(v_group=64)) if which == "tokens" else
                       (TP.quant_pack_channels, TP.quant_pack_channels_plain,
                        dict(group=64)))
    before = kern.launches
    got = kern(x, bits=2, **kw)
    assert kern.launches == before + 1
    for a, b in zip(got, plain(x, bits=2, **kw)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_flash_kernel_at_mixtral_shapes(cuda):
    """B4 over a [2, 8, 8320, 128] bf16 raw cache, GQ 4, 8,180 tokens, one
    row left-padded by 200, no window."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    spec = TC.CacheSpec(batch=2, num_kv_heads=8, head_dim=128, max_len=8320)
    k = torch.randn((2, 8, 8320, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((2, 8, 8320, 128), generator=gen, device=cuda).bfloat16()
    c = llama.RawLayerCache(k=k, v=v, length=8180)
    q = torch.randn((2, 32, 1, 128), generator=gen, device=cuda)
    pad = torch.tensor([0, 200], dtype=torch.int32, device=cuda)
    before = TF.flash_decode.launches
    got = TF.raw_attend_flash(spec, c, q, pad_start=pad)
    assert TF.flash_decode.launches == before + 1
    want = llama.raw_attend(spec, c, q, pad_start=pad)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("compress", [True, False], ids=["fused", "raw"])
def test_small_mixtral_on_the_card_matches_the_cpu(cuda, compress):
    """A tiny bf16 Mixtral (the kernels take bf16 caches), GEAR int4:
    prefill and 20 decode steps (a flush at 16) on the card (kernels) and on
    the CPU (plain path), the same inits and tokens: logits within the
    lockstep limit of each other."""
    from gear_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.tiny(hidden_size=128, head_dim=32)
    params = mixtral.init_params(cfg, seed=5, device="cpu")
    comp = CompressionConfig(num_layers=cfg.num_layers, quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=2)
    spec = cfg.cache_spec(2, 64, comp.layer(0))
    tokens = torch.tensor([[0, 0, 5, 9, 2, 7, 11, 3], [4, 1, 6, 8, 2, 5, 7,
                                                       9]])
    mask = (torch.arange(8) >= torch.tensor([[2], [0]])).long()
    pos = torch.clamp(mask.cumsum(1) - 1, min=0)

    def init(site, shape):  # the same power-iteration inits on both sides
        g = torch.Generator().manual_seed(hash(site) % (1 << 31))
        return torch.rand(shape, generator=g)

    runs, toks = {}, None
    for dev in (torch.device("cpu"), cuda):  # the CPU's tokens feed both
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        logits, caches = mixtral.forward_prefill(
            p, cfg, tokens.to(dev), pos.to(dev), mask.to(dev), spec,
            compress=compress, init=init)
        out = [logits[:, -1].cpu()]
        if toks is None:
            toks = [out[0].argmax(-1)]
        for step in range(20):
            lg, caches = mixtral.forward_decode(
                p, cfg, toks[step].to(dev), (mask.sum(1) + step).to(dev),
                caches, spec=spec, compress=compress,
                pad_start=torch.tensor([2, 0], device=dev), init=init,
                step=step)
            out.append(lg.cpu())
            if len(toks) <= step + 1:
                toks.append(out[-1].argmax(-1))
        runs[dev.type] = torch.stack(out)
    err = (runs["cuda"] - runs["cpu"]).abs().max() / runs["cpu"].abs().max()
    assert float(err) < chip_smoke.LOCKSTEP_LIMIT


@pytest.mark.parametrize("name,kw,hkv,hq,b,t,n_prefill,pad,window", [
    ("llama tp", dict(), 16, 16, 4, 1152, 1024, [24, 0, 47, 13], None),
    ("mistral tp", dict(outliers_per_block=162), 4, 16, 2, 4480, 4352,
     [0, 130], 4096),
])
def test_decode_kernel_at_tp_rank_shapes(cuda, name, kw, hkv, hq, b, t,
                                         n_prefill, pad, window):
    """B1 at the shapes one of two tensor-parallel ranks gives it: the
    Llama-2-7B path's 16 of 32 kv heads, and Mistral-7B's 4 of 8 kv heads
    with 16 query heads (GQ 4), 2% outliers and the window; a cache from the
    port's prefill and 70 appends across a flush."""
    spec = TC.CacheSpec(batch=b, num_kv_heads=hkv, head_dim=128, max_len=t,
                        bits=4, group=64, rank=2, prefill_rank=4,
                        lowrank_loop=3, **kw)
    gen = torch.Generator(device=cuda).manual_seed(11)
    shape = (b, hkv, n_prefill, 128)
    k = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    cache = TC.prefill(spec, k, v, generator=gen)
    for _ in range(70):
        kn = torch.randn((b, hkv, 1, 128), generator=gen, device=cuda)
        TC.append(spec, cache, kn.bfloat16(), (kn * 0.5).bfloat16(),
                  generator=gen)
    assert cache.comp_len > cache.prefill_len
    q = torch.randn((b, hq, 1, 128), generator=gen, device=cuda)
    pad_t = torch.tensor(pad, dtype=torch.int32, device=cuda)
    before = TK.decode_attention.launches
    got = TK.attend_fused(spec, cache, q, pad_start=pad_t, window=window)
    assert TK.decode_attention.launches == before + 1
    want = TC.attend(spec, cache, q, pad_start=pad_t, window=window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


def test_tensor_parallel_step_on_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0: a fused prefill and decode step, tensor
    parallel, against the unsharded one on the card (bf16 weights: within
    the lockstep limit), B1 and the packs launched at 2 kv heads a rank."""
    from test_torch_parallel_procs import _spawn

    for res in _spawn(tmp_path, "cuda_tp", 2):
        assert res["hkv"] == 2
        assert res["counts"]["decode_attention"] == 2
        assert res["counts"]["quant_pack_tokens"] == 2
        assert res["err"] < chip_smoke.LOCKSTEP_LIMIT


# The decode step as a CUDA graph (``engine.InferenceEngine``): replayed
# against the eager step, and B1 / B4 with their lengths in device memory
# against their launches with host lengths.

def _site_inits(device):
    """Power-iteration inits drawn from a seed of the site alone, so that
    two runs of the same steps draw the same."""
    def init(site, shape):
        gen = torch.Generator(device=device).manual_seed(
            zlib.crc32(repr(site).encode()))
        return torch.rand(shape, generator=gen, device=device)
    return init


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_graph_decode_matches_eager(cuda, mode):
    """A Mistral-like model (window 160; fused: GEAR int4, 5% outliers,
    group 16), prompts of 110 and 30 tokens in a bucket of 112, decoded as
    the benchmark's window decodes: 70 greedy steps from the prompt pass's
    cache, a restore of its device copy, 70 steps again (each 70 hold four
    flushes in fused mode; the window binds from step 48). The engine
    replays a graph; the eager steps are ``llama.forward_decode`` and an
    argmax. Tokens and logits equal at every step; the returned tokens are
    distinct tensors; one capture, a replay for every step that neither
    flushes nor comes before the capture; the engine's kernel launches
    count as the eager steps' do."""
    cfg = mistral.tiny(head_dim=32, hidden_size=128, num_heads=4,
                       sliding_window=160)
    params = llama.init_params(cfg, device=cuda)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=2,
                             left=0.05)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=192, mode=mode), batch_size=2)
    init = _site_inits(cuda)
    tokens, mask = eng.left_pad([list(range(3, 113)), list(range(40, 70))],
                                0, 112)
    logits, caches = eng.prefill(tokens, mask, init=init)
    tok0 = logits[:, -1].argmax(-1)
    prompt_len = mask.sum(1).to(torch.int32)
    pad = (112 - prompt_len).to(torch.int32)
    snap = {k: v.clone() if torch.is_tensor(v) else v
            for k, v in vars(caches).items()}
    ref = type(caches)(**{k: v.clone() if torch.is_tensor(v) else v
                          for k, v in vars(caches).items()})
    kernels.reset_launch_counts()
    served, want = [], []
    for _ in range(2):
        for k, v in snap.items():   # the benchmark's restore
            if torch.is_tensor(v):
                getattr(caches, k).copy_(v)
            else:
                setattr(caches, k, v)
        cur = cur_ref = tok0
        for j in range(70):
            pos = prompt_len + j
            cur, lg, caches = eng.decode_step(caches, cur, pos, pad, step=j,
                                              init=init)
            lg_ref, ref = llama.forward_decode(
                params, cfg, cur_ref, pos, ref, spec=eng.spec,
                compress=mode == "fused", pad_start=pad, init=init, step=j)
            cur_ref = lg_ref.argmax(-1)
            assert torch.equal(cur, cur_ref), j
            assert torch.equal(lg, lg_ref), j
            served.append(cur)
            want.append(cur_ref)
        for k, v in vars(ref).items():   # the reference restarts too
            if torch.is_tensor(v):
                v.copy_(snap[k])
            else:
                setattr(ref, k, snap[k])
    counts = kernels.launch_counts()
    assert len({t.data_ptr() for t in served}) == len(served)
    assert torch.equal(torch.stack(served), torch.stack(want))
    flushes = 8 if mode == "fused" else 0
    assert eng.graph_captures == 1
    assert eng.graph_replays == 140 - flushes - 2
    assert eng.eager_steps == flushes + 1
    name = "decode_attention" if mode == "fused" else "flash_decode"
    assert counts[name] == 2 * cfg.num_layers * 140   # engine and reference


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_mixtral_graph_decode_matches_eager(cuda, mode):
    """The engine over a small Mixtral on one card (4 experts, top 2,
    GEAR int4 or raw): 70 greedy steps replayed from a graph against
    ``mixtral.forward_decode`` run eagerly, tokens and logits bit-equal;
    one capture, a replay for every step that neither flushes nor comes
    before the capture."""
    from gear_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.tiny(hidden_size=128, num_heads=4,
                                     num_kv_heads=2, head_dim=32,
                                     num_experts=4)
    params = mixtral.init_params(cfg, seed=2, device=cuda)
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=16, rank=2, prefill_rank=4, loop=2,
                             left=0.05)
    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=192, mode=mode), batch_size=2)
    init = _site_inits(cuda)
    tokens, mask = eng.left_pad([list(range(3, 113)), list(range(40, 70))],
                                0, 112)
    logits, caches = eng.prefill(tokens, mask, init=init)
    cur = cur_ref = logits[:, -1].argmax(-1)
    prompt_len = mask.sum(1).to(torch.int32)
    pad = (112 - prompt_len).to(torch.int32)
    ref = type(caches)(**{k: v.clone() if torch.is_tensor(v) else v
                          for k, v in vars(caches).items()})
    for j in range(70):
        pos = prompt_len + j
        cur, lg, caches = eng.decode_step(caches, cur, pos, pad, step=j,
                                          init=init)
        lg_ref, ref = mixtral.forward_decode(
            params, cfg, cur_ref, pos, ref, spec=eng.spec,
            compress=mode == "fused", pad_start=pad, init=init, step=j)
        cur_ref = lg_ref.argmax(-1)
        assert torch.equal(cur, cur_ref), j
        assert torch.equal(lg, lg_ref), j
    flushes = 4 if mode == "fused" else 0
    assert eng.graph_captures == 1
    assert eng.graph_replays == 70 - flushes - 2


# The three benchmark cells' shapes where the decode step launches a kernel
# (rows, query rows per row, the lengths it attends in a window, the
# capacity): tiles a split for the length and for the capacity. The grid is
# sized from the capacity; the same tiles a split keep the split partition,
# and with it the outputs, as a grid sized from the length would have them.
CELL_SPLITS = {
    # mistral7b-gear4-decode-4k: batch 16 x 8 kv heads, int4, GEAR outliers
    "gear4": (128, 4, 4, range(4352, 4609, 64), 4608, 4),
    # mixtral8x7b-gear2-tp4-8k, one rank: batch 16 x 2 kv heads, int2
    "mixtral": (32, 4, 2, range(8192, 8449, 64), 8448, 4),
}


@pytest.mark.parametrize("comp_len,resid_len,window", [
    (512, 63, None), (576, 1, None), (576, 63, 300), (576, 1, 300),
    (None, None, None)],
    ids=["before_flush", "after_flush", "before_flush_window",
         "after_flush_window", "cell_splits"])
def test_decode_kernel_reads_device_lengths(cuda, comp_len, resid_len,
                                            window):
    """B1 in a decode step: lengths staged in device memory before the
    step, the append at the slot they name, the kernel's grid sized from
    the capacity; against the plain ``cache.attend`` over the host lengths,
    with the residual tier just before and just after a flush, with and
    without a window that binds; GEAR's outliers, a prefill of 512 tokens,
    padding. ``cell_splits``: the benchmark cells' tiles a split, the same
    for each length and for the capacity."""
    if comp_len is None:
        for rows, gq, bits, lengths, cap, per in CELL_SPLITS.values():
            bps = TK.blocks_per_sm(TK.decode_smem_bytes(
                gq, 128, bits, 4, 64, 64, 256, False, False))
            for n_tok in (*lengths, cap):
                assert TK.splits(n_tok, rows, TK.sm_count(cuda), bps,
                                 TK.MAX_TILES)[1] == per, (rows, n_tok)
        return
    spec = TC.CacheSpec(batch=2, num_kv_heads=4, head_dim=128, max_len=1024,
                        bits=4, group=64, outliers_per_block=162)
    gen = torch.Generator(device=cuda).manual_seed(12)
    n = comp_len + resid_len
    k = torch.randn((2, 4, n, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((2, 4, n, 128), generator=gen, device=cuda).bfloat16()
    cache = TC.prefill(spec, k[:, :, :512], v[:, :, :512], generator=gen)
    for t in range(512, n - 1):
        TC.append(spec, cache, k[:, :, t:t + 1], v[:, :, t:t + 1],
                  generator=gen)
    lens = TC.StepLens.stage(spec, cache, window)
    TC.append(spec, cache, k[:, :, -1:], v[:, :, -1:], generator=gen,
              index=lens.index)
    assert (cache.comp_len, cache.resid_len) == (comp_len, resid_len)
    q = torch.randn((2, 16, 1, 128), generator=gen, device=cuda)
    pad = torch.tensor([0, 200], dtype=torch.int32, device=cuda)
    before = TK.decode_attention.launches
    got = TK.attend_fused(spec, cache, q, pad_start=pad, window=window,
                          lens=lens)
    assert TK.decode_attention.launches == before + 1
    want = TC.attend(spec, cache, q, pad_start=pad, window=window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("length,window", [
    (575, None), (576, None), (129, None), (575, 300), (577, 300),
    (None, None)])
def test_flash_kernel_reads_device_lengths(cuda, length, window):
    """B4 in a decode step: the length staged in device memory before the
    step, the append at the slot it names, the kernel's grid sized from the
    capacity; against the plain ``raw_attend`` over the host length, with
    and without a window that binds. The last case: the raw cell's
    (mistral7b-raw-decode-4k: batch 16 x 8 kv heads, GQ 4) tiles a split,
    the same for each length of its window and for the capacity."""
    if length is None:
        for n_tok in (*range(4352, 4609), 4608):
            assert TK.splits(n_tok, 128, TK.sm_count(cuda),
                             TF.BLOCKS_PER_SM)[1] == 12, n_tok
        return
    spec = TC.CacheSpec(batch=2, num_kv_heads=4, head_dim=128, max_len=1024)
    gen = torch.Generator(device=cuda).manual_seed(13)
    k = torch.randn((2, 4, 1024, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((2, 4, 1024, 128), generator=gen, device=cuda).bfloat16()
    c = llama.RawLayerCache(k=k, v=v, length=length - 1)
    lens = TC.StepLens.stage(spec, c, window)
    kn = torch.randn((2, 4, 1, 128), generator=gen, device=cuda).bfloat16()
    llama.raw_append(spec, c, kn, kn * 0.5, index=lens.index)
    q = torch.randn((2, 16, 1, 128), generator=gen, device=cuda)
    pad = torch.tensor([0, 200], dtype=torch.int32, device=cuda)
    before = TF.flash_decode.launches
    got = TF.raw_attend_flash(spec, c, q, pad_start=pad, window=window,
                              lens=lens)
    assert TF.flash_decode.launches == before + 1
    # a row with no token to attend (pad past the length): the plain
    # version's NaN, the kernel's zero
    want = llama.raw_attend(spec, c, q, pad_start=pad, window=window)
    torch.testing.assert_close(got, want.nan_to_num(0.0), rtol=1e-3,
                               atol=1e-4)


def test_sharded_mixtral_graph_over_nccl(cuda, tmp_path):
    """A TP/EP 2 Mixtral on two cards over nccl, fused (GEAR int4, eight
    flushes) and raw: each rank's replayed steps give the eager step's
    tokens and logits bit for bit; one capture, a replay for every step
    that neither flushes nor comes before the capture, and the replays'
    collectives counted as the eager steps' (two all-reduces a layer and
    the logits' gather a step)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a card per rank")
    from test_torch_mixtral_engine import _spawn

    for res in _spawn(tmp_path, "nccl_graph", 2):
        assert res["capturable"]
        for mode in ("fused", "raw"):
            r = res[mode]
            assert r["tokens_equal"] and r["logits_equal"], (mode, r)
            assert r["captures"] == 1
            assert r["replays"] == 140 - r["flushes"] - 2
            assert r["eager"] == r["flushes"] + 1
            # engine and eager reference: 140 steps each
            assert r["counts"]["calls"] == 2 * 140 * (2 * r["layers"] + 1)
