"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture, so all workers collect the same tests). Run on the H100, where
there is no JAX for ``tests/conftest.py`` to import, with
``python -m pytest -c /dev/null --noconftest --rootdir . tests/test_torch_cuda.py -q``.
"""
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
