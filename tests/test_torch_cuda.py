"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture, so all workers collect the same tests). Run on the H100 with
``python -m pytest tests/test_torch_cuda.py -q -n 0``.
"""
import pytest
import torch

from gear_tpu_torch import cache as TC
from gear_tpu_torch import kernels
from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine
from gear_tpu_torch.kernels import decode as TK
from gear_tpu_torch.kernels import pack as TP
from gear_tpu_torch.models import llama

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
