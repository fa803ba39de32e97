"""The pack kernels (B3 tokens, B2 channels) read bf16 as well as float32
(CPU).

bf16 -> float32 is exact, so a bf16 block must give the words, scales and
minima the same values give as float32: against gear_tpu's Pallas kernels,
which convert inside (interpret mode, jitted as the reference runs it), and
through the port's prefill, which hands the packs the model's bf16 block
without outliers (K as a strided view of the model's [B, S, H, D]
projection) and the cleaned float32 block with them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.kernels import pack as P
from gear_tpu_torch import cache as TC
from gear_tpu_torch.kernels import pack as TP


@pytest.mark.parametrize("v_group", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_token_pack_of_bf16_matches_pallas_kernel(rng, bits, v_group):
    m, d = 48, 128
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(
        np.float32)).bfloat16()
    x[0, :v_group] = 1.5      # constant groups: the scale == 0 guard
    x[5, d - v_group:] = -0.25
    want = jax.jit(lambda a: P.quant_pack_tokens(
        a, bits=bits, v_group=v_group, sideband_dtype=jnp.float32,
        interpret=True))(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    got = TP.quant_pack_tokens_plain(x, bits=bits, v_group=v_group)
    as_f32 = TP.quant_pack_tokens_plain(x.float(), bits=bits, v_group=v_group)
    for w, g, f in zip(want, got, as_f32):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, f)
    assert float(got[1][0, 0]) == 0.0 and float(got[1][5, -1]) == 0.0


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_channel_pack_of_bf16_matches_pallas_kernel(rng, bits, group):
    s, d = 256, 128
    x = torch.from_numpy(rng.standard_normal((s, d)).astype(
        np.float32)).bfloat16()
    x[:group, 3] = 1.5        # constant channels: the scale == 0 guard
    x[s - group:, d - 1] = -0.25
    want = jax.jit(lambda a: P.quant_pack_channels(
        a, bits=bits, group=group, sideband_dtype=jnp.float32,
        interpret=True))(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    got = TP.quant_pack_channels_plain(x, bits=bits, group=group)
    as_f32 = TP.quant_pack_channels_plain(x.float(), bits=bits, group=group)
    for w, g, f in zip(want, got, as_f32):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, f)
    assert float(got[1][0, 0, 3]) == 0.0 and float(got[1][-1, 0, -1]) == 0.0


@pytest.mark.parametrize("method", ["GEARL", "GEAR"])
def test_k_block_of_bf16_matches_the_float32_route(rng, method):
    """The K block route of the card's prefill (``_compress_k_block_pk``)
    given the model's bf16 K, a [B, H, S, D] view of [B, S, H, D] memory as
    the projection leaves it, against the same values as a contiguous
    float32 block and against the plain route: every output bit for bit."""
    kw = dict(batch=2, num_kv_heads=3, head_dim=64, max_len=256, bits=4,
              group=32, rank=2, prefill_rank=4, lowrank_loop=2,
              outliers_per_block=40 if method == "GEAR" else 0)
    spec = TC.CacheSpec(**kw)
    k = torch.from_numpy(rng.standard_normal((2, 96, 3, 64)).astype(
        np.float32)).bfloat16().transpose(1, 2)
    assert not k.is_contiguous()
    as_bf16 = TC._compress_k_block_pk(spec, k)
    as_f32 = TC._compress_k_block_pk(spec, k.float().contiguous())
    plain = TC._compress_k_block(spec, k.float())
    for a, b, c in zip(as_bf16, as_f32, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("method", ["GEARL", "GEAR"])
def test_prefill_of_a_bf16_block_matches_the_float32_route(rng, method):
    """cache.prefill of bf16 K/V against the same values as float32: the
    codes and sidebands bit for bit (GEARL hands the pack the bf16 block as
    it is; GEAR its float32 block with the outliers replaced)."""
    kw = dict(batch=2, num_kv_heads=2, head_dim=64, max_len=256, bits=4,
              group=32, rank=2, prefill_rank=4, lowrank_loop=2,
              outliers_per_block=40 if method == "GEAR" else 0)
    spec = TC.CacheSpec(**kw)
    k = torch.from_numpy(rng.standard_normal((2, 2, 100, 64)).astype(
        np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((2, 2, 100, 64)).astype(
        np.float32)).bfloat16()
    as_bf16 = TC._compress_v_block_pk(spec, v[:, :, :96])
    as_f32 = TC._compress_v_block_pk(spec, v[:, :, :96].float())
    for a, b in zip(as_bf16, as_f32):
        assert torch.equal(a, b)
    runs = [TC.prefill(spec, x, y, generator=torch.Generator().manual_seed(0))
            for x, y in ((k, v), (k.float(), v.float()))]
    for f in ("k_codes", "k_scale", "k_mn", "v_codes", "v_scale", "v_mn",
              "k_out_idx", "k_out_val", "v_out_idx", "v_out_val",
              "k_out_bnd", "v_out_bnd"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
