"""Parity of the PyTorch port's quant, pack and low-rank primitives with
gear_tpu (CPU). Same numpy inputs through both packages; codes and
sidebands must be bit-exact, low-rank bases within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu import config as jconfig
from gear_tpu.core import lowrank as jlowrank
from gear_tpu.core import quant as jquant
from gear_tpu.kernels import pack as P
from gear_tpu_torch import cache as TC
from gear_tpu_torch import config as tconfig
from gear_tpu_torch.core import lowrank as tlowrank
from gear_tpu_torch.core import quant as tquant
from gear_tpu_torch.kernels import pack as TP


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_config_matches_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.CompressionConfig)
          if f.name != "overrides"]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.CompressionConfig)
          if f.name != "overrides"]
    assert jf == tf
    for method in ("GEAR", "GEARL", "KIVI_V2", "NONE"):
        kw = dict(compress_method=method, quantize_bit=2, num_layers=4,
                  overrides=((1, {"quantize_bit": 8}),))
        j, t = jconfig.CompressionConfig(**kw), tconfig.CompressionConfig(**kw)
        assert j.ratio(4096, 32, 128, 2) == t.ratio(4096, 32, 128, 2)
        assert [dataclasses.asdict(x) for x in j.per_layer()] == \
            [dataclasses.asdict(x) for x in t.per_layer()]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_and_bytestrided_pack_bit_exact(rng, bits):
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    x[0, 0, :64] = 1.5  # a constant group exercises the scale == 0 guard
    # jitted, as the JAX package runs it (see gear_tpu_torch/core/quant.py)
    jc, js, jm = jax.jit(lambda a: jquant.quantize_groups(a, bits, 64))(
        jnp.asarray(x))
    tc, ts, tm = tquant.quantize_groups(torch.from_numpy(x), bits, 64)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    jw = jquant.pack_codes_bytestrided(jc, bits)
    tw = tquant.pack_codes_bytestrided(tc, bits)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(
        _np(tquant.unpack_codes_bytestrided(tw, bits)),
        np.asarray(jquant.unpack_codes_bytestrided(jw, bits)))
    np.testing.assert_array_equal(_np(tquant.unpack_codes_bytestrided(tw, bits)),
                                  _np(tc))
    np.testing.assert_allclose(
        _np(tquant.dequantize_groups(tc, ts, tm, 64)),
        np.asarray(jquant.dequantize_groups(jc, js, jm, 64)), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_plain_versions_match_pallas_kernels(rng, bits):
    m, d, g = 128, 128, 64
    x = rng.standard_normal((m, d)).astype(np.float32)
    for jfn, tfn, kw in ((P.quant_pack_tokens, TP.quant_pack_tokens,
                          dict(v_group=g)),
                         (P.quant_pack_channels, TP.quant_pack_channels,
                          dict(group=g))):
        want = jfn(jnp.asarray(x), bits=bits, sideband_dtype=jnp.float32,
                   interpret=True, **kw)
        got = tfn(torch.from_numpy(x), bits=bits, **kw)
        for w, t in zip(want, got):
            assert tuple(t.shape) == tuple(w.shape)
            np.testing.assert_array_equal(_np(t), np.asarray(w))
    assert TP.quant_pack_tokens.launches == 0  # CPU takes the plain version


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_block_compressors_match_reference(rng, bits):
    kw = dict(batch=2, num_kv_heads=2, head_dim=128, max_len=256, bits=bits,
              group=64)
    jspec = C.CacheSpec(**kw)
    tspec = TC.CacheSpec(**kw)
    x = rng.standard_normal((2, 2, 128, 128)).astype(np.float32)
    for jfn, tfns in ((C._compress_k_block,
                       (TC._compress_k_block, TC._compress_k_block_pk)),
                      (C._compress_v_block,
                       (TC._compress_v_block, TC._compress_v_block_pk))):
        want = jax.jit(lambda a: jfn(jspec, a)[:3])(jnp.asarray(x))
        for tfn in tfns:
            got = tfn(tspec, torch.from_numpy(x))
            for w, t in zip(want, got):
                np.testing.assert_array_equal(_np(t.float()),
                                              np.asarray(w.astype(jnp.float32)))


def test_power_iterate_matches_reference(rng):
    x = rng.standard_normal((2, 3, 64, 16)).astype(np.float32)
    p0 = rng.random((2, 3, 16, 4)).astype(np.float32)
    jp, jq = jlowrank.power_iterate(jnp.asarray(x), 4, 3, p0=jnp.asarray(p0))
    tp, tq = tlowrank.power_iterate(torch.from_numpy(x), 4, 3,
                                    p0=torch.from_numpy(p0))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tq), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tlowrank.reconstruct(tp, tq)),
        np.asarray(jlowrank.reconstruct(jp, jq)), rtol=1e-5, atol=1e-5)
    # the unrolled Gram-Schmidt keeps the reference's column signs
    a = rng.standard_normal((5, 32, 6)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlowrank._thin_qr_q(torch.from_numpy(a))),
        np.asarray(jlowrank._thin_qr_q(jnp.asarray(a))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(outliers_per_block=32),
                                dict(base_bits=8), dict(kcvt_prefill=True)])
def test_unported_cache_options_raise(kw):
    """Outliers, int8 bases and KCVT scales build, as in the
    reference. Every engine mode is ported and builds; a mode the
    reference lacks raises."""
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.models import llama

    spec = TC.CacheSpec(batch=1, num_kv_heads=1, head_dim=128, max_len=128,
                        **kw)
    cache = TC.prefill(spec, torch.ones(1, 1, 70, 128), torch.ones(1, 1, 70, 128))
    assert (cache.comp_len, cache.resid_len) == (64, 6)
    cfg = llama.ModelConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    for mode in ("h2o", "sink", "simulated"):
        InferenceEngine(cfg, params, None, EngineConfig(mode=mode),
                        device="cpu")
    with pytest.raises(ValueError, match="unknown engine mode"):
        InferenceEngine(cfg, params, None, EngineConfig(mode="shard"),
                        device="cpu")
