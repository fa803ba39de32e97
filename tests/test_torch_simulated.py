"""Parity of the port's simulated (fake-quant) mode with gear_tpu on the CPU.

The same numpy K/V go through ``gear_tpu.core.simulated`` (jitted, as the
JAX engine runs it: XLA's ``* f32(1/levels)`` form of the step, which the
port follows) and ``gear_tpu_torch.core.simulated``; the port is handed the
``jax.random`` draws the reference makes for its power-iteration inits.
Outputs agree within float32 rounding (XLA on the CPU fuses ``code * scale
+ mn`` into one multiply-add, and the products sum in other orders). The
engines, on a tiny float32 Llama, give identical greedy tokens across
several recompressions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.core import lowrank as JL
from gear_tpu.core import quant as JQ
from gear_tpu.core import simulated as JS
from gear_tpu.engine import EngineConfig as JEngineConfig
from gear_tpu.engine import InferenceEngine as JEngine
from gear_tpu.models import llama as jllama
from gear_tpu_torch import convert
from gear_tpu_torch.config import METHODS
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.core import lowrank as TL
from gear_tpu_torch.core import quant as TQ
from gear_tpu_torch.core import simulated as TS
from gear_tpu_torch.engine import EngineConfig as TEngineConfig
from gear_tpu_torch.engine import InferenceEngine as TEngine
from gear_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-5, atol=1e-5)


def _uniform(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, dtype=jnp.float32)))


def _kv_p0(prng):
    """p0(which, shape): the draws gear_tpu's compress_kv makes from
    ``prng`` (split into a K and a V key)."""
    kk, kv = jax.random.split(prng)
    return lambda which, shape: _uniform(kk if which == "k" else kv, shape)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("levels", [None, 9])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quantize_groups_matches_reference(rng, bits, levels):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    x[0, 0, :16] = 0.5  # a constant group: the scale == 0 guard
    want = jax.jit(lambda a: JQ.fake_quantize_groups(
        a, bits, 16, levels=levels))(x)
    got = TQ.fake_quantize_groups(torch.from_numpy(x), bits, 16,
                                  levels=levels)
    _close(got, want)
    assert torch.equal(got[0, 0, :16], torch.full((16,), 0.5))


def test_low_rank_residual_matches_reference(rng):
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda a: JL.low_rank_residual(a, 3, 4, key))(x)
    got = TL.low_rank_residual(torch.from_numpy(x), 3, 4,
                               p0=_uniform(key, (2, 3, 16, 3)))
    _close(got, want)
    assert got.dtype == torch.float32


def _kv(rng, b=2, h=2, s=80, d=16, spikes=True):
    x = rng.standard_normal((b, h, s, d)).astype(np.float32)
    if spikes:  # a few large entries, for the outlier paths to find
        x += 6.0 * (rng.random(x.shape) < 0.01) * rng.standard_normal(x.shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("name,args,s", [
    ("fake_token_quant", (4, 16), 80), ("fake_token_quant", (2, 32), 80),
    ("fake_channel_quant", (4, 32), 80),   # 2 x 32 and a tail of 16
    ("fake_channel_quant", (8, 96), 80),   # shorter than a group
    ("outlier_token_quant", (4, 16, 0.2), 80),        # k = 3 a token
    ("outlier_channel_quant", (4, 32, 0.2), 80),      # k = 3 a channel
    ("outlier_channel_quant", (2, 16, 0.9), 8),       # k 14 capped at 8
])
def test_simulated_functions_match_reference(rng, name, args, s):
    x = _kv(rng, s=s)
    want = jax.jit(lambda a: getattr(JS, name)(a, *args))(x)
    got = getattr(TS, name)(torch.from_numpy(x), *args)
    assert got.shape == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("name", ["gear_token", "gear_channel",
                                  "gearl_token", "gearl_channel"])
def test_gear_recipes_match_reference(rng, name):
    x = _kv(rng)
    key = jax.random.PRNGKey(11)
    args = (4, 16) + ((0.2,) if name.startswith("gear_") else ()) + (2, 3)
    want = jax.jit(lambda a: getattr(JS, name)(a, *args, key))(x)
    got = getattr(TS, name)(torch.from_numpy(x), *args,
                            p0=_uniform(key, (2, 2, 16, 2)))
    _close(got, want)


@pytest.mark.parametrize("prefill", [True, False], ids=["prefill", "stream"])
@pytest.mark.parametrize("preserving", [False, True],
                         ids=["whole", "token_preserving"])
@pytest.mark.parametrize("method", METHODS)
def test_compress_kv_matches_reference(rng, method, preserving, prefill):
    kw = dict(compress_method=method, quantize_bit=4, group_size=16, rank=2,
              rankv=1, prefill_rank=3, prefill_rankv=2, loop=2, left=0.1,
              token_preserving=preserving, start_saving=0.1,
              locality_saving=0.15)
    jcfg, tcfg = JComp(**kw).layer(0), TComp(**kw).layer(0)
    k, v = _kv(rng, s=96), _kv(rng, s=96)
    prng = jax.random.PRNGKey(5)
    want = jax.jit(lambda a, b: JS.compress_kv(a, b, jcfg, prefill=prefill,
                                               prng=prng))(k, v)
    got = TS.compress_kv(torch.from_numpy(k), torch.from_numpy(v), tcfg,
                         prefill=prefill, p0=_kv_p0(prng))
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        _close(g, w)
    if method == "NONE":
        assert torch.equal(got[0], torch.from_numpy(k))
    if preserving and method != "NONE":  # the kept prefix and suffix as given
        lo, hi = int(0.1 * 96), 96 - int(0.15 * 96)
        assert torch.equal(got[1][:, :, :lo], torch.from_numpy(v[:, :, :lo]))
        assert torch.equal(got[1][:, :, hi:], torch.from_numpy(v[:, :, hi:]))
        assert not torch.equal(got[1][:, :, lo:hi],
                               torch.from_numpy(v[:, :, lo:hi]))


def test_compress_kv_refuses_unknown_method(rng):
    x = torch.from_numpy(_kv(rng))
    with pytest.raises(ValueError, match="unknown compress_method"):
        TS.compress_kv(x, x, TComp(compress_method="H2O").layer(0),
                       prefill=True)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.ModelConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


# gear_tpu's simulated engine compresses with compress_kv's default key,
# PRNGKey(0), at every site
_ENGINE_P0 = _kv_p0(jax.random.PRNGKey(0))


def _engine_init(site, shape):
    return _ENGINE_P0(site[-1], shape)


@pytest.mark.parametrize("method,grouping", [("GEAR", False),
                                             ("GEARL", True)])
def test_simulated_engine_matches_reference(tiny, method, grouping):
    """Greedy tokens through both engines, left-padded prompts, three
    recompressions (streaming_gap 4, 14 new tokens): of the newest gap
    tokens with stream_grouping, of the whole cache without. At int2 the
    tokens change when a recompression is left out (at int4 this tiny
    model's tokens do not)."""
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(num_layers=jcfg.num_layers, compress_method=method,
              quantize_bit=2, group_size=16, rank=2, prefill_rank=3, loop=2,
              left=0.1, streaming_gap=4, stream_grouping=grouping)
    prompts = [[5, 9, 2, 7, 11, 3, 8, 4, 1, 6, 12, 13, 14, 15, 16, 17, 18,
                19], [4, 1, 6, 20, 30]]
    jeng = JEngine(jcfg, jparams, JComp(**kw),
                   JEngineConfig(max_len=64, mode="simulated"), batch_size=2)
    teng = TEngine(tcfg, tparams, TComp(**kw),
                   TEngineConfig(max_len=64, mode="simulated"), batch_size=2,
                   device="cpu")
    want = jeng.generate(prompts, 14)
    got = teng.generate(prompts, 14, init=_engine_init)
    assert got == want

    # the compressed prompt is what the raw cache holds, and the prompt's
    # logits saw it: they differ from raw mode's
    tokens, mask = teng.left_pad(prompts, 0, 32)
    logits, caches = teng.prefill(tokens, mask, init=_engine_init)
    raw = TEngine(tcfg, tparams, TComp(**kw),
                  TEngineConfig(max_len=64, mode="raw"), batch_size=2,
                  device="cpu")
    raw_logits, raw_caches = raw.prefill(tokens, mask)
    assert caches.length == raw_caches.length == 32
    assert not torch.equal(caches.k, raw_caches.k)
    assert not torch.allclose(logits, raw_logits)


def test_simulated_none_is_raw_mode(tiny):
    """Method NONE compresses nothing: simulated mode's greedy tokens are
    raw mode's, and no recompression runs."""
    _, tcfg, _, tparams = tiny
    comp = TComp(num_layers=tcfg.num_layers, compress_method="NONE",
                 group_size=16, streaming_gap=4)
    prompts = [[5, 9, 2, 7], [4, 1, 6]]
    outs = [TEngine(tcfg, tparams, comp, TEngineConfig(max_len=64, mode=m),
                    batch_size=2, device="cpu").generate(prompts, 10)
            for m in ("simulated", "raw")]
    assert outs[0] == outs[1]
    assert not TEngine(tcfg, tparams, comp,
                       TEngineConfig(max_len=64, mode="simulated"),
                       batch_size=2, device="cpu").simulating
