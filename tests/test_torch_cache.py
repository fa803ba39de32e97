"""Parity of the PyTorch port's compressed cache and its decode attention
with gear_tpu (CPU). Both packages get the same numpy K/V and the same
power-iteration inits (jax.random draws handed to the port)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu.kernels import decode as K
from gear_tpu_torch import cache as TC
from gear_tpu_torch import convert
from gear_tpu_torch.kernels import decode as TK


def _fields(cache) -> dict:
    return {f: np.asarray(getattr(cache, f))
            for f in TC.TENSOR_FIELDS + TC.LENGTH_FIELDS}


def _prefill_p0(key):
    """The port's p0 provider that mirrors gear_tpu.cache.prefill's draws."""
    kk, kv = jax.random.split(key)

    def p0(which, shape):
        k = kk if which == "k" else kv
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, dtype=jnp.float32)))
    return p0


def _append_p0(key, comp_len):
    """... and gear_tpu.cache.append's (fold in comp_len, then the flush's)."""
    kk, kv = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, comp_len), 0))

    def p0(which, shape):
        k = kk if which == "k" else kv
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, dtype=jnp.float32)))
    return p0


@pytest.mark.parametrize("bits", [2, 4])
def test_prefill_append_two_flushes_match_reference(rng, bits):
    kw = dict(batch=2, num_kv_heads=2, head_dim=32, max_len=128, bits=bits,
              group=16, rank=2, prefill_rank=4, lowrank_loop=2)
    jspec = C.CacheSpec(**kw, dtype=jnp.float32, sideband_dtype=jnp.float32)
    tspec = TC.CacheSpec(**kw, dtype=torch.float32,
                         sideband_dtype=torch.float32)
    shape = (2, 2, 40, 32)  # 2 blocks compressed + 8 residual tokens
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    # jitted, as the JAX engine runs it (see gear_tpu_torch/core/quant.py)
    jc = jax.jit(functools.partial(C.prefill, jspec))(
        jnp.asarray(k), jnp.asarray(v), key=key)
    tc = TC.prefill(tspec, torch.from_numpy(k), torch.from_numpy(v),
                    p0=_prefill_p0(key))
    japp = jax.jit(functools.partial(C.append, jspec))
    for i in range(27):  # flushes at comp_len 32 and 48, 3 tokens left over
        kn = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        vn = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        skey = jax.random.PRNGKey(100 + i)
        p0 = _append_p0(skey, tc.comp_len)
        jc = japp(jc, jnp.asarray(kn), jnp.asarray(vn), key=skey)
        TC.append(tspec, tc, torch.from_numpy(kn), torch.from_numpy(vn), p0=p0)
    assert (tc.comp_len, tc.resid_len, tc.prefill_len) == (64, 3, 32)
    want = _fields(jc)
    for f in TC.TENSOR_FIELDS:
        got = getattr(tc, f).numpy()
        assert got.shape == want[f].shape, f
        if f in ("kpt", "kqt", "vpt", "vqt"):
            np.testing.assert_allclose(got, want[f], rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got, want[f], err_msg=f)
    for f in TC.LENGTH_FIELDS:
        assert getattr(tc, f) == int(want[f]), f


def test_append_past_capacity_raises():
    spec = TC.CacheSpec(batch=1, num_kv_heads=1, head_dim=32, max_len=32,
                        group=16, dtype=torch.float32,
                        sideband_dtype=torch.float32)
    x = torch.randn(1, 1, 32, 32)
    cache = TC.prefill(spec, x, x)
    for _ in range(15):
        TC.append(spec, cache, x[:, :, :1], x[:, :, :1])
    with pytest.raises(ValueError):
        TC.append(spec, cache, x[:, :, :1], x[:, :, :1])


def _mk_spec(**kw):
    base = dict(batch=2, num_kv_heads=2, head_dim=128, max_len=256, bits=4,
                group=64, rank=2, prefill_rank=4, lowrank_loop=3)
    base.update(kw)
    return (C.CacheSpec(**base, dtype=jnp.float32, sideband_dtype=jnp.float32),
            TC.CacheSpec(**base, dtype=torch.float32,
                         sideband_dtype=torch.float32))


@pytest.mark.parametrize("bits,hq,s,pad", [
    (4, 2, 192 + 17, None),      # residual tier partly filled
    (2, 8, 256, [0, 70]),        # GQ = 4 and left padding
    (8, 4, 128, [5, 0]),         # GQ = 2, half-full prefix, padding
])
def test_plain_decode_matches_reference(rng, bits, hq, s, pad):
    jspec, tspec = _mk_spec(bits=bits)
    shape = (2, 2, s, 128)
    k = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    jc = C.prefill(jspec, k, v)
    tc = convert.cache_from_numpy(_fields(jc))
    q = rng.standard_normal((2, hq, 1, 128)).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    tpad = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    got = TK.attend_fused(tspec, tc, torch.from_numpy(q), pad_start=tpad)
    want_kernel = K.attend_fused(jspec, jc, jnp.asarray(q), pad_start=jpad,
                                 interpret=True)
    want_xla = C.attend(jspec, jc, jnp.asarray(q), pad_start=jpad)
    # the tolerance of gear_tpu's kernel tests (tests/test_decode_kernel.py):
    # its Pallas kernel computes in bf16 with f32 accumulation
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               rtol=2e-2, atol=8e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla),
                               rtol=2e-2, atol=8e-3)
    assert TK.decode_attention.launches == 0  # CPU takes the plain version


def test_dequantize_kv_matches_reference(rng):
    jspec, tspec = _mk_spec()
    shape = (2, 2, 192, 128)
    k = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    jc = C.prefill(jspec, k, k * 0.5)
    tc = convert.cache_from_numpy(_fields(jc))
    for w, t in zip(C.dequantize_kv(jspec, jc), TC.dequantize_kv(tspec, tc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
