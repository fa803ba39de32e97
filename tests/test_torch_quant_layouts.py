"""The port's packing layouts and KV quantization wrappers
(``gear_tpu_torch.core.quant``) against ``gear_tpu.core.quant`` on the CPU:
words bit for bit, with codes that set bit 31 of a word (so that the int32
word comes out negative in both packages), and the native codec's packs
through ctypes."""
import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.core import quant as J
from gear_tpu_torch.core import quant as T

NATIVE = Path(__file__).resolve().parents[1] / "native" / "libgearkv.so"
LAYOUTS = [("pack_codes", "unpack_codes"),
           ("pack_codes_strided", "unpack_codes_strided"),
           ("pack_codes_bytestrided", "unpack_codes_bytestrided")]


def _codes(rng, bits, shape=(3, 5, 64)):
    codes = rng.integers(0, 1 << bits, shape).astype(np.int32)
    codes[0] = (1 << bits) - 1  # every field of row 0 the top code: bit 31
    return codes


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("pack,unpack", LAYOUTS)
def test_layout_bit_exact_against_reference(rng, pack, unpack, bits):
    codes = _codes(rng, bits)
    want = np.asarray(getattr(J, pack)(jnp.asarray(codes), bits))
    got = getattr(T, pack)(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()  # bit 31 set: negative words in both packages
    back = getattr(T, unpack)(got, bits)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(getattr(J, unpack)(jnp.asarray(want), bits)))


def test_layouts_differ(rng):
    """The three layouts are three different word orders."""
    codes = torch.from_numpy(_codes(rng, 4))
    words = [getattr(T, p)(codes, 4) for p, _ in LAYOUTS]
    for i in range(3):
        for j in range(i):
            assert not torch.equal(words[i], words[j])


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_and_pack_against_reference(rng, bits):
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    # jitted, as the JAX engine runs it: XLA's step is (max - min) *
    # f32(1 / levels), the port's (ROADMAP C)
    jw, js, jm = jax.jit(J.quantize_and_pack, static_argnums=(1, 2))(
        jnp.asarray(x), bits, 32)
    tw, ts, tm = T.quantize_and_pack(torch.from_numpy(x), bits, 32)
    for t, j in ((tw, jw), (ts, js), (tm, jm)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got = T.unpack_and_dequantize(tw, ts, tm, bits, 32)
    want = J.unpack_and_dequantize(jw, js, jm, bits, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float((got - torch.from_numpy(x)).abs().max()) <= float(
        ts.max()) / 2 + 1e-6


@pytest.mark.parametrize("which", ["quant_kv_per_token",
                                   "quant_kv_per_channel"])
def test_kv_quant_wrappers_against_reference(rng, which):
    x = rng.standard_normal((2, 2, 64, 32)).astype(np.float32)
    want = jax.jit(getattr(J, which), static_argnums=(1, 2))(
        jnp.asarray(x), 4, 16)
    got = getattr(T, which)(torch.from_numpy(x), 4, 16)
    for t, j in zip(got, want):
        assert t.shape == tuple(j.shape)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _native():
    if not NATIVE.exists():
        pytest.skip("native/libgearkv.so not built (make -C native)")
    return ctypes.CDLL(str(NATIVE))


@pytest.mark.parametrize("bits", [2, 4])
def test_native_pack_is_the_bytestrided_layout(rng, bits):
    """``gear_pack_u4`` / ``gear_pack_u2`` write the BYTE-STRIDED layout
    (kvcodec.cc's pack_strided), whatever its header comment says: they
    equal :func:`pack_codes_bytestrided` and not :func:`pack_codes_strided`;
    ``gear_unpack_*`` inverts them."""
    lib = _native()
    rows, n = 6, 128
    codes = _codes(rng, bits, (rows, n)).astype(np.uint8)
    words = np.zeros((rows, n * bits // 32), np.uint32)
    pack = getattr(lib, f"gear_pack_u{bits}")
    pack.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_int64]
    pack.restype = None
    pack(codes.ctypes.data, words.ctypes.data, rows, n)
    tc = torch.from_numpy(codes.astype(np.int32))
    np.testing.assert_array_equal(
        words.view(np.int32), T.pack_codes_bytestrided(tc, bits).numpy())
    assert not np.array_equal(words.view(np.int32),
                              T.pack_codes_strided(tc, bits).numpy())
    back = np.zeros_like(codes)
    unpack = getattr(lib, f"gear_unpack_u{bits}")
    unpack.argtypes = pack.argtypes
    unpack.restype = None
    unpack(words.ctypes.data, back.ctypes.data, rows, n)
    np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("fn,args", [
    ("pack_codes", (torch.zeros(4, 16, dtype=torch.int32), 3)),
    ("unpack_codes", (torch.zeros(4, 2, dtype=torch.int32), 16)),
    ("pack_codes_strided", (torch.zeros(4, 16, dtype=torch.int32), 1)),
    ("unpack_codes_strided", (torch.zeros(4, 2, dtype=torch.int32), 5)),
    ("pack_codes", (torch.zeros(4, 12, dtype=torch.int32), 4)),
    ("pack_codes_strided", (torch.zeros(4, 6, dtype=torch.int32), 2)),
    ("pack_codes_bytestrided", (torch.zeros(4, 20, dtype=torch.int32), 4)),
])
def test_value_errors_as_reference(fn, args):
    """Bits outside {2, 4, 8} and a length the word does not divide raise
    ``ValueError`` in both packages."""
    with pytest.raises(ValueError):
        getattr(T, fn)(*args)
    with pytest.raises(ValueError):
        getattr(J, fn)(jnp.asarray(args[0].numpy()), args[1])
