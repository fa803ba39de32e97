"""The port's raw-mode attention (``kernels.flash``) against gear_tpu on the
CPU: there the wrapper computes its plain version, ``models.llama.raw_attend``,
which is held against the reference's Pallas flash kernel in interpret mode
(``pad_start``) and against the reference's ``raw_attend`` (``window``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu.kernels import flash as JF
from gear_tpu.models import llama as jllama
from gear_tpu_torch import cache as TC
from gear_tpu_torch.kernels import flash as TF
from gear_tpu_torch.models import llama as tllama


def _caches(rng, hkv, t, length, dtype):
    kw = dict(batch=2, num_kv_heads=hkv, head_dim=128, max_len=t, group=64)
    jspec = C.CacheSpec(**kw, dtype=jnp.dtype(dtype))
    tspec = TC.CacheSpec(**kw, dtype=getattr(torch, dtype))
    k = torch.from_numpy(rng.standard_normal((2, hkv, t, 128)).astype(
        np.float32)).to(tspec.dtype)
    v = torch.from_numpy(rng.standard_normal((2, hkv, t, 128)).astype(
        np.float32)).to(tspec.dtype)
    tc = tllama.RawLayerCache(k=k, v=v, length=length)
    jc = jllama.RawLayerCache(
        k=jnp.asarray(k.float().numpy(), jspec.dtype),
        v=jnp.asarray(v.float().numpy(), jspec.dtype),
        length=jnp.int32(length))
    return jspec, tspec, jc, tc


@pytest.mark.parametrize("hkv,hq,length,pad", [
    (2, 2, 200, None), (2, 8, 256, [0, 70]), (1, 4, 131, [130, 5])])
def test_raw_attend_flash_matches_reference_kernel(rng, hkv, hq, length, pad):
    jspec, tspec, jc, tc = _caches(rng, hkv, 256, length, "bfloat16")
    q = rng.standard_normal((2, hq, 1, 128)).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    tpad = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    got = TF.raw_attend_flash(tspec, tc, torch.from_numpy(q), pad_start=tpad)
    kern = JF.raw_attend_flash(jspec, jc, jnp.asarray(q), pad_start=jpad,
                               chunk=128, interpret=True)
    want = jllama.raw_attend(jspec, jc, jnp.asarray(q), pad_start=jpad)
    # float32 over the same bf16 cache; only the order of the sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # gear_tpu's own tolerance for its kernel (tests/test_flash_kernel.py):
    # it rounds q and p to bf16
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-2,
                               atol=2e-2)
    assert TF.flash_decode.launches == 0  # a CPU tensor takes the plain version


@pytest.mark.parametrize("window,pad", [(64, None), (100, [0, 180]),
                                        (500, [3, 9])])
def test_raw_attend_flash_window_matches_reference(rng, window, pad):
    jspec, tspec, jc, tc = _caches(rng, 2, 256, 222, "float32")
    q = rng.standard_normal((2, 4, 1, 128)).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    tpad = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    got = TF.raw_attend_flash(tspec, tc, torch.from_numpy(q), pad_start=tpad,
                              window=window)
    want = jllama.raw_attend(jspec, jc, jnp.asarray(q), pad_start=jpad,
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_decode_refuses_cpu_tensors():
    z = torch.zeros(2, 1, 128)
    kv = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_decode(10, torch.zeros(2, dtype=torch.int32), z, kv, kv)


def test_window_folds_into_pad_start_exactly():
    """What the wrappers hand the kernels on the card: max(pad, total -
    window), computed from host lengths."""
    from gear_tpu_torch.kernels import decode as TK

    pad = torch.tensor([0, 50, 200], dtype=torch.int32)
    assert TK.fold_window(pad, 100, 222, 3, "cpu").tolist() == [122, 122, 200]
    assert TK.fold_window(None, None, 222, 2, "cpu").tolist() == [0, 0]
    assert TK.fold_window(None, 4096, 222, 2, "cpu").tolist() == [0, 0]
    assert TK.fold_window(pad, None, 222, 3, "cpu").dtype == torch.int32
