"""The port's runtime (``gear_tpu_torch.runtime``) against gear_tpu's on the
CPU: KV-cache snapshots that load in either package with every leaf
bit-equal and are written byte for byte alike, through the native codec
and through the numpy one; and numeric-fault counts keyed as gear_tpu keys
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu.models import llama as jllama
from gear_tpu.runtime import faults as jfaults
from gear_tpu.runtime import kvstore as jkv
from gear_tpu_torch import cache as TC
from gear_tpu_torch import convert
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.runtime import faults as tfaults
from gear_tpu_torch.runtime import kvstore as tkv

KW = dict(batch=1, num_kv_heads=2, head_dim=32, max_len=128, bits=4,
          group=32, rank=2, prefill_rank=4, lowrank_loop=2)


@pytest.fixture(params=["native", "numpy"])
def codec(request, monkeypatch):
    """Run a case with the native codec, then with the numpy framing in
    both packages."""
    if request.param == "numpy":
        monkeypatch.setattr(tkv, "_find_lib", lambda: None)
        monkeypatch.setattr(jkv, "_find_lib", lambda: None)
    else:
        assert tkv.native_available() and jkv.native_available()
    return request.param


def _jax_cache(rng, dtype=jnp.float32, s=96, outliers=0, **kw):
    spec = C.CacheSpec(**{**KW, **kw}, outliers_per_block=outliers,
                       dtype=dtype, sideband_dtype=dtype)
    shape = (spec.batch, spec.num_kv_heads, s, spec.head_dim)
    k = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    return spec, C.prefill(spec, k.astype(dtype), v.astype(dtype))


def _to_port(jc):
    return convert.cache_from_numpy(
        {f: np.asarray(getattr(jc, f))
         for f in TC.TENSOR_FIELDS + TC.LENGTH_FIELDS})


def _stack(*caches):  # what lax.scan over layers gives: lengths [L]
    return jax.tree.map(lambda *x: jnp.stack(x), *caches)


def _port_spec(spec):
    dt = torch.bfloat16 if spec.dtype == jnp.bfloat16 else torch.float32
    return TC.CacheSpec(**{**KW, "batch": spec.batch,
                           "num_kv_heads": spec.num_kv_heads,
                           "head_dim": spec.head_dim,
                           "max_len": spec.max_len},
                        outliers_per_block=spec.outliers_per_block,
                        dtype=dt, sideband_dtype=dt)


def _assert_equal_leaves(tcache, jleaves):
    tleaves = [getattr(tcache, f) for f in TC.TENSOR_FIELDS]
    for f, t, j in zip(TC.TENSOR_FIELDS, tleaves, jleaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, f
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16), err_msg=f)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
    lengths = [np.asarray(j) for j in jleaves[len(TC.TENSOR_FIELDS):]]
    for f, j in zip(TC.LENGTH_FIELDS, lengths):
        assert (j == getattr(tcache, f)).all(), f


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_roundtrip_exact(rng, tmp_path, codec, dtype):
    spec, jc = _jax_cache(rng, dtype=dtype)
    tc = _to_port(jc)
    p = tkv.save_cache(tmp_path / "snap.gear", tc)
    back = tkv.load_cache(p, TC.init_layer_cache(_port_spec(spec)))
    _assert_equal_leaves(back, jax.tree.leaves(jc))
    assert back.k_scale.dtype == tc.k_scale.dtype


def test_corruption_detected(rng, tmp_path, codec):
    _, jc = _jax_cache(rng)
    tc = _to_port(jc)
    p = tkv.save_cache(tmp_path / "snap.gear", tc)
    data = bytearray(p.read_bytes())
    data[200] ^= 0xFF  # a payload byte
    p.write_bytes(bytes(data))
    with pytest.raises(IOError):
        tkv.load_cache(p, tc)


def test_snapshot_below_half_the_fp16_bytes(rng, tmp_path):
    """At production dtypes (bf16 sidebands) the snapshot is under half the
    fp16 KV bytes, as in gear_tpu's test."""
    spec, jc = _jax_cache(rng, dtype=jnp.bfloat16, s=1024, batch=1,
                          num_kv_heads=4, head_dim=128, max_len=1024, bits=4,
                          group=64)
    p = tkv.save_cache(tmp_path / "snap.gear", _to_port(jc))
    assert p.stat().st_size < spec.bytes_fp16_baseline() / 2


@pytest.mark.parametrize("stacked", [False, True])
def test_reference_snapshot_loads_in_the_port(rng, tmp_path, codec, stacked):
    """One layer (lengths of shape ()) and a stack of two (lengths [2]),
    GEAR with outliers, written by gear_tpu: every leaf bit-equal in the
    port, and the port's attend over it agrees with gear_tpu's."""
    spec, a = _jax_cache(rng, outliers=40)
    _, b = _jax_cache(rng, outliers=40)
    jc = _stack(a, b) if stacked else a
    p = jkv.save_cache(tmp_path / "ref.gear", jc)
    tspec = _port_spec(spec)
    like = (TC.init_stacked(tspec, 2) if stacked
            else TC.init_layer_cache(tspec))
    back = tkv.load_cache(p, like)
    _assert_equal_leaves(back, jax.tree.leaves(jc))
    q = rng.standard_normal((1, 4, 1, 32)).astype(np.float32)
    for i in range(2 if stacked else 1):
        jl = jax.tree.map(lambda x: x[i], jc) if stacked else jc
        tl = back.layer(i) if stacked else back
        want = C.attend(spec, jl, jnp.asarray(q))
        got = TC.attend(tspec, tl, torch.from_numpy(q))
        # the tolerance of tests/test_torch_cache.py's attend parity
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                   atol=8e-3)


@pytest.mark.parametrize("stacked", [False, True])
def test_port_snapshot_loads_in_the_reference(rng, tmp_path, codec,
                                              stacked):
    spec, a = _jax_cache(rng, dtype=jnp.bfloat16)
    _, b = _jax_cache(rng, dtype=jnp.bfloat16)
    jc = _stack(a, b) if stacked else a
    tc = _to_port(jc)
    p = tkv.save_cache(tmp_path / "port.gear", tc)
    back = jkv.load_cache(p, jc)
    _assert_equal_leaves(tc, jax.tree.leaves(back))
    for x, y in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape


@pytest.mark.parametrize("stacked", [False, True])
def test_both_packages_write_the_same_bytes(rng, tmp_path, codec, stacked):
    spec, a = _jax_cache(rng, dtype=jnp.bfloat16, outliers=40)
    _, b = _jax_cache(rng, dtype=jnp.bfloat16, outliers=40)
    jc = _stack(a, b) if stacked else a
    pj = jkv.save_cache(tmp_path / "ref.gear", jc)
    pt = tkv.save_cache(tmp_path / "port.gear", _to_port(jc))
    assert pj.read_bytes() == pt.read_bytes()


@pytest.mark.parametrize("stacked", [False, True])
def test_raw_cache_across_packages(rng, tmp_path, codec, stacked):
    """The raw bf16 cache: gear_tpu's file is the port's, and loads back
    bit-equal either way."""
    spec = C.CacheSpec(**KW, dtype=jnp.bfloat16)
    shape = (1, 2, 40, 32)
    k = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    jr = jllama.raw_prefill(spec, k, v)
    jr = _stack(jr, jr) if stacked else jr
    tr = tllama.RawLayerCache(k=convert._tensor(np.asarray(jr.k), "cpu"),
                              v=convert._tensor(np.asarray(jr.v), "cpu"),
                              length=40)
    pj = jkv.save_cache(tmp_path / "ref.gear", jr)
    pt = tkv.save_cache(tmp_path / "port.gear", tr)
    assert pj.read_bytes() == pt.read_bytes()
    like = tllama.RawLayerCache(k=torch.zeros_like(tr.k),
                                v=torch.zeros_like(tr.v))
    back = tkv.load_cache(pj, like)
    assert back.length == 40 and back.k.dtype == torch.bfloat16
    assert torch.equal(back.k, tr.k) and torch.equal(back.v, tr.v)


def test_snapshot_that_does_not_fit_raises(rng, tmp_path):
    spec, jc = _jax_cache(rng)
    p = tkv.save_cache(tmp_path / "snap.gear", _to_port(jc))
    with pytest.raises(ValueError):  # a stack where one layer was written
        tkv.load_cache(p, TC.init_stacked(_port_spec(spec), 2))
    other = TC.CacheSpec(**{**KW, "max_len": 256})
    with pytest.raises(ValueError):  # another shape
        tkv.load_cache(p, TC.init_layer_cache(other))
    with pytest.raises(ValueError):  # more leaves than the snapshot
        tkv.load_cache(p, [TC.init_layer_cache(_port_spec(spec))] * 2)


def test_mixed_tree_roundtrip(rng, tmp_path):
    """A dict of caches and a tensor (keys sorted, as jax.tree.flatten
    orders them) comes back as it went."""
    spec, jc = _jax_cache(rng)
    tc = _to_port(jc)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tree = {"z": x, "a": [tc, None]}
    pj = jkv.save_cache(tmp_path / "ref.gear",
                        {"z": jnp.asarray(x.numpy()), "a": [jc, None]})
    pt = tkv.save_cache(tmp_path / "port.gear", tree)
    assert pj.read_bytes() == pt.read_bytes()
    back = tkv.load_cache(pt, tree)
    assert torch.equal(back["z"], x)
    _assert_equal_leaves(back["a"][0], jax.tree.leaves(jc))
    assert back["a"][1] is None


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def _poisoned(rng):
    cfg_j = jllama.ModelConfig.tiny(dtype=jnp.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    jp["layers"]["wq"] = jp["layers"]["wq"].at[0, 1, 2].set(jnp.nan)
    jp["lm_head"] = jp["lm_head"].at[3, 4].set(jnp.inf)
    _, jc = _jax_cache(rng, outliers=40)
    jc = jc.replace(k_scale=jc.k_scale.at[0, 0, 0, :3].set(jnp.nan))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    return ({"params": jp, "cache": jc},
            {"params": tp, "cache": _to_port(jc)})


def test_fault_counts_keyed_as_reference(rng):
    jtree, ttree = _poisoned(rng)
    want = {k: int(v) for k, v in jfaults.tree_nonfinite_counts(jtree).items()}
    got = {k: int(v) for k, v in tfaults.tree_nonfinite_counts(ttree).items()}
    assert list(got) == list(want)  # same keys, same order
    assert got == want
    assert got["['params']['layers']['wq']"] == 1
    assert got["['cache'].k_scale"] == 3
    assert "['cache'].k_codes" not in got  # int leaves are not counted
    raw = tllama.RawLayerCache(k=torch.zeros(1, 2, 4, 8),
                               v=torch.zeros(1, 2, 4, 8), length=2)
    assert list(tfaults.tree_nonfinite_counts([raw])) == ["[0].k", "[0].v"]


def test_fault_checks_raise_and_report(rng, capsys):
    jtree, ttree = _poisoned(rng)
    assert not bool(tfaults.tree_is_finite(ttree))
    assert bool(jfaults.tree_is_finite(jtree)) is False
    with pytest.raises(FloatingPointError, match="k_scale"):
        tfaults.check_or_raise(ttree, "after prefill")
    with pytest.raises(FloatingPointError):
        jfaults.check_or_raise(jtree, "after prefill")
    assert tfaults.guard(ttree, "step 3") is ttree
    assert "non-finite values detected step 3" in capsys.readouterr().out
    clean = {"cache": None, "x": torch.ones(3)}
    tfaults.check_or_raise(clean)
    assert bool(tfaults.tree_is_finite(clean))
    assert tfaults.guard(clean) is clean
    assert capsys.readouterr().out == ""
