"""Parity of the port's full GEAR cache (COO outliers, int8 bases, KCVT, the
sliding window, partial-state attention) with gear_tpu on the CPU.

Both packages get the same numpy inputs and the same power-iteration inits.
The JAX side is jitted, as its engine runs it. Policy for caches with
outliers: outlier indices and boundary tables are bit-equal; codes and
sidebands are bit-equal away from outlier positions. At an outlier position
the stored code quantizes the block mean, which XLA and torch sum in
different orders, so there the code may differ by one and the delta with it;
the restored value agrees to float32 rounding either way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu.core import outliers as JO
from gear_tpu.kernels import decode as K
from gear_tpu_torch import cache as TC
from gear_tpu_torch import convert
from gear_tpu_torch.core import outliers as TO
from gear_tpu_torch.core import quant as TQ
from gear_tpu_torch.kernels import decode as TK
from test_torch_cache import _append_p0, _fields, _prefill_p0


def _specs(**kw):
    base = dict(batch=2, num_kv_heads=2, head_dim=32, max_len=128, bits=4,
                group=16, rank=2, prefill_rank=4, lowrank_loop=2)
    base.update(kw)
    return (C.CacheSpec(**base, dtype=jnp.float32, sideband_dtype=jnp.float32),
            TC.CacheSpec(**base, dtype=torch.float32,
                         sideband_dtype=torch.float32))


# --- CacheSpec ------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("kw", [
    dict(), dict(outliers_per_block=162), dict(base_bits=8),
    dict(outliers_per_block=40, base_bits=8, rank=0, prefill_rank=0)],
    ids=["gearl", "gear", "base8", "gear_base8_rank0"])
def test_cache_spec_sizes_match_reference(head_dim, kw):
    base = dict(batch=3, num_kv_heads=4, head_dim=head_dim, max_len=512,
                bits=4, group=64, **kw)
    js = C.CacheSpec(**base)
    ts = TC.CacheSpec(**base)
    assert ts.ko_store == js.ko_store
    assert ts.bnd_lanes == js.bnd_lanes
    assert ts.r_store == js.r_store
    assert ts.bytes_compressed() == js.bytes_compressed()
    assert ts.bytes_fp16_baseline() == js.bytes_fp16_baseline()
    tc = TC.init_layer_cache(ts)
    jc = C.init_layer_cache(js)
    for f in TC.TENSOR_FIELDS:
        assert tuple(getattr(tc, f).shape) == getattr(jc, f).shape, f
    assert tc.kpt.dtype == (torch.int8 if kw.get("base_bits") == 8
                            else torch.bfloat16)


@pytest.mark.parametrize("kw", [
    dict(outliers_per_block=3), dict(outliers_per_block=64 * 128),
    dict(outliers_per_block=2, group=1024, max_len=1024), dict(base_bits=4)])
def test_cache_spec_refuses_what_the_reference_refuses(kw):
    base = dict(batch=1, num_kv_heads=1, head_dim=128, max_len=512, group=64)
    base.update(kw)
    with pytest.raises(ValueError):
        C.CacheSpec(**base)
    with pytest.raises(ValueError):
        TC.CacheSpec(**base)


def test_sort_outliers_key_range_raises_value_error():
    spec = TC.CacheSpec(batch=1, num_kv_heads=1, head_dim=256, max_len=64,
                        group=32, outliers_per_block=8)
    x = torch.randn(1, 1, 32, 256)
    TC._compress_k_block(spec, x)  # token keys < 32: fine
    with pytest.raises(ValueError, match="128"):
        TC._compress_v_block(spec, x)  # channel keys up to 255


# --- core/outliers ----------------------------------------------------------

def test_core_outliers_match_reference(rng):
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    jc, jrec = JO.extract(jnp.asarray(x), 3)
    tc, trec = TO.extract(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(trec.indices.numpy(),
                                  np.asarray(jrec.indices))
    np.testing.assert_array_equal(trec.values.numpy(), np.asarray(jrec.values))
    # the row mean is summed in another order: one float32 rounding
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(TO.restore(tc, trec).numpy(), x)
    same, empty = TO.extract(torch.from_numpy(x), 0)
    assert same.shape == x.shape and empty.values.shape == (3, 4, 0)
    np.testing.assert_array_equal(TO.restore(same, empty).numpy(), x)
    for args in ((1 * 8 * 100 * 64, 100, 0.02), (1000, 10, 0.0),
                 (4 * 32 * 64 * 128, 64, 0.05)):
        assert TO.outlier_k(*args) == JO.outlier_k(*args)


def test_top_k_ties_take_the_lower_index_like_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0, 3.0, -1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = TO.top_k_stable(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4]]


# --- outlier extraction, sorting, index packing -----------------------------

def _block_outputs(jspec, tspec, x, which):
    jfn = C._compress_k_block if which == "k" else C._compress_v_block
    tfn = TC._compress_k_block if which == "k" else TC._compress_v_block
    want = jax.jit(functools.partial(jfn, jspec))(jnp.asarray(x))
    got = tfn(tspec, torch.from_numpy(x))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _outlier_mask(tspec, idx_packed, s_len):
    """bool [B,H,S,D]: the positions held as outliers."""
    idx = TC._unpack_oidx(torch.from_numpy(np.array(idx_packed)))
    b, h, nbs, _ = idx.shape
    m = torch.zeros((b, h, nbs, tspec.group * tspec.head_dim),
                    dtype=torch.bool)
    m.scatter_(-1, idx, True)
    return m.reshape(b, h, s_len, tspec.head_dim).numpy()


def _codes(tspec, packed):
    return TQ.unpack_codes_bytestrided(
        torch.from_numpy(np.array(packed)).transpose(-1, -2),
        tspec.bits).numpy()


def _check_block(tspec, want, got, s_len):
    """The policy of this file's docstring on one compressed block."""
    w_pack, w_scale, w_mn, w_idx, w_val, w_bnd = want
    g_pack, g_scale, g_mn, g_idx, g_val, g_bnd = got
    np.testing.assert_array_equal(g_idx, w_idx)
    np.testing.assert_array_equal(g_bnd, w_bnd)
    np.testing.assert_array_equal(g_scale, w_scale)
    np.testing.assert_array_equal(g_mn, w_mn)
    at_outlier = _outlier_mask(tspec, w_idx, s_len)
    wc, gc = _codes(tspec, w_pack), _codes(tspec, g_pack)
    np.testing.assert_array_equal(gc[~at_outlier], wc[~at_outlier])
    assert np.abs(gc - wc).max() <= 1           # the block mean's last bit
    assert (gc != wc).mean() < 1e-3
    # deltas: equal wherever the stored code is (one float32 rounding of the
    # fused multiply-add XLA may use); the restored values agree everywhere
    x_w = TC._restore_outliers(tspec, torch.zeros(at_outlier.shape),
                               torch.from_numpy(w_idx),
                               torch.from_numpy(w_val.astype(np.float32)))
    x_g = TC._restore_outliers(tspec, torch.zeros(at_outlier.shape),
                               torch.from_numpy(g_idx),
                               torch.from_numpy(g_val.astype(np.float32)))
    same_code = gc == wc
    np.testing.assert_allclose(x_g.numpy()[same_code], x_w.numpy()[same_code],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["k", "v"])
@pytest.mark.parametrize("head_dim,group,ko,bits", [
    (128, 64, 162, 4),   # ko_store padded to 256
    (128, 64, 162, 2),
    (32, 16, 10, 4),     # no padding
    (32, 16, 10, 2),
])
def test_outlier_tables_bit_equal_to_reference(rng, which, head_dim, group,
                                               ko, bits):
    jspec, tspec = _specs(head_dim=head_dim, group=group, max_len=4 * group,
                          bits=bits, outliers_per_block=ko)
    x = rng.standard_normal((2, 2, 2 * group, head_dim)).astype(np.float32)
    want, got = _block_outputs(jspec, tspec, x, which)
    assert got[3].shape[-1] == tspec.ko_store // 2
    assert got[5].shape[-1] == 128
    _check_block(tspec, want, got, 2 * group)
    # float32 deltas (this test's cache dtype): XLA contracts code * scale +
    # mn into a fused multiply-add on the CPU, torch rounds twice, so the
    # dequantized value (|.| < 4) may differ in its last bit, 4.8e-7. In the
    # model's bf16 the deltas are bit-equal (the bf16 test below).
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=5e-7)


@pytest.mark.parametrize("which", ["k", "v"])
def test_outlier_selection_with_bf16_ties_at_the_cut(rng, which):
    """K/V of the model path are bf16, so equal values are common. Here the
    largest and smallest values are each shared by more positions than the
    cut takes, so only the tie rule decides which become outliers."""
    jspec, tspec = _specs(head_dim=32, group=16, max_len=64,
                          outliers_per_block=12)
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    flat = x.reshape(2, 2, 2, 16 * 32)
    for blk in range(2):
        pos = rng.permutation(512)
        flat[:, :, blk, pos[:9]] = 4.0     # 9 equal maxima, 6 are taken
        flat[:, :, blk, pos[9:20]] = -4.0  # 11 equal minima, 6 are taken
    x = flat.reshape(2, 2, 32, 32)
    want, got = _block_outputs(jspec, tspec, x, which)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[5], want[5])
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=5e-7)
    _check_block(tspec, want, got, 32)


def test_outlier_duplicates_carry_no_delta():
    """A constant block: the largest and the smallest set overlap; the
    duplicate entries must carry delta 0 so that restore adds each once."""
    jspec, tspec = _specs(head_dim=8, group=8, max_len=16, bits=4,
                          outliers_per_block=24)
    x = np.full((2, 2, 8, 8), 1.5, np.float32)
    x[:, :, 0, 0] = 2.0
    want, got = _block_outputs(jspec, tspec, x, "k")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    k_hat = TC._dequant_k_block(tspec, *[torch.from_numpy(g) for g in got[:5]])
    np.testing.assert_allclose(k_hat.numpy(), x, rtol=1e-6)


def test_pack_oidx_round_trip_and_layout():
    idx = torch.tensor([[1, 2, 65535, 40000]])
    packed = TC._pack_oidx(idx)
    assert packed.dtype == torch.int32
    want = np.asarray(C._pack_oidx(jnp.asarray(idx.numpy(), jnp.int32)))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(TC._unpack_oidx(packed).numpy(), idx.numpy())
    np.testing.assert_array_equal(
        np.asarray(C._unpack_oidx(jnp.asarray(want))), idx.numpy())


@pytest.mark.parametrize("which", ["k", "v"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_kernel_route_recomputes_the_same_deltas(rng, which, dtype):
    """On the card the prefill quantizes through the pack kernels and
    recomputes the deltas at the outlier positions from the f32 sidebands
    (``_deq_at``). On the CPU the same route runs the kernels' plain
    versions: every output must equal the plain route's, and the
    reference's own pack route (Pallas, interpret mode) where it is held
    bit-equal (everything but float32 deltas, see above)."""
    kw = dict(batch=2, num_kv_heads=2, head_dim=128, max_len=256, bits=4,
              group=64, outliers_per_block=162)
    tspec = TC.CacheSpec(**kw, dtype=getattr(torch, dtype),
                         sideband_dtype=getattr(torch, dtype))
    jspec = C.CacheSpec(**kw, dtype=jnp.dtype(dtype),
                        sideband_dtype=jnp.dtype(dtype))
    x = torch.from_numpy(rng.standard_normal((2, 2, 128, 128)).astype(
        np.float32)).bfloat16().float()
    plain = (TC._compress_k_block if which == "k" else TC._compress_v_block)
    route = (TC._compress_k_block_pk if which == "k"
             else TC._compress_v_block_pk)
    jroute = (C._compress_k_block_pk if which == "k"
              else C._compress_v_block_pk)
    want = plain(tspec, x)
    got = route(tspec, x)
    ref = jax.jit(functools.partial(jroute, jspec, interpret=True))(
        jnp.asarray(x.numpy()))
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        assert torch.equal(g, w), i
        r = np.asarray(r)
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        if i == 0:  # codes: equal away from outlier positions
            m = _outlier_mask(tspec, np.asarray(ref[3]), 128)
            np.testing.assert_array_equal(_codes(tspec, g)[~m],
                                          _codes(tspec, r)[~m])
        elif i == 4 and dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=0, atol=5e-7)
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype), err_msg=str(i))


# --- int8 bases --------------------------------------------------------------

def test_int8_base_quantization_bit_equal_on_identical_bases(rng):
    """The int8 step alone: the reference's own f32 bases (base_bits=16, f32
    cache dtype) go through the port's quantizer and must give the codes
    and scales the reference's base_bits=8 run gives."""
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    x_hat = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j16, _ = _specs(rank=3, prefill_rank=4)
    j8, _ = _specs(rank=3, prefill_rank=4, base_bits=8)
    run = lambda s: jax.jit(functools.partial(C._error_bases, s, rank=3))(
        jnp.asarray(x), jnp.asarray(x_hat), key=key)
    p, qt, _, _ = run(j16)
    p8, qt8, ps, qs = run(j8)
    g_p8, g_qt8, g_ps, g_qs = TC._quantize_bases(
        torch.from_numpy(np.array(p)), torch.from_numpy(np.array(qt)))
    np.testing.assert_array_equal(g_p8.numpy(), np.asarray(p8))
    np.testing.assert_array_equal(g_qt8.numpy(), np.asarray(qt8))
    np.testing.assert_array_equal(g_ps.numpy(), np.asarray(ps))
    np.testing.assert_array_equal(g_qs.numpy(), np.asarray(qs))
    assert g_p8.dtype == torch.int8 and g_ps.shape == (2, 2, 4)


# --- prefill + flushes -------------------------------------------------------

def _build_both(rng, jspec, tspec, *, s=40, n_append=27, use_lowrank=True):
    d, hkv, b = jspec.head_dim, jspec.num_kv_heads, jspec.batch
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jc = jax.jit(functools.partial(C.prefill, jspec, use_lowrank=use_lowrank))(
        jnp.asarray(k), jnp.asarray(v), key=key)
    tc = TC.prefill(tspec, torch.from_numpy(k), torch.from_numpy(v),
                    p0=_prefill_p0(key), use_lowrank=use_lowrank)
    japp = jax.jit(functools.partial(C.append, jspec, use_lowrank=use_lowrank))
    for i in range(n_append):
        kn = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
        vn = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
        skey = jax.random.PRNGKey(100 + i)
        p0 = _append_p0(skey, tc.comp_len)
        jc = japp(jc, jnp.asarray(kn), jnp.asarray(vn), key=skey)
        TC.append(tspec, tc, torch.from_numpy(kn), torch.from_numpy(vn),
                  p0=p0, use_lowrank=use_lowrank)
    return jc, tc


def _check_cache(jspec, tspec, jc, tc):
    want = _fields(jc)
    for f in TC.LENGTH_FIELDS:
        assert getattr(tc, f) == int(want[f]), f
    t = tspec.max_len
    for side in "kv":
        got = [getattr(tc, f"{side}_{n}").numpy() for n in
               ("codes", "scale", "mn", "out_idx", "out_val", "out_bnd")]
        ref = [want[f"{side}_{n}"] for n in
               ("codes", "scale", "mn", "out_idx", "out_val", "out_bnd")]
        if tspec.outliers_per_block:
            _check_block(tspec, ref, got, t)
        else:
            for g, w in zip(got, ref):
                np.testing.assert_array_equal(g, w)
    for f in ("k_resid", "v_resid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), want[f])
    # bases: the power iteration sums in another order (1e-5); an int8 code
    # may then sit on the other side of a rounding boundary (one step)
    for f in ("kpt", "kqt", "vpt", "vqt"):
        got = getattr(tc, f).numpy()
        assert got.dtype == want[f].dtype, f
        if tspec.base_bits == 8:
            assert np.abs(got.astype(np.int32)
                          - want[f].astype(np.int32)).max() <= 1, f
        else:
            np.testing.assert_allclose(got, want[f], rtol=1e-5, atol=1e-5,
                                       err_msg=f)
    for f in ("kpt_scale", "kqt_scale", "vpt_scale", "vqt_scale"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), want[f],
                                   rtol=1e-5, atol=1e-8, err_msg=f)
    step = 1.0
    if tspec.base_bits == 8:  # one int8 step of the largest base entry
        step = max(float(want[f].max()) for f in
                   ("kpt_scale", "kqt_scale", "vpt_scale", "vqt_scale"))
    for fn_j, fn_t in ((C.base_kpt, TC.base_kpt), (C.base_kqt, TC.base_kqt),
                       (C.base_vpt, TC.base_vpt), (C.base_vqt, TC.base_vqt)):
        np.testing.assert_allclose(
            fn_t(tspec, tc).numpy(), np.asarray(fn_j(jspec, jc)), rtol=1e-5,
            atol=1e-5 if tspec.base_bits == 16 else 1.001 * step)
    # reconstruction: float32 rounding without int8 bases; with them, a code
    # one step off moves an entry by (step_p * |q| + step_q * |p|) at most
    tol = 1e-4 if tspec.base_bits == 16 else 0.05
    for w, g in zip(C.dequantize_kv(jspec, jc), TC.dequantize_kv(tspec, tc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


CONFIGS = {
    "outliers": dict(outliers_per_block=10),
    "base8": dict(base_bits=8),
    "kcvt": dict(kcvt_prefill=True),
    "all_three": dict(outliers_per_block=10, base_bits=8, kcvt_prefill=True),
    "outliers_int2_asym_rank": dict(outliers_per_block=10, bits=2, rank_v=0,
                                    prefill_rank_v=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_two_flushes_match_reference(rng, name):
    jspec, tspec = _specs(**CONFIGS[name])
    jc, tc = _build_both(rng, jspec, tspec)
    assert (tc.comp_len, tc.resid_len, tc.prefill_len) == (64, 3, 32)
    _check_cache(jspec, tspec, jc, tc)
    if tspec.kcvt_prefill:  # one scale per channel over the prefill's rows
        np.testing.assert_array_equal(tc.k_scale[:, :, 0].numpy(),
                                      tc.k_scale[:, :, 1].numpy())
        assert not torch.equal(tc.k_scale[:, :, 2], tc.k_scale[:, :, 1])


@pytest.mark.parametrize("kw", [dict(use_lowrank=False),
                                dict(rank=0, prefill_rank=0)],
                         ids=["use_lowrank_false", "ranks_zero"])
def test_no_lowrank_leaves_zero_bases(rng, kw):
    use_lr = kw.pop("use_lowrank", True)
    jspec, tspec = _specs(outliers_per_block=10, **kw)
    jc, tc = _build_both(rng, jspec, tspec, use_lowrank=use_lr)
    _check_cache(jspec, tspec, jc, tc)
    assert not tc.kpt.any() and not tc.vqt.any()
    q = rng.standard_normal((2, 4, 1, 32)).astype(np.float32)
    want = C.attend(jspec, jc, jnp.asarray(q))
    got = TK.attend_fused(tspec, tc, torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_prefill_with_bf16_cache_matches_reference(rng):
    """The model path's types: bf16 cache, sidebands and deltas."""
    kw = dict(batch=1, num_kv_heads=2, head_dim=128, max_len=256, bits=4,
              group=64, rank=2, prefill_rank=4, lowrank_loop=2,
              outliers_per_block=162)
    jspec, tspec = C.CacheSpec(**kw), TC.CacheSpec(**kw)
    x = torch.from_numpy(rng.standard_normal((1, 2, 140, 128)).astype(
        np.float32)).bfloat16()
    k, v = x.float().numpy(), (x.float() * 0.5).numpy()
    key = jax.random.PRNGKey(1)
    jc = jax.jit(functools.partial(C.prefill, jspec))(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), key=key)
    tc = TC.prefill(tspec, x, x * 0.5, p0=_prefill_p0(key))
    want = _fields(jc)
    for f in ("k_out_idx", "v_out_idx", "k_out_bnd", "v_out_bnd", "k_out_val",
              "v_out_val", "k_scale", "k_mn", "v_scale", "v_mn", "k_resid",
              "v_resid"):
        got = getattr(tc, f)
        np.testing.assert_array_equal(
            got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy(),
            want[f].astype(np.float32) if got.dtype == torch.bfloat16
            else want[f], err_msg=f)
    assert tc.k_out_val.dtype == torch.bfloat16
    assert tc.k_out_val.shape[-1] == 256 and tc.k_out_idx.shape[-1] == 128
    # exact values come back to within one bf16 rounding of the delta
    # (deltas of N(0,1) data stay below 8, so half a bf16 ulp is 2**-7)
    for w, g in zip(C.dequantize_kv(jspec, jc), TC.dequantize_kv(tspec, tc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2 ** -6,
                                   rtol=0)


# --- attention ---------------------------------------------------------------

def _attend_specs(**kw):
    base = dict(batch=2, num_kv_heads=2, head_dim=128, max_len=256, bits=4,
                group=64, rank=2, prefill_rank=4, lowrank_loop=3)
    base.update(kw)
    return (C.CacheSpec(**base, dtype=jnp.float32, sideband_dtype=jnp.float32),
            TC.CacheSpec(**base, dtype=torch.float32,
                         sideband_dtype=torch.float32))


ATTEND_CASES = {
    # name: (spec kwargs, hq, prefill tokens, pad_start, window, vs kernel)
    "window_prefix_only": (dict(), 2, 192, None, 100, True),
    "window_crosses_residual": (dict(), 4, 128 + 40, None, 64, False),
    "outliers_gqa_pad": (dict(outliers_per_block=162), 8, 192 + 17, [0, 70],
                         None, True),
    "base8_pad": (dict(base_bits=8), 4, 256, [5, 0], None, True),
    "kcvt_window_pad": (dict(kcvt_prefill=True), 2, 192 + 5, [3, 90], 150,
                        True),
    "all_int2": (dict(outliers_per_block=162, base_bits=8, kcvt_prefill=True,
                      bits=2), 4, 128 + 9, [0, 30], 120, False),
}


@pytest.mark.parametrize("name", list(ATTEND_CASES))
def test_attend_matches_reference(rng, name):
    kw, hq, s, pad, window, vs_kernel = ATTEND_CASES[name]
    jspec, tspec = _attend_specs(**kw)
    shape = (2, 2, s, 128)
    k = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    jc = C.prefill(jspec, k, v)
    # the reference's cache through the port's attend, and back
    tc = convert.cache_from_numpy(_fields(jc))
    q = rng.standard_normal((2, hq, 1, 128)).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    tpad = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    want = C.attend(jspec, jc, jnp.asarray(q), pad_start=jpad, window=window)
    got = TC.attend(tspec, tc, torch.from_numpy(q), pad_start=tpad,
                    window=window)
    # both float32 over the same stored state; only sum orders differ
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    fused = TK.attend_fused(tspec, tc, torch.from_numpy(q), pad_start=tpad,
                            window=window)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())  # CPU: plain
    assert TK.decode_attention.launches == 0
    if vs_kernel:
        # gear_tpu's kernel tolerance (tests/test_decode_kernel.py): the
        # Pallas kernel computes in bf16 with f32 accumulation
        kern = K.attend_fused(jspec, jc, jnp.asarray(q), pad_start=jpad,
                              window=window, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-2,
                                   atol=8e-3)
    # and the port's cache through the reference's attend
    back = C.LayerCache(**{f: jnp.asarray(a) for f, a in
                           convert.cache_to_numpy(tc).items()})
    again = C.attend(jspec, back, jnp.asarray(q), pad_start=jpad,
                     window=window)
    np.testing.assert_array_equal(np.asarray(again), np.asarray(want))


def test_attend_fused_refuses_window_below_group():
    _, tspec = _attend_specs()
    tc = TC.init_layer_cache(tspec)
    with pytest.raises(ValueError, match="window"):
        TK.attend_fused(tspec, tc, torch.zeros(2, 2, 1, 128), window=32)


@pytest.mark.parametrize("kw", [dict(), dict(outliers_per_block=162,
                                             base_bits=8)],
                         ids=["gearl", "gear_base8"])
def test_partials_of_two_time_shards_merge_to_attend(rng, kw):
    """A 256-token cache cut into two 128-token shards (the second holds the
    residual tier): merged partial states equal attend over the whole, and
    each state equals the reference's."""
    jspec, tspec = _attend_specs(**kw)
    s = 192 + 20
    k = rng.standard_normal((2, 2, s, 128)).astype(np.float32)
    v = rng.standard_normal((2, 2, s, 128)).astype(np.float32)
    tc = TC.prefill(tspec, torch.from_numpy(k), torch.from_numpy(v))
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 128)).astype(
        np.float32))
    pad = torch.tensor([0, 150], dtype=torch.int32)
    whole = TC.attend(tspec, tc, q, pad_start=pad)

    half = dict(batch=2, num_kv_heads=2, head_dim=128, max_len=128, bits=4,
                group=64, rank=2, prefill_rank=4, lowrank_loop=3, **kw)
    hspec = TC.CacheSpec(**half, dtype=torch.float32,
                         sideband_dtype=torch.float32)
    jhspec = C.CacheSpec(**half, dtype=jnp.float32,
                         sideband_dtype=jnp.float32)
    time_last = {"k_codes", "v_codes", "v_scale", "v_mn", "kqt", "vqt"}
    block_last = {"kqt_scale", "vqt_scale"}
    parts = []
    for i in range(2):
        fields = {}
        for f in TC.TENSOR_FIELDS:
            x = getattr(tc, f)
            if f in ("k_resid", "v_resid"):
                fields[f] = x
            elif f in time_last:
                fields[f] = x[..., i * 128:(i + 1) * 128]
            elif f in block_last:
                fields[f] = x[..., i * 2:(i + 1) * 2]
            else:
                fields[f] = x[:, :, i * 2:(i + 1) * 2]
        shard = TC.LayerCache(**fields, comp_len=128 if i == 0 else 64,
                              resid_len=tc.resid_len if i else 0)
        part = TC.attend_partial(hspec, shard, q, pad_start=pad,
                                 include_residual=bool(i),
                                 token_offset=i * 128)
        jshard = C.LayerCache(**{f: jnp.asarray(a) for f, a in
                                 convert.cache_to_numpy(shard).items()})
        jpart = C.attend_partial(jhspec, jshard, jnp.asarray(q.numpy()),
                                 pad_start=jnp.asarray(pad.numpy()),
                                 include_residual=bool(i),
                                 token_offset=i * 128)
        for g, w in zip(part, jpart):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
        parts.append(part)
    merged = TC.merge_partials(parts)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    jmerged = C.merge_partials([tuple(jnp.asarray(x.numpy()) for x in p)
                                for p in parts])
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), rtol=1e-6,
                               atol=1e-7)


def test_init_stacked_layers_are_independent():
    spec = TC.CacheSpec(batch=1, num_kv_heads=1, head_dim=32, max_len=32,
                        group=16, outliers_per_block=4, base_bits=8)
    st = TC.init_stacked(spec, 3)
    jst = C.init_stacked(C.CacheSpec(batch=1, num_kv_heads=1, head_dim=32,
                                     max_len=32, group=16,
                                     outliers_per_block=4, base_bits=8), 3)
    for f in TC.TENSOR_FIELDS:
        assert tuple(getattr(st, f).shape) == getattr(jst, f).shape, f
    x = torch.randn(1, 1, 1, 32)
    TC.append(spec, st.layer(1), x, x)
    assert st.k_resid[1].any() and not st.k_resid[0].any()
