"""Parity of the port's paged cache (gear_tpu_torch.paged, the paged
attention wrapper) with gear_tpu on the CPU.

Both packages get the same numpy K/V and the same power-iteration inits
(jax.random draws along gear_tpu.paged's key chain, handed to the port). On
the CPU the port's ``attend_paged`` takes its plain version,
``paged.attend_gathered`` (tests/test_torch_paged_attend.py holds it against
the interpreted Pallas kernel). Pools with outliers follow the policy of
tests/test_torch_gear_cache.py: indices and boundary tables bit-equal, codes
bit-equal away from outlier positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu import paged as P
from gear_tpu import serving as JS
from gear_tpu_torch import cache as TC
from gear_tpu_torch import convert
from gear_tpu_torch import paged as TP
from gear_tpu_torch import serving as TS
from gear_tpu_torch.core import quant as TQ
from gear_tpu_torch.kernels import decode as TK
from test_torch_cache import _append_p0, _prefill_p0

BASES = ("kpt", "kqt", "vpt", "vqt")


def _specs(n_pages=8, page_blocks=2, f32=True, **kw):
    base = dict(batch=1, num_kv_heads=2, head_dim=32, max_len=128, bits=4,
                group=16, rank=2, prefill_rank=4, lowrank_loop=2)
    base.update(kw)
    jdt, tdt = (jnp.float32, torch.float32) if f32 else \
        (jnp.bfloat16, torch.bfloat16)
    return (P.PagedSpec(spec=C.CacheSpec(**base, dtype=jdt,
                                         sideband_dtype=jdt),
                        n_pages=n_pages, page_blocks=page_blocks),
            TP.PagedSpec(spec=TC.CacheSpec(**base, dtype=tdt,
                                           sideband_dtype=tdt),
                         n_pages=n_pages, page_blocks=page_blocks))


def _np_tree(obj, names) -> dict:
    return {f: np.asarray(getattr(obj, f)) for f in names}


SEQ_FIELDS = ("block_table", "comp_len", "resid_len", "prefill_len",
              "k_resid", "v_resid")


# --- allocator and scheduler -------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_allocator_matches_reference(monkeypatch, native):
    if not native:
        monkeypatch.setattr(P, "_PAGER_LIB", False)
        monkeypatch.setattr(TP, "_PAGER_LIB", False)
    ja, ta = P.PageAllocator(4), TP.PageAllocator(4)
    assert ja.native == ta.native
    assert native is False or ta.native  # native/libgearpager.so is built

    def both(name, *args):
        want, got = getattr(ja, name)(*args), getattr(ta, name)(*args)
        assert got == want, (name, args)
        return got

    ids = [both("alloc") for _ in range(4)]
    assert sorted(ids) == [0, 1, 2, 3]
    assert both("alloc") == -1
    assert both("retain", ids[0]) == 2
    assert both("release", ids[0]) == 1
    assert both("release", ids[0]) == 0
    assert both("free_count") == 1
    assert both("alloc") == ids[0]
    assert both("release", 1) == 0
    assert both("release", 1) == -1      # double release of a free page
    assert both("retain", 1) == -1
    both("release", 3)
    assert [both("alloc"), both("alloc")] == [3, 1]  # last freed first
    assert both("free_count") == 0


@pytest.mark.parametrize("native", [True, False])
def test_scheduler_matches_reference(monkeypatch, native):
    if not native:
        monkeypatch.setattr(JS, "_load_sched", lambda: None)
        monkeypatch.setattr(TS, "_load_sched", lambda: None)
    js, ts = JS.Scheduler(2), TS.Scheduler(2)
    assert js.native == ts.native == native

    def both(name, *args):
        want, got = getattr(js, name)(*args), getattr(ts, name)(*args)
        assert got == want, (name, args)
        return got

    for rid, plen, max_new in ((0, 5, 3), (1, 2, 2), (2, 7, 4)):
        both("add", rid, plen, max_new)
    assert both("next_admission") == 0
    assert both("admit", 1) == -1            # not at the head of the queue
    assert both("admit", 0) == 0
    assert both("admit", 1) == 1
    assert both("next_admission") == -1      # no free slot
    assert both("step", 0) == 2
    assert both("step", 1) == 1
    assert both("step", 1) == 0
    assert both("finish", 1) == 1
    assert both("step", 1) == -1             # empty slot
    assert both("preempt", 0, 6) == 0        # back to the head, budget 2
    assert both("next_admission") == 0
    assert both("admit", 0) == 0
    assert both("step", 0) == 1
    assert both("admit", 2) == 1
    assert both("step", 1) == 3
    assert both("finish", 0) == 0
    assert both("finish", 0) == -1
    assert both("preempt", 0, 1) == -1


# --- pool layout -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(outliers_per_block=162, head_dim=128, group=64, max_len=512),
    dict(base_bits=8)], ids=["gearl", "gear", "base8"])
def test_pool_and_seqs_layout_match_reference(kw):
    jps, tps = _specs(f32=False, **kw)
    assert (tps.page_tokens, tps.max_pages_per_seq) == \
        (jps.page_tokens, jps.max_pages_per_seq)
    jpool, tpool = P.init_pool(jps), TP.init_pool(tps)
    assert set(TP.POOL_FIELDS) == set(jpool.__dataclass_fields__)
    for f in TP.POOL_FIELDS:
        j, t = np.asarray(getattr(jpool, f)), getattr(tpool, f)
        assert tuple(t.shape) == j.shape, f
        assert str(t.dtype).split(".")[1] == j.dtype.name, f
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32), err_msg=f)
    stacked = TP.init_pool(tps, num_layers=3)
    assert stacked.kpt.shape == (3,) + tpool.kpt.shape
    assert stacked.layer(1).nbytes() == tpool.nbytes()
    jseqs, tseqs = P.init_seqs(jps, 3), TP.init_seqs(tps, 3)
    got = convert.seqs_to_numpy(tseqs)
    for f in SEQ_FIELDS:
        want = np.asarray(getattr(jseqs, f))
        assert got[f].shape == want.shape and got[f].dtype == want.dtype, f
    with pytest.raises(ValueError):
        TP.PagedSpec(spec=tps.spec, n_pages=4, page_blocks=3)


# --- prefill_paged + append_paged across flushes ------------------------------

def _build_both(rng, jps, tps, prompt_lens, page_ids, n_append, live=None,
                outlier_spikes=False):
    """The same prompts and appended tokens through both packages' paged
    caches. ``page_ids[row]`` are the row's pages, in table order (enough of
    them for prompt and appends). Returns the four states."""
    spec = tps.spec
    h, d = spec.num_kv_heads, spec.head_dim
    b = len(prompt_lens)
    jpool, jseqs = P.init_pool(jps), P.init_seqs(jps, b)
    tpool, tseqs = TP.init_pool(tps), TP.init_seqs(tps, b)
    for row, s in enumerate(prompt_lens):
        k = rng.standard_normal((1, h, s, d)).astype(np.float32)
        v = rng.standard_normal((1, h, s, d)).astype(np.float32)
        if outlier_spikes:
            k += 8.0 * rng.standard_normal(k.shape).astype(np.float32) * (
                rng.random(k.shape) < 0.01)
        key = jax.random.PRNGKey(row)
        # jitted, as the JAX serving engine runs its prefill (XLA's form of
        # the quant step: see gear_tpu_torch/core/quant.py)
        jpool, jseqs = jax.jit(
            lambda pl_, sq_, k_, v_, key_, row=row: P.prefill_paged(
                jps, pl_, sq_, row, page_ids[row], k_, v_, key=key_))(
            jpool, jseqs, jnp.asarray(k), jnp.asarray(v), key)
        TP.prefill_paged(tps, tpool, tseqs, row, page_ids[row],
                         torch.from_numpy(k), torch.from_numpy(v),
                         p0=_prefill_p0(key))
        for idx, pid in enumerate(page_ids[row]):  # the tail pages too
            jseqs = jseqs.replace(
                block_table=jseqs.block_table.at[row, idx].set(pid))
            tseqs.set_page(row, idx, pid)
    key = jax.random.PRNGKey(9)
    jlive = None if live is None else jnp.asarray(live)
    for _ in range(n_append):
        kn = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        vn = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        comp = tseqs.host_lens[:, TP.COMP].copy()
        jpool, jseqs = P.append_paged(jps, jpool, jseqs, jnp.asarray(kn),
                                      jnp.asarray(vn), key=key, live=jlive)
        TP.append_paged(
            tps, tpool, tseqs, torch.from_numpy(kn), torch.from_numpy(vn),
            live=live, p0=lambda row, which, shape: _append_p0(
                key, int(comp[row]))(which, shape))
    return jpool, jseqs, tpool, tseqs


def _check_seqs(jseqs, tseqs):
    got = convert.seqs_to_numpy(tseqs)
    for f in SEQ_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jseqs, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tseqs.host_table, got["block_table"])
    np.testing.assert_array_equal(tseqs.host_lens, tseqs.lens.numpy())


@pytest.mark.parametrize("kw", [dict(), dict(base_bits=8), dict(bits=2)],
                         ids=["gearl", "base8", "int2"])
def test_pool_state_matches_reference(rng, kw):
    """Rows of different lengths on interleaved, out-of-order pages; 40
    appends flush each row two or three times, into a tail page that the
    prefill began and into fresh ones."""
    jps, tps = _specs(n_pages=12, page_blocks=2, **kw)
    page_ids = [[7, 2, 9, 0], [4, 11, 1]]
    jpool, jseqs, tpool, tseqs = _build_both(
        rng, jps, tps, [48 + 5, 16 + 11], page_ids, 40)
    assert tseqs.host_lens.tolist() == [[80, 13, 48], [64, 3, 16]]
    _check_seqs(jseqs, tseqs)
    got = convert.pool_to_numpy(tpool)
    for f in TP.POOL_FIELDS:
        want = np.asarray(getattr(jpool, f))
        assert got[f].shape == want.shape, f
        if f in BASES and not kw.get("base_bits"):
            np.testing.assert_allclose(got[f], want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        elif f in BASES:  # int8 codes of bases equal within 1e-5: one step
            assert np.abs(got[f].astype(np.int32) - want).max() <= 1, f
            assert (got[f] != want).mean() < 1e-3, f
        elif f.endswith("pt_scale") or f.endswith("qt_scale"):
            np.testing.assert_allclose(got[f], want, rtol=1e-5, atol=1e-7,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)
    # the port's pool under the JAX package's attention, and the reverse
    q = rng.standard_normal((2, 4, 1, 32)).astype(np.float32)
    back = P.PagePool(**{f: jnp.asarray(a) for f, a in got.items()})
    back_seqs = P.PagedSeqs(**{f: jnp.asarray(a) for f, a in
                               convert.seqs_to_numpy(tseqs).items()})
    want = np.asarray(P.attend_xla(jps, back, back_seqs, jnp.asarray(q)))
    out = TK.attend_paged(tps, tpool, tseqs, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    carried = TP.attend_gathered(
        tps, convert.pool_from_numpy(_np_tree(jpool, TP.POOL_FIELDS)),
        convert.seqs_from_numpy(_np_tree(jseqs, SEQ_FIELDS)),
        torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(carried, want, rtol=1e-4, atol=1e-4)


def test_pool_state_with_outliers_matches_reference(rng):
    jps, tps = _specs(n_pages=12, page_blocks=2, outliers_per_block=10)
    page_ids = [[7, 2, 9, 0], [4, 11, 1]]
    jpool, jseqs, tpool, tseqs = _build_both(
        rng, jps, tps, [48 + 5, 16 + 11], page_ids, 40, outlier_spikes=True)
    _check_seqs(jseqs, tseqs)
    got = convert.pool_to_numpy(tpool)
    for f in ("k_out_idx", "v_out_idx", "k_out_bnd", "v_out_bnd", "k_scale",
              "k_mn", "v_scale", "v_mn"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jpool, f)),
                                      err_msg=f)
    for f in ("k_codes", "v_codes"):  # [P, H, WD, PT] -> codes [P, H, PT, D]
        gc, wc = (TQ.unpack_codes_bytestrided(
            torch.from_numpy(np.array(a)).transpose(-1, -2), 4).numpy()
            for a in (got[f], np.asarray(getattr(jpool, f))))
        assert np.abs(gc - wc).max() <= 1, f   # the block mean's last bit
        assert (gc != wc).mean() < 1e-3, f
    q = rng.standard_normal((2, 4, 1, 32)).astype(np.float32)
    want = np.asarray(P.attend_xla(jps, jpool, jseqs, jnp.asarray(q)))
    out = TK.attend_paged(tps, tpool, tseqs, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_parked_and_pageless_rows_do_not_flush(rng):
    """Row 1 is parked (live False): it neither writes, advances nor
    flushes. Row 2 is live but its tail page was never allocated: its
    residual tier fills and stays, and comp_len does not advance. Both as in
    the JAX package; the port then refuses a further append to row 2."""
    jps, tps = _specs(n_pages=12, page_blocks=1)
    page_ids = [[5, 3, 8], [6], [2]]
    live = [True, False, True]
    jpool, jseqs, tpool, tseqs = _build_both(
        rng, jps, tps, [16 + 4, 16 + 15, 16 + 6], page_ids, 10, live=live)
    assert tseqs.host_lens.tolist() == [[16, 14, 16], [16, 15, 16],
                                        [16, 16, 16]]
    _check_seqs(jseqs, tseqs)
    got = convert.pool_to_numpy(tpool)
    for f in ("k_codes", "v_codes", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jpool, f)),
                                      err_msg=f)
    q = rng.standard_normal((3, 2, 1, 32)).astype(np.float32)
    want = np.asarray(P.attend_xla(jps, jpool, jseqs, jnp.asarray(q)))
    out = TK.attend_paged(tps, tpool, tseqs, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    x = torch.zeros((3, 2, 1, 32))
    with pytest.raises(ValueError, match="tail page"):
        TP.append_paged(tps, tpool, tseqs, x, x, live=live)
    TP.append_paged(tps, tpool, tseqs, x, x, live=[True, False, False])
    assert tseqs.host_lens[:, TP.RESID].tolist() == [15, 15, 16]


def test_full_pageless_row_corrupts_the_reference_and_the_port_refuses(rng):
    """A live row whose residual tier is full and whose tail page was never
    allocated, given one more token: gear_tpu.paged.append_paged drops the
    write (slot ``group`` lies past the tier), leaves the pool as it was and
    moves resid_len to group + 1, a state no later step reads correctly.
    The port refuses the append instead, and changes nothing."""
    jps, tps = _specs(n_pages=12, page_blocks=1)
    g = tps.spec.group
    live = [True, False, True]
    jpool, jseqs, tpool, tseqs = _build_both(
        rng, jps, tps, [16 + 4, 16 + 15, 16 + 6], [[5, 3, 8], [6], [2]], 10,
        live=live)
    assert int(jseqs.resid_len[2]) == g and int(jseqs.block_table[2, 1]) < 0
    x = np.full((3, 2, 1, 32), 7.0, np.float32)
    jpool2, jseqs2 = P.append_paged(jps, jpool, jseqs, jnp.asarray(x),
                                    jnp.asarray(x), key=jax.random.PRNGKey(9),
                                    live=jnp.asarray(live))
    assert np.asarray(jseqs2.resid_len).tolist() == [15, 15, g + 1]
    assert np.asarray(jseqs2.comp_len).tolist() == [16, 16, 16]
    for f in ("k_resid", "v_resid"):  # row 2's token went nowhere
        np.testing.assert_array_equal(np.asarray(getattr(jseqs2, f))[2],
                                      np.asarray(getattr(jseqs, f))[2])
    for f in TP.POOL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jpool2, f)),
                                      np.asarray(getattr(jpool, f)))
    lens = tseqs.host_lens.copy()
    resid = tseqs.k_resid.clone()
    with pytest.raises(ValueError, match="tail page"):
        TP.append_paged(tps, tpool, tseqs, torch.from_numpy(x),
                        torch.from_numpy(x), live=live)
    assert np.array_equal(tseqs.host_lens, lens)
    assert torch.equal(tseqs.k_resid, resid)


def test_prefill_paged_refuses_too_few_pages():
    _, tps = _specs()
    pool, seqs = TP.init_pool(tps), TP.init_seqs(tps, 1)
    x = torch.randn(1, 2, 80, 32)
    with pytest.raises(ValueError, match="pages"):
        TP.prefill_paged(tps, pool, seqs, 0, [0, 1], x, x)


def test_append_past_capacity_raises():
    _, tps = _specs(n_pages=4, page_blocks=1, max_len=32)
    pool, seqs = TP.init_pool(tps), TP.init_seqs(tps, 1)
    x = torch.randn(1, 2, 32, 32)
    TP.prefill_paged(tps, pool, seqs, 0, [0, 1], x, x)
    for _ in range(15):
        TP.append_paged(tps, pool, seqs, x[:, :, :1], x[:, :, :1])
    with pytest.raises(ValueError, match="max_len"):
        TP.append_paged(tps, pool, seqs, x[:, :, :1], x[:, :, :1])
