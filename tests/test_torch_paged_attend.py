"""The port's paged attention (``kernels.decode.attend_paged``; on the CPU
its plain version ``paged.attend_gathered``) against the JAX package's paged
Pallas kernel in interpret mode and against ``gear_tpu.paged.attend_xla``,
on pools that the JAX package builds as its own tests build them and that
``gear_tpu_torch.convert`` carries across.

Tolerances: 1e-4 against ``attend_xla`` (both float32 over the same stored
state); against the interpreted Pallas kernel the JAX package's own, rtol
2e-2 / atol 8e-3 (its kernel multiplies in bf16), 3e-2 / 1.5e-2 with int8
bases and outliers (tests/test_paged.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import paged as P
from gear_tpu.kernels import decode as K
from gear_tpu_torch import convert
from gear_tpu_torch import paged as TP
from gear_tpu_torch.kernels import decode as TK
from test_torch_paged import SEQ_FIELDS, _np_tree, _specs


def _jax_pool(rng, jps, prompt_lens, n_append=0, spikes=False):
    """A pool built by the JAX package, as tests/test_paged.py builds it."""
    spec = jps.spec
    pool = P.init_pool(jps)
    seqs = P.init_seqs(jps, len(prompt_lens))
    al = P.PageAllocator(jps.n_pages)
    for row, s in enumerate(prompt_lens):
        shape = (1, spec.num_kv_heads, s, spec.head_dim)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        if spikes:
            k += 8.0 * rng.standard_normal(shape).astype(np.float32) * (
                rng.random(shape) < 0.01)
        n = -(-(s + n_append) // jps.page_tokens)
        ids = [al.alloc() for _ in range(n)]
        pool, seqs = P.prefill_paged(jps, pool, seqs, row, ids,
                                     jnp.asarray(k), jnp.asarray(v),
                                     key=jax.random.PRNGKey(row))
        seqs = seqs.replace(block_table=seqs.block_table.at[
            row, :n].set(jnp.asarray(ids, jnp.int32)))
    key = jax.random.PRNGKey(7)
    for i in range(n_append):
        kn = jax.random.normal(
            jax.random.fold_in(key, 2 * i),
            (len(prompt_lens), spec.num_kv_heads, 1, spec.head_dim))
        pool, seqs = P.append_paged(jps, pool, seqs, kn, kn * 0.3 + 0.5,
                                    key=jax.random.PRNGKey(9))
    return pool, seqs, al


ATTEND_CASES = {
    # name: (spec kwargs, f32, appends, window, pad_start, shared page,
    #        rtol / atol against the interpreted Pallas kernel)
    "per_row_lengths": (dict(), True, 0, None, None, False, (2e-2, 8e-3)),
    "window_and_padding": (dict(), True, 0, 96, [0, 40], False, (2e-2, 8e-3)),
    "flush_base8_outliers_int2": (
        dict(base_bits=8, outliers_per_block=32, bits=2), False, 60, None,
        None, False, (3e-2, 1.5e-2)),
    "shared_prefix_page": (dict(), True, 0, None, None, True, (2e-2, 8e-3)),
}


@pytest.mark.parametrize("name", list(ATTEND_CASES))
def test_attend_paged_matches_reference(rng, name):
    kw, f32, n_append, window, pad, shared, (rtol, atol) = ATTEND_CASES[name]
    jps, tps = _specs(n_pages=8, page_blocks=2, f32=f32, head_dim=128,
                      group=64, max_len=512, lowrank_loop=3, **kw)
    pool, seqs, al = _jax_pool(rng, jps, [256 + 9, 128], n_append,
                               spikes=bool(kw.get("outliers_per_block")))
    if shared:  # row 1 reads row 0's first page (one pid, two rows)
        pid = int(seqs.block_table[0, 0])
        assert al.retain(pid) == 2
        seqs = seqs.replace(block_table=seqs.block_table.at[1, 0].set(pid))
    assert int(seqs.comp_len[0]) != int(seqs.comp_len[1])
    tpool = convert.pool_from_numpy(_np_tree(pool, TP.POOL_FIELDS))
    tseqs = convert.seqs_from_numpy(_np_tree(seqs, SEQ_FIELDS))
    q = rng.standard_normal((2, 4, 1, 128)).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    tpad = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    got = TK.attend_paged(tps, tpool, tseqs, torch.from_numpy(q),
                          pad_start=tpad, window=window).numpy()
    assert TK.decode_attention_paged.launches == 0  # CPU: the plain version
    want_xla = P.attend_xla(jps, pool, seqs, jnp.asarray(q), pad_start=jpad,
                            window=window)
    want_kernel = K.attend_paged(jps, pool, seqs, jnp.asarray(q),
                                 pad_start=jpad, window=window,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_xla), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=rtol,
                               atol=atol)
    if shared:  # over the shared page both rows attend alike
        one = TP.gather_dense(tps, tpool, tseqs, 1)
        two = TP.gather_dense(tps, tpool, tseqs, 0)
        np.testing.assert_array_equal(one.k_codes[..., :128].numpy(),
                                      two.k_codes[..., :128].numpy())


def test_attend_paged_refuses_window_below_group():
    _, tps = _specs()
    pool, seqs = TP.init_pool(tps), TP.init_seqs(tps, 1)
    with pytest.raises(ValueError, match="window"):
        TK.attend_paged(tps, pool, seqs, torch.zeros(1, 2, 1, 32), window=8)


def test_parked_row_attends_to_zeros():
    _, tps = _specs()
    pool, seqs = TP.init_pool(tps), TP.init_seqs(tps, 2)
    for row in range(2):
        seqs.set_lengths(row, 0, 1, 0)
    out = TK.attend_paged(tps, pool, seqs, torch.randn(2, 4, 1, 32))
    assert torch.equal(out, torch.zeros_like(out))
