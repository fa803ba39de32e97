"""The prefill's low-rank P basis is one per row, replicated over the
prefill's quant blocks, in gear_tpu and in the port (CPU).

The decode kernels (dense and paged) read that P, and its int8 scales, once
per row for every tile that lies wholly inside the prefill: this holds the
premise for every method of ``config.METHODS``, with bf16 and int8 bases,
after prefill, across flushes, and in a page pool after the splice.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu_torch import cache as TC
from gear_tpu_torch import paged as TP
from gear_tpu_torch.config import METHODS, CompressionConfig
from gear_tpu_torch.models import llama
from test_torch_cache import _append_p0, _prefill_p0

# per-block leaves of the prefill's P ([..., NB, R, D] / [..., NB, R]) and
# the per-block lanes of the Qt scales ([..., R, NB])
ROWS = ("kpt", "vpt", "kpt_scale", "vpt_scale")
LANES = ("kqt_scale", "vqt_scale")
PROMPT, GROUP = 50, 16   # three prefill blocks and two residual tokens


def _spec_kw(method, base_bits):
    """CacheSpec arguments of ``method`` as the models build them (head dim
    32, group 16), in float32 so that both packages round alike."""
    cfg = llama.ModelConfig.tiny(head_dim=32, hidden_size=64, num_heads=2,
                                 num_kv_heads=2)
    comp = CompressionConfig(num_layers=1, compress_method=method,
                             quantize_bit=4, group_size=GROUP, rank=2,
                             prefill_rank=4, loop=2)
    s = cfg.cache_spec(2, 128, comp)
    return dict(batch=2, num_kv_heads=2, head_dim=32, max_len=128,
                bits=s.bits, group=s.group, rank=s.rank,
                prefill_rank=s.prefill_rank, rank_v=s.rank_v,
                prefill_rank_v=s.prefill_rank_v, lowrank_loop=s.lowrank_loop,
                outliers_per_block=s.outliers_per_block,
                kcvt_prefill=s.kcvt_prefill, base_bits=base_bits)


def _assert_shared(leaves: dict, nbs: int, lead: int = 2):
    """Every prefill block [0, nbs) holds block 0's P rows and scales."""
    for f in ROWS:
        a = np.asarray(leaves[f])
        blocks = a[(slice(None),) * lead + (slice(0, nbs),)]
        assert (blocks == blocks[(slice(None),) * lead + (slice(0, 1),)]).all(), f
    for f in LANES:
        a = np.asarray(leaves[f])[..., :nbs]
        assert (a == a[..., :1]).all(), f


def _np_leaves(c) -> dict:
    return {f: np.asarray(getattr(c, f)) for f in ROWS + LANES}


@pytest.mark.parametrize("base_bits", [16, 8])
@pytest.mark.parametrize("method", METHODS)
def test_prefill_p_is_shared_by_the_prefill_blocks(rng, method, base_bits):
    kw = _spec_kw(method, base_bits)
    jspec = C.CacheSpec(**kw, dtype=jnp.float32, sideband_dtype=jnp.float32)
    tspec = TC.CacheSpec(**kw, dtype=torch.float32,
                         sideband_dtype=torch.float32)
    k = rng.standard_normal((2, 2, PROMPT, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, PROMPT, 32)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jc = jax.jit(functools.partial(C.prefill, jspec))(
        jnp.asarray(k), jnp.asarray(v), key=key)
    tc = TC.prefill(tspec, torch.from_numpy(k), torch.from_numpy(v),
                    p0=_prefill_p0(key))
    nbs = tc.prefill_len // GROUP
    assert nbs == 3 and int(jc.prefill_len) == tc.prefill_len
    _assert_shared(_np_leaves(jc), nbs)
    _assert_shared(_np_leaves(tc), nbs)
    # the port's shared rows are the reference's (power iteration: 1e-5; an
    # int8 code may sit one step off)
    got, want = _np_leaves(tc), _np_leaves(jc)
    for f in ("kpt", "vpt"):
        g, w = got[f][:, :, 0].astype(np.float32), want[f][:, :, 0]
        np.testing.assert_allclose(g, w, atol=1e-5 if base_bits == 16 else 1,
                                   err_msg=f)
    # the flushes write blocks past the prefill and leave its P alone
    before = _np_leaves(tc)
    for i in range(2 * GROUP):
        kn = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        vn = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        TC.append(tspec, tc, torch.from_numpy(kn), torch.from_numpy(vn),
                  p0=_append_p0(jax.random.PRNGKey(100 + i), tc.comp_len))
    assert tc.comp_len == tc.prefill_len + 2 * GROUP
    _assert_shared(_np_leaves(tc), nbs)
    after = _np_leaves(tc)
    for f in ROWS:
        np.testing.assert_array_equal(after[f][:, :, :nbs],
                                      before[f][:, :, :nbs], err_msg=f)


@pytest.mark.parametrize("base_bits", [16, 8])
@pytest.mark.parametrize("method", ["GEAR", "GEARL-KCVT"])
def test_prefill_p_is_shared_in_the_page_pool(rng, method, base_bits):
    """After the splice, every page that holds a prefill block of a row
    holds the row's one P, and the kernel may read it from any of them."""
    kw = _spec_kw(method, base_bits)
    kw["batch"] = 1
    tspec = TC.CacheSpec(**kw, dtype=torch.float32,
                         sideband_dtype=torch.float32)
    pspec = TP.PagedSpec(spec=tspec, n_pages=8, page_blocks=2)
    pool = TP.init_pool(pspec, "cpu")
    seqs = TP.init_seqs(pspec, 2, "cpu")
    gen = torch.Generator().manual_seed(3)
    for row, ids in ((0, [5, 2, 7]), (1, [0, 6])):
        k = torch.from_numpy(rng.standard_normal((1, 2, PROMPT, 32)).astype(
            np.float32))
        v = torch.from_numpy(rng.standard_normal((1, 2, PROMPT, 32)).astype(
            np.float32))
        TP.prefill_paged(pspec, pool, seqs, row, ids, k, v, generator=gen)
    for row in range(2):
        comp, _, prefill = (int(x) for x in seqs.host_lens[row])
        nbs = prefill // GROUP
        assert nbs == 3 and comp == prefill
        # block b of the row lives in page table[b // PB] at offset b % PB
        where = [(int(seqs.host_table[row, b // 2]), b % 2)
                 for b in range(nbs)]
        for f in ROWS:
            a = getattr(pool, f).numpy()
            first = a[where[0][0], :, where[0][1]]
            for page, off in where[1:]:
                np.testing.assert_array_equal(a[page, :, off], first,
                                              err_msg=f)
        for f in LANES:
            a = getattr(pool, f).numpy()
            first = a[where[0][0], ..., where[0][1]]
            for page, off in where[1:]:
                np.testing.assert_array_equal(a[page, ..., off], first,
                                              err_msg=f)
