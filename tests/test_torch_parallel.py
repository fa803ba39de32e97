"""The port's parallel rules and profiling in one process on the CPU, against
``gear_tpu``: the sharding specs of every weight and cache leaf, this rank's
slices, ``split_cache`` leaf by leaf, the merge of the shards' partial
attention states, and the profiling helpers. The paths that need several
processes are in ``test_torch_parallel_procs.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu.models import llama as jllama
from gear_tpu.parallel import context as jctx
from gear_tpu.parallel import sharding as jsh
from gear_tpu_torch import cache as TC
from gear_tpu_torch import convert
from gear_tpu_torch import profiling as TP
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.parallel import context as tctx
from gear_tpu_torch.parallel import distributed as tdist
from gear_tpu_torch.parallel import sharding as tsh
from test_torch_cache import _append_p0, _fields, _prefill_p0


def _tree_tuples(tree):
    if isinstance(tree, dict):
        return {k: _tree_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("tied", [False, True])
def test_param_pspecs_match_reference(tied):
    jcfg = jllama.ModelConfig.tiny(tie_word_embeddings=tied)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tllama.init_params(
        tllama.ModelConfig.tiny(tie_word_embeddings=tied), device="cpu")
    assert tsh.param_pspecs(tparams) == _tree_tuples(
        jsh.param_pspecs(jparams))


@pytest.mark.parametrize("stacked", [True, False])
def test_cache_pspecs_match_reference(stacked):
    want = jsh.cache_pspecs(stacked)
    got = tsh.cache_pspecs(stacked)
    assert set(got) == set(TC.TENSOR_FIELDS + TC.LENGTH_FIELDS)
    for f, spec in got.items():
        assert spec == tuple(getattr(want, f)), f
    raw = jsh.raw_cache_pspecs(stacked)
    assert tsh.raw_cache_pspecs(stacked) == {
        f: tuple(getattr(raw, f)) for f in ("k", "v", "length")}


def test_local_slices_and_config():
    """A (data 2, model 2) layout seen from one rank: its slices of the
    params and of a cache, and its config; uneven splits raise."""
    cfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, device="cpu")
    mesh = tdist.Mesh({"data": 1, "model": 1})
    mesh.shape, mesh.coords = {"data": 2, "model": 2}, {"data": 1, "model": 1}
    local = tsh.shard_params(mesh, params)
    assert local["embed"] is params["embed"]  # replicated: no copy
    torch.testing.assert_close(local["layers"]["wq"],
                               params["layers"]["wq"][:, :, 32:])
    torch.testing.assert_close(local["layers"]["wo"],
                               params["layers"]["wo"][:, 32:])
    torch.testing.assert_close(local["lm_head"], params["lm_head"][:, 128:])
    lcfg = tsh.local_config(cfg, mesh)
    assert (lcfg.num_heads, lcfg.num_kv_heads, lcfg.intermediate_size,
            lcfg.vocab_size) == (2, 1, 64, 256)

    spec = cfg.cache_spec(4, 64, TComp(num_layers=2, group_size=16).layer(0))
    cache = TC.init_stacked(spec, 2)
    cache.k_codes.copy_(torch.arange(cache.k_codes.numel(),
                                     dtype=torch.int32).view_as(cache.k_codes))
    part = tsh.shard_cache(mesh, cache)
    assert torch.equal(part.k_codes, cache.k_codes[:, 2:, 1:])
    assert part.k_codes.is_contiguous() and part.kpt.shape[1:3] == (2, 1)
    raw = tsh.shard_cache(mesh, tllama.raw_init(spec), stacked=False)
    assert raw.k.shape == (2, 1, 64, 16)

    mesh.shape["model"] = 4
    with pytest.raises(ValueError, match="num_kv_heads 2 does not split"):
        tsh.local_config(cfg, mesh)
    with pytest.raises(ValueError, match="does not split evenly"):
        tsh.shard_params(mesh, {"lm_head": torch.zeros(4, 6)})


def test_one_rank_mesh_and_backend_choice():
    mesh = tdist.Mesh({"model": 1})
    x = torch.ones(3)
    assert tdist.all_reduce(x, mesh, "model") is x
    assert tdist.gather(x, mesh, "model", 0) is x
    assert mesh.axis_size("seq") == 1 and mesh.index("data") == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tdist.Mesh({"model": 2})
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tdist.Mesh({"tensor": 1})
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        tdist.initialize_from_env("mpi")


def test_sharded_inits_take_the_whole_draw():
    """Each rank's init is its rows and heads of the one draw the unsharded
    run takes, from ``init`` or from the generator."""
    mesh = tdist.Mesh({"data": 1, "model": 1})
    mesh.shape, mesh.coords = {"data": 2, "model": 2}, {"data": 1, "model": 0}
    whole = torch.rand((4, 6, 16, 2), generator=torch.Generator()
                       .manual_seed(9))
    draw = tsh.sharded_inits(mesh, None, torch.Generator().manual_seed(9),
                             "cpu")
    assert torch.equal(draw(("decode",), (2, 3, 16, 2)), whole[2:, :3])
    seen = []
    hook = tsh.sharded_inits(mesh, lambda site, shape: seen.append(shape)
                             or whole, None, "cpu")
    assert torch.equal(hook(("prefill", 0, "k"), (2, 3, 16, 2)),
                       whole[2:, :3])
    assert seen == [(4, 6, 16, 2)]


def _gear_specs(**kw):
    base = dict(batch=2, num_kv_heads=2, head_dim=32, max_len=256, bits=4,
                group=32, rank=2, prefill_rank=4, lowrank_loop=3)
    base.update(kw)
    return (C.CacheSpec(**base, dtype=jnp.float32, sideband_dtype=jnp.float32),
            TC.CacheSpec(**base, dtype=torch.float32,
                         sideband_dtype=torch.float32))


def _both_caches(rng, jspec, tspec, s=150, n_append=15):
    """The same prompt and appends through each package's prefill + append
    (the port handed gear_tpu's inits): 165 tokens, 160 of them compressed
    in 5 blocks (the last by a flush), 5 residual."""
    shape = (2, 2, s, 32)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jc = jax.jit(functools.partial(C.prefill, jspec))(
        jnp.asarray(k), jnp.asarray(v), key=key)
    tc = TC.prefill(tspec, torch.from_numpy(k), torch.from_numpy(v),
                    p0=_prefill_p0(key))
    japp = jax.jit(functools.partial(C.append, jspec))
    for i in range(n_append):
        kn = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        vn = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        skey = jax.random.PRNGKey(100 + i)
        p0 = _append_p0(skey, tc.comp_len)
        jc = japp(jc, jnp.asarray(kn), jnp.asarray(vn), key=skey)
        TC.append(tspec, tc, torch.from_numpy(kn), torch.from_numpy(vn),
                  p0=p0)
    return jc, tc


def _jax_shard(split, i):
    return {f: np.asarray(getattr(split, f)[i])
            for f in TC.TENSOR_FIELDS + TC.LENGTH_FIELDS}


def test_split_cache_matches_reference_own_caches(rng):
    """Each package splits the cache its own prefill + append built (GEARL):
    the shards agree leaf by leaf as the caches do (codes, sidebands and
    lengths bit for bit, the error bases within 1e-5)."""
    jspec, tspec = _gear_specs()
    jc, tc = _both_caches(rng, jspec, tspec)
    assert (tc.comp_len, tc.resid_len, tc.prefill_len) == (160, 5, 128)
    jsplit = jctx.split_cache(jspec, jc, 4)
    shards = tctx.split_cache(tspec, tc, 4)
    assert len(shards) == 4
    for i, shard in enumerate(shards):
        want = _jax_shard(jsplit, i)
        for f in TC.TENSOR_FIELDS:
            got = getattr(shard, f).numpy()
            assert got.shape == want[f].shape and \
                getattr(shard, f).is_contiguous(), f
            if f in ("kpt", "kqt", "vpt", "vqt"):
                np.testing.assert_allclose(got, want[f], rtol=1e-5,
                                           atol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(got, want[f], err_msg=f)
        for f in TC.LENGTH_FIELDS:
            assert getattr(shard, f) == int(want[f]), (i, f)


@pytest.mark.parametrize("kw", [
    dict(outliers_per_block=40),
    dict(outliers_per_block=40, base_bits=8, kcvt_prefill=True),
], ids=["gear", "gear int8 bases kcvt"])
def test_split_cache_bit_for_bit_on_one_cache(rng, kw):
    """gear_tpu's cache, with outliers (and int8 bases), carried across:
    the port's shards equal gear_tpu's bit for bit, leaf by leaf."""
    jspec, tspec = _gear_specs(**kw)
    jc, _ = _both_caches(rng, jspec, tspec)
    tc = convert.cache_from_numpy(_fields(jc))
    jsplit = jctx.split_cache(jspec, jc, 4)
    for i, shard in enumerate(tctx.split_cache(tspec, tc, 4)):
        want = _jax_shard(jsplit, i)
        for f in TC.TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(shard, f).numpy(), want[f],
                                          err_msg=f)
        for f in TC.LENGTH_FIELDS:
            assert getattr(shard, f) == int(want[f]), (i, f)


def test_split_cache_of_stacked_layers(rng):
    _, tspec = _gear_specs()
    k = torch.from_numpy(rng.standard_normal((2, 2, 150, 32)).astype(
        np.float32))
    layers = [TC.prefill(tspec, k * (i + 1), k, generator=torch.Generator()
                         .manual_seed(i)) for i in range(2)]
    stacked = tctx.split_cache(tspec, TC.stack_layers(layers), 2)
    for i in range(2):
        one = tctx.split_cache(tspec, layers[i], 2)
        for s in range(2):
            for f in TC.TENSOR_FIELDS:
                assert torch.equal(getattr(stacked[s], f)[i],
                                   getattr(one[s], f)), (f, i, s)


@pytest.mark.parametrize("pad", [None, [0, 37]])
def test_shard_partials_merged_equal_attend(rng, pad):
    """Each shard's partial state (with its token offset) merged in one
    process equals ``attend`` on the whole cache: left padding, a residual
    tier, and a shard with nothing compressed."""
    _, tspec = _gear_specs(outliers_per_block=40)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 150, 32)).astype(
        np.float32)) for _ in range(2))
    cache = TC.prefill(tspec, k, v, generator=torch.Generator().manual_seed(1))
    assert cache.resid_len == 22 and cache.comp_len == 128
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 32)).astype(
        np.float32))
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    want = TC.attend(tspec, cache, q, pad_start=pad_t)
    lspec = tctx.shard_spec(tspec, 4)
    parts = [TC.attend_partial(lspec, shard, q, pad_start=pad_t,
                               token_offset=i * lspec.max_len)
             for i, shard in enumerate(tctx.split_cache(tspec, cache, 4))]
    got = TC.merge_partials(parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    one = TC.merge_partials([TC.attend_partial(tspec, cache, q,
                                               pad_start=pad_t)])
    np.testing.assert_allclose(one.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_shard_spec_refuses_partial_groups():
    _, tspec = _gear_specs()
    with pytest.raises(ValueError, match="whole groups"):
        tctx.shard_spec(tspec, 3)
    assert tctx.shard_spec(tspec, 8).max_len == 32


def test_timeit_and_trace_on_the_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2}

    t = TP.timeit(fn, torch.ones(8), iters=3, inner=2)
    assert t >= 0 and len(calls) == 4  # a warm-up and three timed calls
    with TP.trace(str(tmp_path)) as prof:
        torch.ones(64) @ torch.ones(64)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert prof.key_averages()


def test_h100_bound_takes_the_slower_of_bytes_and_operations():
    """The card's least time, as chip_smoke's kernel rows state it: bytes
    over 3.35 TB/s or float32 operations over 67 TFLOP/s."""
    assert TP.H100_SXM.bound_s(3.35e9, 0) == (1e-3, "bytes")
    t, by = TP.H100_SXM.bound_s(3.35e9, 134e9)
    assert by == "operations" and abs(t - 2e-3) < 1e-15
