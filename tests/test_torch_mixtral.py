"""The port's Mixtral (``gear_tpu_torch.models.mixtral``) against
``gear_tpu.models.mixtral`` on the CPU: the expert mixture and its routing,
the configs and the parameter layout, prefill and decode logits over the
compressed and the raw cache on a tiny float32 model (weights carried across
with ``convert``, the power-iteration inits injected), and the Llama passes
unchanged by the feed-forward hook Mixtral plugs into."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.models import llama as jllama
from gear_tpu.models import mixtral as jm
from gear_tpu_torch import convert
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.models import mixtral as tm
from test_torch_model import _flush_key, _uniform


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Across the suite's parallel workers torch's per-op thread pool
    oversubscribes the cores; the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jm.MixtralConfig.tiny(dtype=jnp.float32)
    tcfg = tm.MixtralConfig.tiny(dtype=torch.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _moe_inputs(rng, e=16, ne=4, f=32):
    x = rng.standard_normal((2, 5, e)).astype(np.float32)
    router = rng.standard_normal((e, ne)).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((ne, e, f), (ne, e, f), (ne, f, e))]
    return x, router, w


@pytest.mark.parametrize("rows", [tm.MOE_ROWS, 3])  # 3: chunks of rows
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_moe_block_matches_reference(rng, monkeypatch, dtype, tol, rows):
    monkeypatch.setattr(tm, "MOE_ROWS", rows)
    x, router, w = _moe_inputs(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jm.moe_block(jnp.asarray(x, jdt), jnp.asarray(router, jdt),
                        *(jnp.asarray(a, jdt) for a in w), top_k=2)
    got = tm.moe_block(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(router).to(tdt),
                       *(torch.from_numpy(a).to(tdt) for a in w), top_k=2)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_zero_router_weights_every_expert_alike(rng):
    """A zero router ties every expert: top-2 of 4 then keeps all four, each
    at 1/4, in both packages (a scatter of the top-k indices would keep
    two)."""
    x, router, (wg, wu, wd) = _moe_inputs(rng)
    router[:] = 0.0
    got = tm.moe_block(*(torch.from_numpy(a) for a in (x, router, wg, wu,
                                                       wd)), top_k=2)
    want = jm.moe_block(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)),
                        top_k=2)
    xt = torch.from_numpy(x)
    mean = sum(tllama.mlp_block(xt, *(torch.from_numpy(a[n])
                                      for a in (wg, wu, wd)))
               for n in range(4)) / 4
    np.testing.assert_allclose(got.numpy(), mean.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_configs_and_param_count_match_reference(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    hf = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
              num_hidden_layers=32, num_attention_heads=32,
              num_key_value_heads=8, rope_theta=1e6, rms_norm_eps=1e-5,
              max_position_embeddings=32768, sliding_window=None,
              num_local_experts=8, num_experts_per_tok=2)
    pairs = [(jm.MixtralConfig.from_hf(hf), tm.MixtralConfig.from_hf(hf)),
             (jm.MixtralConfig.mixtral_8x7b(),
              tm.MixtralConfig.mixtral_8x7b()), (jcfg, tcfg)]
    for j, t in pairs:
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert pairs[0][1] == tm.MixtralConfig.mixtral_8x7b()
    n = jllama.param_count(jparams)
    assert tllama.param_count(tparams) == n
    assert tllama.param_count(tm.init_params(tcfg, device="cpu")) == n


def test_reference_params_carried_across(tiny):
    """gear_tpu's bf16 init, through ``convert``: the same leaves, shapes,
    dtypes and bits (router and the [L, NE, ...] expert stacks included)."""
    jcfg, tcfg, _, _ = tiny
    jparams = jm.init_params(jax.random.PRNGKey(1), jm.MixtralConfig.tiny())
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    mine = tm.init_params(tm.MixtralConfig.tiny(), device="cpu")
    assert set(tparams["layers"]) == set(mine["layers"]) == {
        "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "router", "wg",
        "wu", "wd"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [k.key for k in path]
        t, m = tparams, mine
        for k in keys:
            t, m = t[k], m[k]
        assert t.dtype == m.dtype == torch.bfloat16
        assert tuple(t.shape) == tuple(m.shape) == leaf.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(leaf).view(np.int16))


def _prompt():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 256, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0  # left padding
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return tokens, mask, pos


@pytest.mark.parametrize("method,compress", [
    ("GEAR", True), ("GEARL", True), ("GEAR", False)],
    ids=["gear", "gearl", "raw"])
def test_prefill_and_decode_logits_match_reference(tiny, method, compress):
    """Prefill, then 10 decode steps through a flush (the residual tier of
    16 fills at step 8): logits within 1e-4 of gear_tpu's at every step."""
    jcfg, tcfg, jparams, tparams = tiny
    comp = dict(num_layers=jcfg.num_layers, compress_method=method,
                quantize_bit=4, group_size=16, rank=2, prefill_rank=4,
                loop=2, left=0.05)
    jspec = jcfg.cache_spec(2, 64, JComp(**comp).layer(0))
    tspec = tcfg.cache_spec(2, 64, TComp(**comp).layer(0))
    assert bool(tspec.outliers_per_block) == (method == "GEAR")
    tokens, mask, pos = _prompt()
    prng = jax.random.PRNGKey(3)
    jlog, jcaches = jax.jit(lambda p, t, q, m, k: jm.forward_prefill(
        p, jcfg, t, q, m, jspec, compress=compress, prng=k))(
            jparams, tokens, pos, mask, prng)
    pkeys = jax.random.split(prng, jcfg.num_layers)

    def pre_init(site, shape):
        kk, kv = jax.random.split(pkeys[site[1]])
        return _uniform(kk if site[2] == "k" else kv, shape)

    tlog, tcaches = tm.forward_prefill(
        tparams, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
        torch.from_numpy(mask), tspec, compress=compress, init=pre_init)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    jdec = jax.jit(functools.partial(jm.forward_decode, cfg=jcfg, spec=jspec,
                                     compress=compress))
    pad_start = np.array([0, 5], np.int32)
    tok = np.asarray(jlog[:, -1].argmax(-1)).astype(np.int32)
    position = mask.sum(1).astype(np.int32)
    for step in range(10):
        dkey = jax.random.PRNGKey(50 + step)
        lkeys = jax.random.split(dkey, jcfg.num_layers)
        jlog_d, jcaches = jdec(jparams, token=tok, position=position + step,
                               caches=jcaches, pad_start=pad_start, prng=dkey)
        tlog_d, tcaches = tm.forward_decode(
            tparams, tcfg, torch.from_numpy(tok).long(),
            torch.from_numpy(position + step), tcaches, spec=tspec,
            compress=compress, pad_start=torch.from_numpy(pad_start),
            step=step, init=lambda site, shape, lk=lkeys: _uniform(
                _flush_key(lk[site[2]], site[4], site[3]), shape))
        np.testing.assert_allclose(tlog_d.numpy(), np.asarray(jlog_d),
                                   rtol=1e-4, atol=1e-4)
        tok = np.asarray(jlog_d.argmax(-1)).astype(np.int32)
    if compress:
        assert tcaches.comp_len == int(jcaches.comp_len[0]) == 32
        np.testing.assert_array_equal(tcaches.v_codes.numpy(),
                                      np.asarray(jcaches.v_codes))
    else:
        assert tcaches.length == int(jcaches.length[0]) == 34


def _pre_hook_layers(params, cfg, h, cos, sin, mix, ffn=None, tp=None):
    """The Llama layer loop as it was before the feed-forward hook (taking
    ``_layers``' arguments; no tensor parallelism here)."""
    assert tp is None
    for i in range(cfg.num_layers):
        lp = tllama._layer_slice(params["layers"], i)
        q, k, v = tllama._qkv(cfg, lp, h, cos, sin)
        attn = mix(i, q, k, v)
        b, s = h.shape[:2]
        h = h + attn.transpose(1, 2).reshape(b, s, -1) @ lp["wo"]
        x2 = tllama.rmsnorm(h, lp["mlp_norm"], cfg.rms_eps)
        h = h + tllama.mlp_block(x2, lp["wg"], lp["wu"], lp["wd"])
    h = tllama.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return tllama.logits_from_hidden(params, cfg, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_llama_passes_unchanged_by_the_ffn_hook(monkeypatch, dtype):
    """Prefill and decode through a flush, fused: bit for bit what the loop
    without the hook gives."""
    cfg = tllama.ModelConfig.tiny(dtype=dtype)
    params = tllama.init_params(cfg, seed=2, device="cpu")
    spec = cfg.cache_spec(2, 64, TComp(num_layers=2, quantize_bit=4,
                                       group_size=16).layer(0))
    tokens, mask, pos = (torch.from_numpy(a) for a in _prompt())

    def run():
        gen = torch.Generator().manual_seed(0)
        logits, caches = tllama.forward_prefill(
            params, cfg, tokens.long(), pos, mask, spec, generator=gen)
        out = [logits]
        tok = logits[:, -1].argmax(-1)
        for step in range(10):
            lg, caches = tllama.forward_decode(
                params, cfg, tok, mask.sum(1) + step, caches, spec=spec,
                pad_start=torch.tensor([0, 5]), generator=gen, step=step)
            out.append(lg)
            tok = lg.argmax(-1)
        return out

    now = run()
    monkeypatch.setattr(tllama, "_layers", _pre_hook_layers)
    before = run()
    assert all(torch.equal(a, b) for a, b in zip(now, before))


def test_one_expert_mixtral_is_llama(tiny):
    """With one expert, routed always, Mixtral's layer is Llama's: the same
    logits from the same weights (float32)."""
    cfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, seed=4, device="cpu")
    mcfg = tm.MixtralConfig.tiny(dtype=torch.float32, num_experts=1,
                                 experts_per_token=1)
    layers = dict(params["layers"])
    for w in ("wg", "wu", "wd"):
        layers[w] = layers[w][:, None]
    layers["router"] = torch.randn(cfg.num_layers, cfg.hidden_size, 1)
    mparams = {**params, "layers": layers}
    tokens, mask, pos = (torch.from_numpy(a) for a in _prompt())
    want, _ = tllama.forward_prefill(params, cfg, tokens.long(), pos, mask,
                                     None)
    got, _ = tm.forward_prefill(mparams, mcfg, tokens.long(), pos, mask, None)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_blockwise_prefill_with_a_short_last_chunk(rng):
    """A prompt no chunk of 64 or more divides runs its last chunk short
    (the reference halves the chunk to 4 here): the same attention."""
    q = rng.standard_normal((2, 4, 100, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 100, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 100, 16)).astype(np.float32)
    mask = np.ones((2, 100), np.int32)
    mask[1, :9] = 0
    want = jllama._causal_attention_blockwise(
        *(jnp.asarray(a) for a in (q, k, v, mask)), chunk=16)
    tq, tk, tv, tmask = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = tllama._causal_attention_blockwise(tq, tk, tv, tmask, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dense = tllama.causal_attention(tq, tk, tv, tmask)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_init_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(tm.MixtralConfig.tiny())
