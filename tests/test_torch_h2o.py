"""Parity of the port's H2O cache (``gear_tpu_torch.h2o``) and engine mode
``h2o`` with ``gear_tpu`` on the CPU.

The same numpy K/V/q go through both packages step by step across several
evictions: kept slots, positions and scores match (ties in the
heavy-hitter vote go to the lower slot in both), outputs within float32
rounding. The engines' greedy tokens on a tiny float32 Llama are identical
through eviction. The checks of ``tests/test_h2o.py`` are repeated on the
port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import h2o as JH
from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.engine import EngineConfig as JEngineConfig
from gear_tpu.engine import InferenceEngine as JEngine
from gear_tpu.models import llama as jllama
from gear_tpu_torch import convert
from gear_tpu_torch import h2o as TH
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.engine import EngineConfig as TEngineConfig
from gear_tpu_torch.engine import InferenceEngine as TEngine
from gear_tpu_torch.models import llama as tllama


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: across the suite's parallel workers its
    per-op thread pool oversubscribes the cores (results do not depend on
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_spec(mod, **kw):
    base = dict(batch=1, num_kv_heads=2, head_dim=16, budget=16, important=8,
                dtype=jnp.float32 if mod is JH else torch.float32)
    base.update(kw)
    return mod.H2OSpec(**base)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_append_until_budget(rng):
    spec = mk_spec(TH)
    c = TH.init(spec)
    for i in range(10):
        c = TH.append(spec, c, torch.from_numpy(rand(rng, 1, 2, 1, 16)),
                      torch.from_numpy(rand(rng, 1, 2, 1, 16)), i)
    assert c.length == 10
    assert c.pos[0, 0, :10].tolist() == list(range(10))


def test_heavy_hitter_survives(rng):
    """A position that dominates attention mass is not evicted."""
    spec = mk_spec(TH, budget=8, important=4, num_kv_heads=1)
    c = TH.init(spec)
    big_k = torch.ones((1, 1, 1, 16)) * 2.0
    q = torch.ones((1, 1, 1, 16))
    TH.append(spec, c, big_k, big_k, 0)
    for i in range(1, 14):
        TH.append(spec, c, torch.from_numpy(rand(rng, 1, 1, 1, 16)) * 0.1,
                  torch.from_numpy(rand(rng, 1, 1, 1, 16)), i)
        TH.attend(spec, c, q)
    assert 0 in c.pos[0, 0].tolist(), "heavy hitter evicted"


def test_attend_matches_exact_before_eviction(rng):
    spec = mk_spec(TH, budget=32, important=16)
    c = TH.init(spec)
    ks, vs = [], []
    for i in range(12):
        k1, v1 = rand(rng, 1, 2, 1, 16), rand(rng, 1, 2, 1, 16)
        ks.append(k1), vs.append(v1)
        TH.append(spec, c, torch.from_numpy(k1), torch.from_numpy(v1), i)
    q = rand(rng, 1, 4, 1, 16)
    out = TH.attend(spec, c, torch.from_numpy(q))
    k_all, v_all = np.concatenate(ks, 2), np.concatenate(vs, 2)
    s = np.einsum("bhqd,bhtd->bhqt", q.reshape(1, 2, 2, 16), k_all) / 4.0
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    want = np.einsum("bhqt,bhtd->bhqd", w, v_all).reshape(1, 4, 1, 16)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)


def test_spec_refuses_important_over_budget():
    with pytest.raises(ValueError, match="important"):
        mk_spec(TH, budget=8, important=7)


@pytest.mark.parametrize("budget,important,batch,ties", [
    (16, 8, 1, False), (12, 4, 2, False), (8, 3, 2, True)])
def test_append_attend_match_reference_across_evictions(rng, budget,
                                                        important, batch,
                                                        ties):
    """Step by step over 3 x budget tokens, positions per batch row: the
    kept slots, positions, scores and the outputs of both packages agree.
    With ``ties`` every key is equal, so all scores tie and the vote falls
    to the lower slots."""
    js, ts = (mk_spec(m, budget=budget, important=important, batch=batch)
              for m in (JH, TH))
    jc, tc = JH.init(js), TH.init(ts)
    jstep = jax.jit(lambda c, k, v, p, q: JH.attend(
        js, JH.append(js, c, k, v, p), q))
    for i in range(3 * budget):
        k = (np.ones((batch, 2, 1, 16), np.float32) if ties
             else rand(rng, batch, 2, 1, 16))
        v, q = rand(rng, batch, 2, 1, 16), rand(rng, batch, 4, 1, 16)
        position = np.arange(batch, dtype=np.int32) * 100 + i
        jout, jc = jstep(jc, k, v, position, q)
        TH.append(ts, tc, torch.from_numpy(k), torch.from_numpy(v),
                  torch.from_numpy(position))
        tout = TH.attend(ts, tc, torch.from_numpy(q))
        assert tc.length == int(jc.length)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        np.testing.assert_allclose(tc.score.numpy(), np.asarray(jc.score),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
    assert tc.length <= budget


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.ModelConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _comp(cfg, **kw):
    return dict(num_layers=cfg.num_layers, group_size=16, important_size=6,
                recent_size=26, **kw)


def test_engine_greedy_tokens_match_reference(tiny):
    """Left-padded prompts in a bucket of 32 = the budget, 20 new tokens:
    eviction at every decode step. The prefill scores, the evictions and
    the tokens agree with gear_tpu's engine."""
    jcfg, tcfg, jparams, tparams = tiny
    prompts = [[5, 9, 2, 7, 11, 3, 8, 4, 1, 6, 12, 13, 14, 15, 16, 17, 18,
                19, 21, 22], [4, 1, 6, 20, 30]]
    jeng = JEngine(jcfg, jparams, JComp(**_comp(jcfg)),
                   JEngineConfig(max_len=64, mode="h2o"), batch_size=2)
    teng = TEngine(tcfg, tparams, TComp(**_comp(tcfg)),
                   TEngineConfig(max_len=64, mode="h2o"), batch_size=2,
                   device="cpu")
    assert teng.hspec.budget == 32 and teng.hspec.important == 6
    assert teng.generate(prompts, 20) == jeng.generate(prompts, 20)

    # the prefill's cache: scores of received attention, pads at -1
    tokens, mask = teng.left_pad(prompts, 0, 32)
    _, caches = teng.prefill(tokens, mask)
    positions = jnp.maximum(jnp.cumsum(np.asarray(mask), axis=1) - 1, 0)
    _, jcaches = jllama.forward_prefill_h2o(
        jparams, jcfg, np.asarray(tokens, np.int32), positions,
        np.asarray(mask), jeng.hspec)
    np.testing.assert_array_equal(caches.pos.numpy(), np.asarray(jcaches.pos))
    np.testing.assert_allclose(caches.score.numpy(),
                               np.asarray(jcaches.score), rtol=1e-5,
                               atol=1e-5)
    assert caches.length == 32 and (caches.pos[:, 1, :, :27] == -1).all()


def test_engine_refuses_a_bucket_over_the_budget(tiny):
    _, tcfg, _, tparams = tiny
    teng = TEngine(tcfg, tparams, TComp(**_comp(tcfg)),
                   TEngineConfig(max_len=64, mode="h2o"), batch_size=1,
                   device="cpu")
    with pytest.raises(ValueError, match="exceeds the H2O budget 32"):
        teng.generate([list(range(1, 40))], 2)
