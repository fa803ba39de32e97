"""Parity of the port's StreamingLLM sink cache (``gear_tpu_torch.sink``)
and engine mode ``sink`` with ``gear_tpu`` on the CPU.

Ring slots and cache-relative positions agree with the reference for every
length up to several wraps; attention (keys stored unrotated, rotated at
attend time) agrees step by step across the wrap; the engines' greedy
tokens on a tiny float32 Llama are identical through the wrap. The checks
of ``tests/test_sink.py`` are repeated on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import sink as JS
from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.engine import EngineConfig as JEngineConfig
from gear_tpu.engine import InferenceEngine as JEngine
from gear_tpu.models import llama as jllama
from gear_tpu_torch import convert
from gear_tpu_torch import sink as TS
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
    base = dict(batch=1, num_kv_heads=2, head_dim=16, num_sink=2, window=6,
                dtype=jnp.float32 if mod is JS else torch.float32)
    base.update(kw)
    return mod.SinkSpec(**base)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_relative_positions_before_and_after_wrap():
    spec = mk_spec(TS)  # capacity 8
    pos = TS._relative_positions(spec, 5).tolist()
    assert pos[:5] == [0, 1, 2, 3, 4] and pos[5:] == [-1, -1, -1]
    pos = TS._relative_positions(spec, 11).tolist()
    assert pos[:2] == [0, 1] and sorted(pos[2:]) == [2, 3, 4, 5, 6, 7]


@pytest.mark.parametrize("num_sink,window", [(2, 6), (4, 5), (1, 8)])
def test_slots_and_positions_match_reference(num_sink, window):
    js, ts = (mk_spec(m, num_sink=num_sink, window=window) for m in (JS, TS))
    for n in range(4 * js.capacity):
        assert TS._slot_for(ts, n) == int(JS._slot_for(js, jnp.int32(n)))
        np.testing.assert_array_equal(
            TS._relative_positions(ts, n).numpy(),
            np.asarray(JS._relative_positions(js, jnp.int32(n))))


def test_attend_matches_exact_before_eviction(rng):
    """While nothing is evicted, sink attention is standard attention at
    absolute positions."""
    spec = mk_spec(TS)
    c = TS.init(spec)
    ks, vs, n = [], [], 7
    for _ in range(n):
        k1, v1 = rand(rng, 1, 2, 1, 16), rand(rng, 1, 2, 1, 16)
        ks.append(k1), vs.append(v1)
        TS.append(spec, c, torch.from_numpy(k1), torch.from_numpy(v1))
    q = torch.from_numpy(rand(rng, 1, 2, 1, 16))
    got = TS.attend(spec, c, q)
    k_all = torch.from_numpy(np.concatenate(ks, axis=2))
    cos, sin = tllama.rope_cos_sin(torch.arange(n)[None], 16, spec.rope_theta)
    k_rot = tllama.apply_rope(k_all, cos, sin)
    cq, sq = tllama.rope_cos_sin(torch.tensor([[n - 1]]), 16, spec.rope_theta)
    s = torch.einsum("bhqd,bhtd->bhqt", tllama.apply_rope(q, cq, sq),
                     k_rot) * (16 ** -0.5)
    want = torch.einsum("bhqt,bhtd->bhqd", torch.softmax(s, -1),
                        torch.from_numpy(np.concatenate(vs, axis=2)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_attend_matches_reference_across_wraps(rng):
    """Step by step over 2.5 x capacity tokens, GQA 2, batch 2: the ring
    and the outputs of both packages agree; memory stays fixed."""
    js, ts = (mk_spec(m, batch=2) for m in (JS, TS))
    jc, tc = JS.init(js), TS.init(ts)
    jstep = jax.jit(lambda c, k, v, q: (lambda c2: (JS.attend(js, c2, q),
                                                    c2))(
        JS.append(js, c, k, v)))
    for _ in range(20):
        k, v = rand(rng, 2, 2, 1, 16), rand(rng, 2, 2, 1, 16)
        q = rand(rng, 2, 4, 1, 16)
        jout, jc = jstep(jc, k, v, q)
        TS.append(ts, tc, torch.from_numpy(k), torch.from_numpy(v))
        tout = TS.attend(ts, tc, torch.from_numpy(q))
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
    assert tc.length == 20 and tc.k.shape[2] == ts.capacity


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.ModelConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _comp(cfg):
    return dict(num_layers=cfg.num_layers, group_size=16, sink_size=3,
                window_size=29)


def test_engine_greedy_tokens_match_reference(tiny):
    """Left-padded prompts in a bucket of 32 = the capacity, 24 new
    tokens: the ring wraps from the first decode step. Tokens and the
    unrotated keys of the prefill agree with gear_tpu's engine."""
    jcfg, tcfg, jparams, tparams = tiny
    prompts = [[5, 9, 2, 7, 11, 3, 8, 4, 1, 6, 12, 13, 14, 15, 16, 17, 18,
                19, 21, 22], [4, 1, 6, 20, 30]]
    jeng = JEngine(jcfg, jparams, JComp(**_comp(jcfg)),
                   JEngineConfig(max_len=64, mode="sink"), batch_size=2)
    teng = TEngine(tcfg, tparams, TComp(**_comp(tcfg)),
                   TEngineConfig(max_len=64, mode="sink"), batch_size=2,
                   device="cpu")
    assert teng.sspec.capacity == 32
    assert teng.generate(prompts, 24) == jeng.generate(prompts, 24)

    tokens, mask = teng.left_pad(prompts, 0, 32)
    logits, caches = teng.prefill(tokens, mask)
    positions = jnp.maximum(jnp.cumsum(np.asarray(mask), axis=1) - 1, 0)
    jlogits, jcaches = jllama.forward_prefill_sink(
        jparams, jcfg, np.asarray(tokens, np.int32), positions,
        np.asarray(mask), jeng.sspec)
    np.testing.assert_allclose(caches.k.numpy(), np.asarray(jcaches.k),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_engine_refuses_a_bucket_over_the_capacity(tiny):
    _, tcfg, _, tparams = tiny
    teng = TEngine(tcfg, tparams, TComp(**_comp(tcfg)),
                   TEngineConfig(max_len=64, mode="sink"), batch_size=1,
                   device="cpu")
    with pytest.raises(ValueError, match="exceeds the sink capacity 32"):
        teng.generate([list(range(1, 40))], 2)
