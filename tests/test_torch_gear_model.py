"""The full GEAR recipe through the port, against gear_tpu on the CPU:
greedy generation on a tiny Mistral (sliding window 32, group 16) and a tiny
Llama for GEAR, GEAR-KCVT, GEARL-KCVT and raw mode, float32 weights carried
across with ``convert``, the power-iteration inits injected. Greedy tokens
must be identical, over enough steps to cross a flush and (Mistral) to make
the window bind.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.engine import EngineConfig as JEngineConfig
from gear_tpu.engine import InferenceEngine as JEngine
from gear_tpu.models import llama as jllama
from gear_tpu.models import mistral as jmistral
from gear_tpu_torch import GearLM, convert
from gear_tpu_torch.config import METHODS
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.engine import EngineConfig as TEngineConfig
from gear_tpu_torch.engine import InferenceEngine as TEngine
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.models import mistral as tmistral
from test_torch_model import engine_inits

PROMPTS = [[1, 5, 9, 12, 3, 44, 7, 19, 23, 4, 90, 17, 8, 2, 61, 33, 70, 21,
            14, 6, 11, 5], [3, 7, 100, 41, 250, 9]]
N_NEW = 30   # 22 + 30 > 32: the window binds; the residual tier flushes


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, jcfg, tcfg in (
            ("mistral", jmistral.tiny(dtype=jnp.float32),
             tmistral.tiny(dtype=torch.float32)),
            ("llama", jllama.ModelConfig.tiny(dtype=jnp.float32),
             tllama.ModelConfig.tiny(dtype=torch.float32))):
        jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
        out[name] = (jcfg, tcfg, jparams, tparams)
    return out


def _comp(cfg, method, **kw):
    base = dict(num_layers=cfg.num_layers, compress_method=method,
                quantize_bit=4, group_size=16, rank=2, prefill_rank=4, loop=2,
                left=0.05)
    base.update(kw)
    return base


def test_mistral_configs_match_reference():
    for j, t in ((jmistral.mistral_7b(), tmistral.mistral_7b()),
                 (jmistral.tiny(), tmistral.tiny())):
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "rope_theta", "rms_eps", "max_position_embeddings",
                  "tie_word_embeddings", "sliding_window"):
            assert getattr(t, f) == getattr(j, f), f
    assert tmistral.forward_decode is tllama.forward_decode


@pytest.mark.parametrize("method", METHODS)
def test_cache_spec_of_every_method_matches_reference(models, method):
    """In fused mode the method acts through two switches only: outliers
    (names GEAR* but not GEARL*) and KCVT (names *KCVT)."""
    jcfg, tcfg, _, _ = models["mistral"]
    js = jcfg.cache_spec(2, 64, JComp(**_comp(jcfg, method)).layer(0))
    ts = tcfg.cache_spec(2, 64, TComp(**_comp(tcfg, method)).layer(0))
    for f in ("bits", "group", "rank", "prefill_rank", "rank_v",
              "prefill_rank_v", "lowrank_loop", "outliers_per_block",
              "kcvt_prefill", "ko_store", "r_store", "v_group"):
        assert getattr(ts, f) == getattr(js, f), f
    assert bool(ts.outliers_per_block) == (
        method.startswith("GEAR") and not method.startswith("GEARL"))
    assert ts.kcvt_prefill == method.endswith("KCVT")


@pytest.mark.parametrize("model,method,mode", [
    ("mistral", "GEAR", "fused"),
    ("mistral", "GEAR-KCVT", "fused"),
    ("mistral", "GEARL-KCVT", "fused"),
    ("mistral", "GEAR", "raw"),
    ("llama", "GEAR", "fused"),
    ("llama", "GEAR-KCVT", "fused"),
    ("llama", "GEARL-KCVT", "fused"),
    ("llama", "GEAR", "raw"),
])
def test_greedy_tokens_match_reference(models, model, method, mode):
    jcfg, tcfg, jparams, tparams = models[model]
    comp = _comp(jcfg, method)
    jeng = JEngine(jcfg, jparams, JComp(**comp),
                   JEngineConfig(max_len=96, mode=mode), batch_size=2)
    teng = TEngine(tcfg, tparams, TComp(**comp),
                   TEngineConfig(max_len=96, mode=mode), batch_size=2,
                   device="cpu")
    if mode == "fused":
        assert teng.spec.outliers_per_block == (
            0 if method.startswith("GEARL") else 12)
        assert teng.spec.kcvt_prefill == method.endswith("KCVT")
    want = jeng.generate(PROMPTS, N_NEW)
    got = teng.generate(PROMPTS, N_NEW, init=engine_inits(tcfg.num_layers))
    assert got == want


@pytest.mark.parametrize("method", [m for m in METHODS if m != "NONE"])
def test_every_method_generates_in_fused_mode(models, method):
    """No method of METHODS is refused in fused mode any more."""
    _, tcfg, _, tparams = models["mistral"]
    lm = GearLM(cfg=tcfg, params=tparams, comp=TComp(**_comp(tcfg, method)),
                engine_cfg=TEngineConfig(max_len=64, mode="fused"),
                batch_size=2, device="cpu")
    out = lm.generate(PROMPTS, 12)
    assert [len(o) for o in out] == [12, 12]
    assert all(0 <= t < tcfg.vocab_size for o in out for t in o)


def test_default_compression_config_is_gear_and_generates(models):
    _, tcfg, _, tparams = models["llama"]
    eng = TEngine(tcfg, tparams, None, TEngineConfig(max_len=128),
                  batch_size=1, device="cpu")
    assert eng.comp.compress_method == "GEAR"
    assert eng.spec.outliers_per_block == int(0.02 * 64 * 16) // 2 * 2
    prompt = list(range(1, 70))
    assert len(eng.generate([prompt], 4)[0]) == 4


def test_use_lowrank_off_leaves_bases_zero(models):
    _, tcfg, _, tparams = models["llama"]
    eng = TEngine(tcfg, tparams, TComp(**_comp(tcfg, "GEAR")),
                  TEngineConfig(max_len=64, use_lowrank=False), batch_size=2,
                  device="cpu")
    tokens, mask = eng.left_pad(PROMPTS, 0, 32)
    logits, caches = eng.prefill(tokens, mask)
    cur = logits[:, -1].argmax(-1)
    for step in range(18):  # crosses a flush
        cur, _, caches = eng.decode_step(
            caches, cur, mask.sum(1).int() + step,
            (32 - mask.sum(1)).int(), step=step)
    assert caches.comp_len == 48
    assert not caches.kpt.any() and not caches.vqt.any()
    assert caches.k_out_val.any()


def test_engine_refuses_window_below_group(models):
    jcfg, tcfg, jparams, tparams = models["mistral"]
    comp = _comp(tcfg, "GEAR", group_size=64)
    with pytest.raises(ValueError, match="sliding_window"):
        JEngine(jcfg, jparams, JComp(**comp), JEngineConfig(max_len=128),
                batch_size=2)
    with pytest.raises(ValueError, match="sliding_window"):
        TEngine(tcfg, tparams, TComp(**comp), TEngineConfig(max_len=128),
                batch_size=2, device="cpu")
