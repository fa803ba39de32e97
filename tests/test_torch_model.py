"""Parity of the PyTorch port's model, engine and loader with gear_tpu on a
tiny float32 Llama (CPU), and the port's isolation from JAX.

Weights are carried across with convert.params_from_numpy, and the port is
handed the JAX side's power-iteration inits (jax.random draws along the
same key chain), so prefill/decode logits agree within 1e-4 and greedy
tokens are identical.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.engine import EngineConfig as JEngineConfig
from gear_tpu.engine import InferenceEngine as JEngine
from gear_tpu.models import llama as jllama
from gear_tpu.models import loader as jloader
from gear_tpu_torch import convert
from gear_tpu_torch.api import GearLM
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.engine import EngineConfig as TEngineConfig
from gear_tpu_torch.engine import InferenceEngine as TEngine
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.models import loader as tloader

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.ModelConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _uniform(key, shape):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, shape, dtype=jnp.float32)))


def _flush_key(layer_key, comp_len, which):
    # gear_tpu.cache.append folds in comp_len; _flush folds in 0 and splits
    kk, kv = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(layer_key, comp_len), 0))
    return kk if which == "k" else kv


def engine_inits(num_layers, prng=None):
    """init(site, shape) replaying gear_tpu.engine.generate's key chain."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0) if prng is None else prng)
    prefill_keys = jax.random.split(k1, num_layers)
    subs = []

    def init(site, shape):
        nonlocal k2
        if site[0] == "prefill":
            _, layer, which = site
            kk, kv = jax.random.split(prefill_keys[layer])
            return _uniform(kk if which == "k" else kv, shape)
        _, step, layer, which, comp_len = site
        while len(subs) <= step:
            k2, sub = jax.random.split(k2)
            subs.append(sub)
        lkey = jax.random.split(subs[step], num_layers)[layer]
        return _uniform(_flush_key(lkey, comp_len, which), shape)
    return init


def _comp(cfg, **kw):
    base = dict(num_layers=cfg.num_layers, compress_method="GEARL",
                quantize_bit=4, group_size=16, rank=2, prefill_rank=4,
                loop=2)
    base.update(kw)
    return base


def test_forward_logits_match_reference(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    comp = _comp(jcfg)
    jspec = jcfg.cache_spec(2, 64, JComp(**comp).layer(0))
    tspec = tcfg.cache_spec(2, 64, TComp(**comp).layer(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0  # left padding
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    prng = jax.random.PRNGKey(3)

    jpre = jax.jit(lambda p, t, q, m, k: jllama.forward_prefill(
        p, jcfg, t, q, m, jspec, prng=k))
    jlog, jcaches = jpre(jparams, tokens, pos, mask, prng)
    pkeys = jax.random.split(prng, jcfg.num_layers)

    def pre_init(site, shape):
        kk, kv = jax.random.split(pkeys[site[1]])
        return _uniform(kk if site[2] == "k" else kv, shape)

    tlog, tcaches = tllama.forward_prefill(
        tparams, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
        torch.from_numpy(mask), tspec, init=pre_init)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)

    jdec = jax.jit(functools.partial(jllama.forward_decode, cfg=jcfg,
                                     spec=jspec))
    pad_start = np.array([0, 5], np.int32)
    tok = np.asarray(jlog[:, -1].argmax(-1)).astype(np.int32)
    position = mask.sum(1).astype(np.int32)
    for step in range(10):  # resid 8 -> flush at step 7
        dkey = jax.random.PRNGKey(50 + step)
        lkeys = jax.random.split(dkey, jcfg.num_layers)
        jlog_d, jcaches = jdec(jparams, token=tok, position=position + step,
                               caches=jcaches, pad_start=pad_start, prng=dkey)
        tlog_d, tcaches = tllama.forward_decode(
            tparams, tcfg, torch.from_numpy(tok).long(),
            torch.from_numpy(position + step), tcaches, spec=tspec,
            pad_start=torch.from_numpy(pad_start), step=step,
            init=lambda site, shape, lk=lkeys: _uniform(
                _flush_key(lk[site[2]], site[4], site[3]), shape))
        np.testing.assert_allclose(tlog_d.numpy(), np.asarray(jlog_d),
                                   rtol=1e-4, atol=1e-4)
        tok = np.asarray(jlog_d.argmax(-1)).astype(np.int32)
    assert tcaches.comp_len == int(jcaches.comp_len[0]) == 32
    np.testing.assert_array_equal(tcaches.v_codes.numpy(),
                                  np.asarray(jcaches.v_codes))


@pytest.mark.parametrize("mode,bits", [("raw", 4), ("fused", 8), ("fused", 4)])
def test_engine_greedy_tokens_match_reference(tiny, mode, bits):
    jcfg, tcfg, jparams, tparams = tiny
    comp = _comp(jcfg, quantize_bit=bits)
    prompts = [[1, 5, 9, 12, 3, 44, 7], [3, 7, 100]]
    n_new = 20  # prefill fills one block; the decode steps flush a second
    jeng = JEngine(jcfg, jparams, JComp(**comp),
                   JEngineConfig(max_len=64, mode=mode), batch_size=2)
    teng = TEngine(tcfg, tparams, TComp(**comp),
                   TEngineConfig(max_len=64, mode=mode), batch_size=2,
                   device="cpu")
    want = jeng.generate(prompts, n_new)
    got = teng.generate(prompts, n_new, init=engine_inits(tcfg.num_layers))
    assert got == want


def test_blockwise_prefill_attention_matches_reference(rng):
    q = rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 64, 16)).astype(np.float32)
    mask = np.ones((2, 64), np.int32)
    mask[0, :9] = 0
    want = jllama._causal_attention_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        chunk=16)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = tllama._causal_attention_blockwise(tq, tk, tv, tm, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dense = tllama.causal_attention(tq, tk, tv, tm)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_engine_eos_and_sampling(tiny):
    _, tcfg, _, tparams = tiny
    comp = TComp(**_comp(tcfg))
    first = TEngine(tcfg, tparams, comp, TEngineConfig(max_len=64),
                    batch_size=1, device="cpu").generate([[1, 2, 3]], 1)[0][0]
    eng = TEngine(tcfg, tparams, comp,
                  TEngineConfig(max_len=64, eos_token_id=first, sync_every=2),
                  batch_size=1, device="cpu")
    assert eng.generate([[1, 2, 3]], 10) == [[first]]
    hot = TEngine(tcfg, tparams, comp,
                  TEngineConfig(max_len=64, temperature=1.0), batch_size=2,
                  device="cpu")
    out = hot.generate([[1, 2, 3], [4]], 6, seed=3)
    assert out == hot.generate([[1, 2, 3], [4]], 6, seed=3)
    assert all(len(o) == 6 and all(0 <= t < tcfg.vocab_size for t in o)
               for o in out)


def test_port_imports_no_jax():
    code = ("import sys; import gear_tpu_torch, gear_tpu_torch.api, "
            "gear_tpu_torch.convert, gear_tpu_torch.kernels.decode, "
            "gear_tpu_torch.kernels.pack, gear_tpu_torch.models.loader, "
            "gear_tpu_torch.paged, gear_tpu_torch.serving, "
            "gear_tpu_torch.h2o, gear_tpu_torch.sink, gear_tpu_torch.metrics, "
            "gear_tpu_torch.eval.harness, gear_tpu_torch.eval.synth, "
            "gear_tpu_torch.eval.run, gear_tpu_torch.tools.acc_run, "
            "gear_tpu_torch.models.mixtral, gear_tpu_torch.runtime.kvstore, "
            "gear_tpu_torch.runtime.faults, gear_tpu_torch.parallel, "
            "gear_tpu_torch.parallel.distributed, "
            "gear_tpu_torch.parallel.sharding, "
            "gear_tpu_torch.parallel.context, gear_tpu_torch.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'gear_tpu')]; "
            "assert not bad, bad; print('ok')")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_silent_cpu(tiny, monkeypatch):
    _, tcfg, _, tparams = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp = TComp(**_comp(tcfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tcfg, tparams, comp, TEngineConfig(max_len=64), batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GearLM(cfg=tcfg, params=tparams, comp=comp).engine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.init_params(tcfg)
    # every mode is ported; a mode the reference lacks is refused
    with pytest.raises(ValueError, match="unknown engine mode"):
        TEngine(tcfg, tparams, comp, TEngineConfig(max_len=64, mode="h3o"),
                batch_size=2, device="cpu")


def test_shard_seq_entry_point_refusals(tiny):
    """shard_seq takes fused mode, shards of whole groups, and no sliding
    window that could bind (the sharded attention has none; gear_tpu's
    ignores the window there)."""
    _, tcfg, _, tparams = tiny
    comp = TComp(**_comp(tcfg))

    class Seq:  # a mesh's seq axis, without the processes
        def __init__(self, n):
            self.n = n

        def axis_size(self, axis):
            return self.n

    def eng(mode="fused", cfg=tcfg):
        return TEngine(cfg, tparams, comp, TEngineConfig(max_len=64,
                                                         mode=mode),
                       batch_size=2, device="cpu")
    assert eng().shard_seq(Seq(4)).seq_axis == "seq"
    with pytest.raises(ValueError, match="requires mode='fused'"):
        eng("raw").shard_seq(Seq(2))
    with pytest.raises(ValueError, match="whole groups"):
        eng().shard_seq(Seq(3))
    windowed = dataclasses.replace(tcfg, sliding_window=32)
    with pytest.raises(ValueError, match="sliding_window 32 < max_len 64"):
        eng(cfg=windowed).shard_seq(Seq(2))
    wide = dataclasses.replace(tcfg, sliding_window=64)
    assert eng(cfg=wide).shard_seq(Seq(2)).seq_mesh is not None


def _write_safetensors(path, tensors: dict):
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        raw = arr.tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + b"".join(blobs))


def test_loader_matches_reference(tmp_path):
    hf = dict(vocab_size=32, hidden_size=16, intermediate_size=32,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    rng = np.random.default_rng(1)
    shapes = {"model.embed_tokens.weight": (32, 16), "model.norm.weight": (16,),
              "lm_head.weight": (32, 16)}
    for i in range(2):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (16,),
            p + "post_attention_layernorm.weight": (16,),
            p + "self_attn.q_proj.weight": (16, 16),
            p + "self_attn.k_proj.weight": (8, 16),
            p + "self_attn.v_proj.weight": (8, 16),
            p + "self_attn.o_proj.weight": (16, 16),
            p + "mlp.gate_proj.weight": (32, 16),
            p + "mlp.up_proj.weight": (32, 16),
            p + "mlp.down_proj.weight": (16, 32)})
    _write_safetensors(tmp_path / "model.safetensors",
                       {k: rng.standard_normal(s).astype(np.float32)
                        for k, s in shapes.items()})
    jcfg, jparams = jloader.load_params(tmp_path, dtype=jnp.float32)
    tcfg, tparams = tloader.load_params(tmp_path, dtype=torch.float32,
                                        device="cpu")
    assert tcfg.num_kv_heads == jcfg.num_kv_heads == 1
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in jflat:
        t = tparams
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    lm = GearLM.from_pretrained(
        tmp_path, TComp(num_layers=2, compress_method="GEARL", group_size=16),
        max_len=64, dtype=torch.float32, device="cpu")
    out = lm.generate([1, 2, 3], 5)
    assert len(out) == 5 and all(0 <= t < 32 for t in out)
