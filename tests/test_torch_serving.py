"""Parity of the port's serving engines (gear_tpu_torch.serving) and of
``forward_decode_paged`` with gear_tpu on a tiny float32 Llama (CPU).

The scenarios are those of tests/test_serving_paged.py. The port is handed
the JAX side's power-iteration inits along its key chain: ``PRNGKey(rid)``
split per layer for an admission prefill; for a flush ``PRNGKey(7)`` split
per slot, then per layer, folded with the slot's comp_len. So greedy tokens
are identical to the JAX engines', and the port's paged engine emits what
its dense twin emits. The pool-pressure scenarios (preemption, waiting for
pages) are in tests/test_torch_serving_pool.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.models import llama as jllama
from gear_tpu.serving import PagedServingEngine as JPaged
from gear_tpu.serving import ServingEngine as JDense
from gear_tpu_torch import convert
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.serving import PagedServingEngine as TPaged
from gear_tpu_torch.serving import ServingEngine as TDense
from test_torch_model import _flush_key, _uniform

COMP = dict(compress_method="GEARL", quantize_bit=8, group_size=16, rank=2,
            prefill_rank=2, loop=2)


def tiny_models():
    jcfg = jllama.ModelConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def serving_inits(n_slots: int, num_layers: int):
    """init(site, shape) replaying gear_tpu.serving's key chains."""
    slot_keys = jax.random.split(jax.random.PRNGKey(7), n_slots)

    def init(site, shape):
        if site[0] == "serve_prefill":
            _, rid, layer, which = site
            kk, kv = jax.random.split(
                jax.random.split(jax.random.PRNGKey(rid), num_layers)[layer])
            return _uniform(kk if which == "k" else kv, shape)
        _, slot, layer, which, comp_len = site
        lkey = jax.random.split(slot_keys[slot], num_layers)[layer]
        return _uniform(_flush_key(lkey, comp_len, which), shape)
    return init


def run_engine(cls, cfg, params, comp_cls, requests, *, n_slots=2, **kw):
    """Submit ``requests`` [(prompt, max_new)] and run -> (outputs in
    submission order, the engine)."""
    comp = comp_cls(num_layers=cfg.num_layers, **COMP)
    if cls in (TPaged, TDense):
        kw.update(device="cpu",
                  init=serving_inits(n_slots, cfg.num_layers))
    eng = cls(cfg, params, comp, n_slots=n_slots, **kw)
    rids = [eng.submit(p, n) for p, n in requests]
    outs = eng.run()
    assert set(outs) == set(rids)
    return [outs[r] for r in rids], eng


SCENARIOS = {
    # name: (requests, paged engine kwargs)
    "three_requests_two_slots": (
        [([1, 2, 3], 6), ([4, 5], 4), ([7, 8, 9, 10], 5)],
        dict(max_len=128, n_pages=16, page_blocks=2)),
    "flush_into_pages": (
        [([1, 2, 3, 4, 5], 24), ([9, 8, 7], 24)],
        dict(max_len=128, n_pages=16, page_blocks=1)),
    "staggered_finishes": (
        [([1, 2, 3, 4, 5], 48), ([9, 8, 7], 4)],
        dict(max_len=128, n_pages=16, page_blocks=1)),
}


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


@pytest.fixture(scope="module")
def reference_runs(tiny):
    """Each JAX engine runs once per scenario (they compile slowly)."""
    jcfg, _, jparams, _ = tiny
    runs = {}
    for name, (requests, kw) in SCENARIOS.items():
        runs[name, "paged"] = run_engine(JPaged, jcfg, jparams, JComp,
                                         requests, **kw)[0]
    # the dense twin where the reference's own tests hold paged against it
    # on a flush (the staggered case differs from it only in max_new)
    requests, kw = SCENARIOS["flush_into_pages"]
    runs["flush_into_pages", "dense"] = run_engine(
        JDense, jcfg, jparams, JComp, requests, max_len=kw["max_len"])[0]
    return runs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_serving_tokens_match_reference(tiny, reference_runs, name):
    _, tcfg, _, tparams = tiny
    requests, kw = SCENARIOS[name]
    got, eng = run_engine(TPaged, tcfg, tparams, TComp, requests, **kw)
    assert [len(o) for o in got] == [n for _, n in requests]
    assert got == reference_runs[name, "paged"]
    assert eng.alloc.free_count() == kw["n_pages"]  # every page came back
    assert (eng.seqs.host_table == -1).all()
    assert eng.seqs.host_lens.tolist() == [[0, 1, 0]] * 2   # all parked
    np.testing.assert_array_equal(eng.seqs.lens.numpy(), eng.seqs.host_lens)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dense_serving_tokens_match_paged_and_reference(tiny, reference_runs,
                                                        name):
    _, tcfg, _, tparams = tiny
    requests, kw = SCENARIOS[name]
    dense, _ = run_engine(TDense, tcfg, tparams, TComp, requests,
                          max_len=kw["max_len"])
    paged, _ = run_engine(TPaged, tcfg, tparams, TComp, requests, **kw)
    assert dense == paged
    assert dense == reference_runs.get((name, "dense"), dense)
    assert dense == reference_runs[name, "paged"]


def test_serving_engines_refuse_silent_cpu(tiny, monkeypatch):
    _, tcfg, _, tparams = tiny
    comp = TComp(num_layers=tcfg.num_layers, **COMP)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TPaged, TDense):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(tcfg, tparams, comp, n_slots=2, max_len=64)


def test_eos_finishes_a_request_early(tiny):
    _, tcfg, _, tparams = tiny
    requests = [([1, 2, 3, 4, 5], 12)]
    plain, _ = run_engine(TPaged, tcfg, tparams, TComp, requests,
                          max_len=64, n_pages=8, page_blocks=1)
    eos = plain[0][3]
    stop = plain[0].index(eos) + 1
    for cls, kw in ((TPaged, dict(n_pages=8, page_blocks=1)), (TDense, {})):
        got, _ = run_engine(cls, tcfg, tparams, TComp, requests, max_len=64,
                            eos_token_id=eos, **kw)
        assert got[0] == plain[0][:stop]
