"""The port's paged serving engine under pool pressure (preemption, waiting
for pages) and ``forward_decode_paged`` step by step, against gear_tpu on a
tiny float32 Llama (CPU). Scenarios of tests/test_serving_paged.py; helpers
and key chains in tests/test_torch_serving.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu.config import CompressionConfig as JComp
from gear_tpu.models import llama as jllama
from gear_tpu.serving import PagedServingEngine as JPaged
from gear_tpu_torch.config import CompressionConfig as TComp
from gear_tpu_torch.models import llama as tllama
from gear_tpu_torch.serving import PagedServingEngine as TPaged
from test_torch_serving import COMP, run_engine, serving_inits, tiny_models

PROMPT = list(range(1, 33))
SCENARIOS = {
    # two 32-token prompts take 2 of the 6 pages each; both slots then
    # generate 40 tokens (3 flushes each), so a decode-time allocation
    # cannot be met for both and one slot is preempted
    "preemption": ([(PROMPT, 40), ([x + 50 for x in PROMPT], 40)],
                   dict(max_len=128, n_pages=6, page_blocks=1)),
    # each 48-token prompt needs 3 of the 4 pages: the second request waits
    "waits_for_pages": ([(list(range(1, 49)), 3)] * 2,
                        dict(max_len=64, n_pages=4, page_blocks=1)),
}


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_serving_under_pool_pressure_matches_reference(tiny, name,
                                                             monkeypatch):
    jcfg, tcfg, jparams, tparams = tiny
    requests, kw = SCENARIOS[name]
    events = []
    for method in ("_preempt", "_park_slot"):
        orig = getattr(TPaged, method)
        monkeypatch.setattr(
            TPaged, method,
            lambda self, slot, orig=orig, method=method:
            (events.append(method), orig(self, slot))[1])
    want, _ = run_engine(JPaged, jcfg, jparams, JComp, requests, **kw)
    got, eng = run_engine(TPaged, tcfg, tparams, TComp, requests, **kw)
    assert [len(o) for o in got] == [n for _, n in requests]
    assert got == want
    assert eng.alloc.free_count() == kw["n_pages"]
    assert ("_preempt" in events) == (name == "preemption")


def test_forward_decode_paged_logits_match_reference(tiny):
    """Both packages' engines admit the same two requests; then 20 decode
    steps (admission buckets a prompt to whole blocks, so each slot flushes
    at step 16, into a fresh page) through the two
    ``forward_decode_paged``, fed the same tokens."""
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(n_slots=2, max_len=128, n_pages=16, page_blocks=1)
    jeng = JPaged(jcfg, jparams, JComp(num_layers=2, **COMP), **kw)
    teng = TPaged(tcfg, tparams, TComp(num_layers=2, **COMP), device="cpu",
                  init=serving_inits(2, 2), **kw)
    for eng in (jeng, teng):
        eng.submit(list(range(1, 24)), 40)   # left-padded to 32 tokens
        eng.submit([9, 8, 7], 40)            # to 16
        eng._admit_all()
    np.testing.assert_array_equal(teng.cur_tok.numpy(),
                                  np.asarray(jeng.cur_tok))
    jstep = jax.jit(functools.partial(
        jllama.forward_decode_paged, cfg=jcfg, pspec=jeng.pspec))
    g = jeng.spec.group
    for _ in range(20):
        jeng._prealloc_pages()
        teng._prealloc_pages()
        jlogits, jeng.pools, jeng.seqs = jstep(
            jparams, token=jeng.cur_tok, position=jeng.positions,
            pools=jeng.pools, seqs=jeng.seqs, pad_start=jeng.pad_start,
            prng=jax.random.PRNGKey(7), live=jnp.asarray(jeng.live))
        tlogits, _, _ = tllama.forward_decode_paged(
            tparams, tcfg, teng.cur_tok, teng.positions, teng.pools,
            teng.seqs, pspec=teng.pspec, pad_start=teng.pad_start,
            init=teng.init, live=teng.live)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        nxt = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        jeng.cur_tok, jeng.positions = nxt, jeng.positions + 1
        teng.cur_tok = torch.from_numpy(np.array(nxt)).long()
        teng.positions += 1
        for slot in range(2):  # the JAX engine's host mirrors
            if jeng._host_resid[slot] + 1 == g:
                jeng._host_comp[slot] += g
                jeng._host_resid[slot] = 0
            else:
                jeng._host_resid[slot] += 1
    assert teng.seqs.host_lens.tolist() == [[48, 4, 32], [32, 4, 16]]
    np.testing.assert_array_equal(teng.seqs.lens.numpy()[:, 0],
                                  np.asarray(jeng.seqs.comp_len))
    np.testing.assert_array_equal(teng.seqs.block_table.numpy(),
                                  np.asarray(jeng.seqs.block_table))
    np.testing.assert_array_equal(teng.pools.v_codes.numpy(),
                                  np.asarray(jeng.pools.v_codes))


def test_forward_decode_paged_passes_the_window_through(tiny):
    """A sliding-window config runs through the same function: the last
    ``window`` tokens only, per slot."""
    _, _, _, tparams = tiny
    cfg = tllama.ModelConfig.tiny(dtype=torch.float32, sliding_window=16)
    comp = TComp(num_layers=2, **COMP)
    outs = {}
    for win in (16, None):
        wcfg = cfg if win else tllama.ModelConfig.tiny(dtype=torch.float32)
        eng = TPaged(wcfg, tparams, comp, n_slots=2, max_len=64, n_pages=8,
                     page_blocks=1, device="cpu")
        rid = eng.submit(list(range(1, 40)), 6)
        outs[win] = eng.run()[rid]
    assert len(outs[16]) == 6 and outs[16] != outs[None]
    with pytest.raises(ValueError, match="sliding_window"):
        TPaged(tllama.ModelConfig.tiny(dtype=torch.float32, sliding_window=8),
               tparams, comp, n_slots=2, max_len=64, device="cpu")
