"""The pieces of the port's decode step that run on the CPU: the one
append, at the slot a step's staged lengths name, the window folded from
device memory, the engine's rule for which steps a graph replays, its step
over a graph's static buffers and its host lengths after it, and the
benchmark's reader of the share of replayed steps. The capture and the
replay themselves run on the card (``tests/test_torch_cuda.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gear_tpu import cache as C
from gear_tpu.models import llama as jllama
from gear_tpu_torch import cache as TC
from gear_tpu_torch import convert, kernels, profiling
from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine, _StepGraph
from gear_tpu_torch.kernels import decode as TK
from gear_tpu_torch.models import llama, mistral
from portbench import harness
from test_torch_cache import _append_p0, _fields

GROUP = 16
BUCKET = 32


def clone(cache):
    """A copy of a cache object: its tensors cloned, its lengths kept."""
    return dataclasses.replace(cache, **{
        k: v.clone() for k, v in vars(cache).items() if torch.is_tensor(v)})


def same(a, b) -> bool:
    return all(torch.equal(v, getattr(b, k)) if torch.is_tensor(v)
               else v == getattr(b, k) for k, v in vars(a).items())


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_device_index_append_equals_the_slice_append(mode):
    """40 steps over a cache of 32 prompt tokens, group 16, carried over
    from gear_tpu's prefill (``convert``): the one append, writing at the
    slot that each step's staged lengths name and flushing where the tier
    fills (twice in fused mode), leaves every tensor and length bit for bit
    as gear_tpu's ``cache.append`` / ``raw_append`` (dynamic-slice writes)
    leave them, and the staged lengths are the host lengths after it. The
    flushes quantize and pack without error bases: their power iterations
    part in the last float32 bits (``test_torch_cache`` holds them)."""
    rng = np.random.default_rng(5)
    kw = dict(batch=2, num_kv_heads=2, head_dim=16, max_len=96, group=GROUP)
    jspec = C.CacheSpec(**kw, dtype=jnp.float32, sideband_dtype=jnp.float32)
    spec = TC.CacheSpec(**kw, dtype=torch.float32,
                        sideband_dtype=torch.float32)
    k = rng.standard_normal((2, 2, BUCKET, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, BUCKET, 16)).astype(np.float32)
    if mode == "fused":
        jc = jax.jit(functools.partial(C.prefill, jspec))(
            jnp.asarray(k), jnp.asarray(v), key=jax.random.PRNGKey(0))
        got = convert.cache_from_numpy(_fields(jc))
        japp = jax.jit(functools.partial(C.append, jspec),
                       static_argnames="use_lowrank")
    else:
        jc = jllama.raw_prefill(jspec, jnp.asarray(k), jnp.asarray(v))
        got = llama.raw_prefill(spec, torch.from_numpy(k),
                                torch.from_numpy(v))
    flushes = 0
    for j in range(40):
        kn = rng.standard_normal((2, 2, 1, 16)).astype(np.float32)
        vn = (kn * 0.5).astype(np.float32)
        tk, tv = torch.from_numpy(kn), torch.from_numpy(vn)
        lens = TC.StepLens.stage(spec, got, None)
        if mode == "raw":
            jc = jllama.raw_append(jspec, jc, jnp.asarray(kn),
                                   jnp.asarray(vn))
            llama.raw_append(spec, got, tk, tv, index=lens.index)
            assert lens.lens.tolist() == [got.length, 0, 0], j
            want = {"k": np.asarray(jc.k), "v": np.asarray(jc.v)}
            assert got.length == int(jc.length), j
            for f, a in want.items():
                np.testing.assert_array_equal(getattr(got, f).numpy(), a,
                                              err_msg=f"{f} {j}")
            continue
        key = jax.random.PRNGKey(100 + j)
        flushes += got.resid_len + 1 == GROUP
        p0 = _append_p0(key, got.comp_len)
        jc = japp(jc, jnp.asarray(kn), jnp.asarray(vn), key=key,
                  use_lowrank=False)
        TC.append(spec, got, tk, tv, p0=p0, use_lowrank=False,
                  index=lens.index)
        assert lens.lens.tolist() == [got.comp_len, got.resid_len,
                                      got.prefill_len], j
        want = _fields(jc)
        for f, a in convert.cache_to_numpy(got).items():
            np.testing.assert_array_equal(a, want[f], err_msg=f"{f} {j}")
    assert flushes == (2 if mode == "fused" else 0)


@pytest.mark.parametrize("pad", [None, [0, 70]], ids=["no_pad", "pad"])
@pytest.mark.parametrize("total", [10, 99, 100, 101, 170, 222])
def test_device_window_fold_equals_fold_window(pad, total):
    """``fold_window`` raises ``pad_start`` to the window's first position
    as a step over a raw cache of ``total - 1`` tokens stages it in device
    memory: ``max(pad_start, total - window)`` for totals on both sides of
    a window of 100, and ``pad_start`` itself without a window."""
    window = 100
    spec = TC.CacheSpec(batch=2, num_kv_heads=1, head_dim=8, max_len=256,
                        group=GROUP)
    c = llama.raw_init(spec)
    c.length = total - 1
    lens = TC.StepLens.stage(spec, c, window)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    base = pad or [0, 0]
    got = TK.fold_window(pad_t, lens.window_lo, 2, "cpu")
    want = torch.tensor([max(p, total - window) for p in base],
                        dtype=torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(TK.fold_window(pad_t, None, 2, "cpu"),
                       torch.tensor(base, dtype=torch.int32))


def engine(mode="fused", *, window=48, temperature=0.0, max_len=96):
    cfg = mistral.tiny(sliding_window=window)
    params = llama.init_params(cfg, seed=0, device="cpu")
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=GROUP, rank=2, prefill_rank=2,
                             loop=2, left=0.05)
    return InferenceEngine(cfg, params, comp,
                           EngineConfig(max_len=max_len, mode=mode,
                                        temperature=temperature),
                           batch_size=2, device="cpu")


def prompt_pass(eng):
    tokens, mask = eng.left_pad([list(range(1, 19)), [6, 7, 8]], 0, BUCKET)
    logits, caches = eng.prefill(tokens, mask)
    prompt_len = mask.sum(1).to(torch.int32)
    return (logits[:, -1].argmax(-1), caches, prompt_len,
            (BUCKET - prompt_len).to(torch.int32))


@pytest.mark.parametrize("case,want", [
    ("eligible_fused", None), ("eligible_raw", None), ("cpu", "device"),
    ("sharded", "mesh"), ("seq_sharded", "mesh"), ("sampled", "sampling"),
    ("simulated", "mode"), ("h2o", "mode"), ("sink", "mode"),
    ("flush", "flush"), ("raw_full", "full")])
def test_the_engine_picks_eager_steps_by_what_it_observes(case, want):
    """The rule a decode step's kind follows, each fact alone: the engine
    is told it runs on the card (no operation runs), then one fact of the
    case is set."""
    mode = {"eligible_raw": "raw", "raw_full": "raw", "simulated":
            "simulated", "h2o": "h2o", "sink": "sink"}.get(case, "fused")
    eng = engine(mode, temperature=0.7 if case == "sampled" else 0.0)
    caches = (llama.raw_init(eng.spec) if mode in ("raw", "simulated")
              else TC.init_layer_cache(eng.spec))
    if case != "cpu":
        eng.device = torch.device("cuda")
    if case == "sharded":
        eng.mesh = object()
    elif case == "seq_sharded":
        eng.seq_mesh = object()
    elif case == "flush":
        caches.resid_len = GROUP - 1
    elif case == "raw_full":
        caches.length = eng.spec.max_len
    assert eng._eager_because(caches) == want
    if case == "flush":   # the step before it can be replayed
        caches.resid_len = GROUP - 2
        assert eng._eager_because(caches) is None


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_a_device_length_step_leaves_what_an_eager_step_leaves(mode):
    """50 greedy steps (flushes at every 16th in fused mode) with the
    window binding from step 16: where a graph would replay the step, the
    engine's own step over its static buffers, with the lengths in them,
    and its host bookkeeping after it; elsewhere the eager step. Tokens,
    logits, cache tensors and host lengths equal the eager steps' at every
    step."""
    eng = engine(mode)
    cur, caches, prompt_len, pad = prompt_pass(eng)
    ref, cur_ref = clone(caches), cur.clone()
    g = _StepGraph(None, cur, prompt_len, pad, torch.device("cpu"))
    static = 0
    for j in range(50):
        pos = prompt_len + j
        nr, lr, ref = eng.decode_step(ref, cur_ref, pos, pad, step=j,
                                      generator=torch.Generator()
                                      .manual_seed(j))
        flush = mode == "fused" and caches.resid_len + 1 == GROUP
        if flush:
            n, lg, caches = eng.decode_step(caches, cur, pos, pad, step=j,
                                            generator=torch.Generator()
                                            .manual_seed(j))
        else:
            static += 1
            eng._load(g, caches, cur, pos, pad)
            n, lg, _ = eng._step(caches, g.token, g.position, g.pad_start,
                                 lens=g.lens)
            TC.advance(eng.spec, caches)
        assert torch.equal(n, nr) and torch.equal(lg, lr), j
        assert same(caches, ref), j
        cur, cur_ref = n, nr
    assert static == (47 if mode == "fused" else 50)
    assert eng.graph_captures == eng.graph_replays == 0


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_the_engine_counts_eager_steps_on_the_cpu(mode):
    eng = engine(mode)
    out = eng.generate([list(range(1, 19)), [6, 7, 8]], 20)
    assert [len(o) for o in out] == [20, 20]
    assert (eng.eager_steps, eng.graph_captures, eng.graph_replays) == \
        (19, 0, 0)
    assert eng._graph is None


def test_adding_launch_counts():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"decode_attention": 64, "flash_decode": 2})
    kernels.add_launch_counts({"decode_attention": -4})
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 60 and counts["flash_decode"] == 2
    assert sum(counts.values()) == 62
    kernels.reset_launch_counts()


def graph_share():
    return harness.load_module(
        harness.BENCH_DIR / "metrics" / "decode.graph_share.py",
        "portbench_metric_decode_graph_share")


@pytest.mark.parametrize("kinds,want", [
    (["replay"] * 3, 100.0), (["replay", "eager", "capture"], 100 / 3),
    (["eager"] * 3, 0.0), ([None] * 3, None), (["replay", None, "replay"],
                                               None)])
def test_the_graph_share_reader(monkeypatch, kinds, want):
    """The roots of steps 6-9, each over a layer: 6 a pad step (not
    counted), and an earlier root of step 7, without ``graph``, that the
    later one replaces. The share of the counted steps 7-9 whose root says
    ``replay``; None where one has no ``graph``, or none is counted."""
    recs = []
    for j, kind in [(6, "eager"), (7, None)] + list(zip((7, 8, 9), kinds)):
        r = len(recs)
        attrs = {"step": j, "batch": 2}
        if kind is not None:
            attrs["graph"] = kind
        recs.append(profiling.Span("engine.decode_step", 100 * r,
                                   100 * r + 50, None, r, 1, attrs))
        recs.append(profiling.Span("llama.layer", 100 * r + 10, 100 * r + 20,
                                   r, r, 1, {"layer": 0}))
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    got = graph_share().read({"steps": [7, 8, 9]})
    assert got == (None if want is None else pytest.approx(want))
    assert graph_share().read({"steps": []}) is None
    assert graph_share().read({"steps": [2]}) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert graph_share().read({"steps": [7, 8, 9]}) is None
