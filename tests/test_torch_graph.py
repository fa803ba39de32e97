"""The pieces of the port's CUDA-graph decode step that run on the CPU: the
appends at a device index, the window folded from device memory, the
engine's rule for which steps a graph replays, its host lengths after a
step that read them from device memory, and the benchmark's reader of the
share of replayed steps. The capture and the replay themselves run on the
card (``tests/test_torch_cuda.py``)."""
import dataclasses

import pytest
import torch

from gear_tpu_torch import cache as TC
from gear_tpu_torch import kernels, profiling
from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine, _StepGraph
from gear_tpu_torch.kernels import decode as TK
from gear_tpu_torch.models import llama, mistral
from portbench import harness

GROUP = 16
BUCKET = 32


def clone(cache):
    """A copy of a cache object: its tensors cloned, its lengths kept."""
    return dataclasses.replace(cache, **{
        k: v.clone() for k, v in vars(cache).items() if torch.is_tensor(v)})


def same(a, b) -> bool:
    return all(torch.equal(v, getattr(b, k)) if torch.is_tensor(v)
               else v == getattr(b, k) for k, v in vars(a).items())


def index(n: int) -> torch.Tensor:
    return torch.tensor([n], dtype=torch.int64)


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_device_index_append_equals_the_slice_append(mode):
    """40 steps over a cache of 32 prompt tokens, group 16: the device-index
    append leaves every tensor bit-identical to the slice append, with the
    flush steps (where the residual tier fills) taking the slice append on
    both sides."""
    gen = torch.Generator().manual_seed(5)
    spec = TC.CacheSpec(batch=2, num_kv_heads=2, head_dim=16, max_len=96,
                        group=GROUP, outliers_per_block=8)
    k = torch.randn((2, 2, BUCKET, 16), generator=gen).bfloat16()
    v = torch.randn((2, 2, BUCKET, 16), generator=gen).bfloat16()
    if mode == "fused":
        ref = TC.prefill(spec, k, v,
                         generator=torch.Generator().manual_seed(0))
    else:
        ref = llama.raw_prefill(spec, k, v)
    got = clone(ref)
    flushes = 0
    for j in range(40):
        kn = torch.randn((2, 2, 1, 16), generator=gen).bfloat16()
        vn = (kn * 0.5).bfloat16()
        if mode == "raw":
            llama.raw_append(spec, ref, kn, vn)
            llama.raw_append_at(got, kn, vn, index(got.length))
            got.length += 1
        elif got.resid_len + 1 < spec.group:
            TC.append(spec, ref, kn, vn)
            TC.append_at(got, kn, vn, index(got.resid_len))
            got.resid_len += 1
        else:
            flushes += 1
            for c in (ref, got):
                TC.append(spec, c, kn, vn,
                          generator=torch.Generator().manual_seed(j))
        assert same(got, ref), j
    assert flushes == (2 if mode == "fused" else 0)


@pytest.mark.parametrize("pad", [None, [0, 70]], ids=["no_pad", "pad"])
@pytest.mark.parametrize("total", [10, 99, 100, 101, 170, 222])
def test_device_window_fold_equals_fold_window(pad, total):
    """``max(pad_start, total - window)`` from device memory, for totals on
    both sides of a window of 100, as ``fold_window`` folds it from the
    host's total."""
    window = 100
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32)
    lo = torch.tensor([total - window], dtype=torch.int32)
    got = TK.fold_window_at(pad_t, lo, 2, "cpu")
    want = TK.fold_window(pad_t, window, total, 2, "cpu")
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(TK.fold_window_at(pad_t, None, 2, "cpu"),
                       TK.fold_window(pad_t, None, total, 2, "cpu"))


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
            n, lg = eng._static_step(g, caches)
            eng._advance(caches)
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
