"""The port's spans (``gear_tpu_torch.profiling.span``) on the CPU: off
without a profiler, the tree of a decode step and of a flush, the clock the
profiler shares, nothing on the profiler's own timeline, a span closed by an
exception, the spans in ``profiling.trace``'s file, and self times."""
import contextlib
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gear_tpu_torch import cache as TC
from gear_tpu_torch import kernels, profiling
from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine
from gear_tpu_torch.kernels import flush as TFL
from gear_tpu_torch.models import llama, mistral

NAMES = {"engine.decode_step", "engine.prefill", "llama.layer",
         "cache.append", "cache.flush", "llama.raw_append",
         "decode.attend_fused", "flash.raw_attend_flash"}
CHILDREN = {"fused": ("cache.append", "decode.attend_fused"),
            "raw": ("llama.raw_append", "flash.raw_attend_flash")}
GROUP = 16
BUCKET = 16


@pytest.fixture(autouse=True)
def no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def engine(mode):
    cfg = mistral.tiny()
    params = llama.init_params(cfg, seed=0, device="cpu")
    comp = CompressionConfig(num_layers=cfg.num_layers,
                             compress_method="GEAR", quantize_bit=4,
                             group_size=GROUP, rank=2, prefill_rank=2,
                             loop=2)
    return InferenceEngine(cfg, params, comp,
                           EngineConfig(max_len=64, mode=mode),
                           batch_size=2, device="cpu")


class Decoder:
    """A tiny Mistral engine after its prompt pass, stepped greedily."""

    def __init__(self, mode):
        self.eng = engine(mode)
        tokens, mask = self.eng.left_pad([[1, 2, 3, 4, 5], [6, 7, 8]], 0,
                                         BUCKET)
        logits, self.caches = self.eng.prefill(tokens, mask)
        self.cur = logits[:, -1].argmax(-1)
        self.prompt_len = mask.sum(1).to(torch.int32)
        self.pad_start = (BUCKET - self.prompt_len).to(torch.int32)
        self.j = 0

    def step(self):
        self.cur, _, self.caches = self.eng.decode_step(
            self.caches, self.cur, self.prompt_len + self.j, self.pad_start,
            step=self.j)
        self.j += 1


def children(recs, i):
    return [k for k, r in enumerate(recs) if r.parent == i]


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_without_a_profiler_a_span_is_the_shared_noop(mode):
    dec = Decoder(mode)
    dec.step()
    a, b = profiling.span("x", step=1), profiling.span("y")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a as got:
        assert got is None
    assert profiling.spans() == []


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_a_decode_step_is_one_root_over_its_layers(mode):
    dec = Decoder(mode)
    dec.step()
    with cpu_profile():
        dec.step()
    recs = profiling.spans()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert len(roots) == 1
    root = recs[roots[0]]
    assert root.name == "engine.decode_step"
    assert root.attrs == {"step": 1, "batch": 2, "graph": "eager"}
    assert all(r.root == roots[0] and r.t1 is not None and r.error is None
               for r in recs)
    layers = children(recs, roots[0])
    layers_n = dec.eng.cfg.num_layers
    assert [recs[i].name for i in layers] == ["llama.layer"] * layers_n
    assert [recs[i].attrs["layer"] for i in layers] == list(range(layers_n))
    for i in layers:
        kids = children(recs, i)
        assert tuple(recs[k].name for k in kids) == CHILDREN[mode]
        assert all(children(recs, k) == [] for k in kids)
        assert root.t0 <= recs[i].t0 <= recs[i].t1 <= root.t1


def test_a_step_that_fills_the_residual_tier_flushes_under_each_append():
    """On the CPU each layer's flush takes the plain route: its span says
    so, and the flush kernel's wrapper launches nothing."""
    dec = Decoder("fused")
    for _ in range(GROUP - 1):
        dec.step()
    kernels.reset_launch_counts()
    with cpu_profile():
        dec.step()
    assert kernels.launch_counts()["flush"] == 0
    recs = profiling.spans()
    appends = [i for i, r in enumerate(recs) if r.name == "cache.append"]
    assert len(appends) == dec.eng.cfg.num_layers
    for i in appends:
        assert recs[i].attrs == {"resid_len": GROUP - 1}
        assert recs[recs[i].parent].name == "llama.layer"
        kids = children(recs, i)
        assert [recs[k].name for k in kids] == ["cache.flush"]
        assert recs[kids[0]].attrs == {"comp_len": BUCKET, "route": "plain"}
    flushes = [r for r in recs if r.name == "cache.flush"]
    assert len(flushes) == dec.eng.cfg.num_layers
    assert dec.caches.comp_len == BUCKET + GROUP


@pytest.mark.parametrize("device,route", [("cpu", "plain"),
                                          ("cuda", "kernel"), ("meta", None)])
def test_one_test_of_the_device_picks_the_flush_route(device, route):
    """``cache._flush`` dispatches on, and labels its span with, what
    ``kernels.flush.route`` returns; a device with neither version raises."""
    if route is None:
        with pytest.raises(ValueError):
            TFL.route(torch.device(device))
    else:
        assert TFL.route(torch.device(device)) == route


def test_the_flush_kernel_wrapper_refuses_a_cache_off_the_card():
    spec = TC.CacheSpec(batch=1, num_kv_heads=1, head_dim=32, max_len=64,
                        group=16, dtype=torch.bfloat16,
                        sideband_dtype=torch.bfloat16)
    cache = TC.init_layer_cache(spec)
    n = TFL.flush.launches
    with pytest.raises(ValueError):
        TFL.flush(spec, cache)
    assert TFL.flush.launches == n


def test_a_prompt_pass_is_one_root_over_its_layers():
    eng = engine("fused")
    tokens, mask = eng.left_pad([[1, 2, 3], [4, 5]], 0, BUCKET)
    with cpu_profile():
        eng.prefill(tokens, mask)
    recs = profiling.spans()
    assert recs[0].name == "engine.prefill" and recs[0].parent is None
    assert recs[0].attrs == {"batch": 2, "bucket": BUCKET}
    assert [recs[i].name for i in children(recs, 0)] == \
        ["llama.layer"] * eng.cfg.num_layers


@pytest.mark.parametrize("nested", [False, True], ids=["root", "nested"])
def test_spans_and_the_profilers_events_share_a_clock(nested):
    x = torch.ones(4096)
    with cpu_profile() as prof:
        x.mul(2)
        time.sleep(0.005)
        with profiling.span("outer"):
            with profiling.span("inner") if nested else \
                    contextlib.nullcontext():
                x.add(1)
        time.sleep(0.005)
        x.sub(1)
    rec = profiling.spans()[-1]
    assert rec.name == ("inner" if nested else "outer")
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    slack = 1_000_000   # ns
    add, mul, sub = ev["aten::add"], ev["aten::mul"], ev["aten::sub"]
    assert rec.t0 - slack <= add.start_ns() <= add.end_ns() <= rec.t1 + slack
    assert mul.end_ns() < rec.t0 and rec.t1 < sub.start_ns()


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_no_span_reaches_the_profilers_timeline(mode):
    with cpu_profile() as prof:
        dec = Decoder(mode)
        for _ in range(GROUP):
            dec.step()
    recorded = {r.name for r in profiling.spans()}
    want = {"engine.prefill", "engine.decode_step", "llama.layer",
            *CHILDREN[mode]} | ({"cache.flush"} if mode == "fused" else set())
    assert recorded == want and recorded <= NAMES
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not events & NAMES
    assert not {e.key for e in prof.key_averages()} & NAMES


def test_a_span_whose_body_raises_is_closed():
    with cpu_profile():
        with pytest.raises(KeyError):
            with profiling.span("outer"):
                with profiling.span("inner", at=3):
                    raise KeyError("x")
        with profiling.span("after"):
            pass
    outer, inner, after = profiling.spans()
    assert inner.t1 is not None and inner.error == "KeyError"
    assert outer.t1 is not None and outer.error == "KeyError"
    assert inner.attrs == {"at": 3} and inner.parent == 0
    assert after.parent is None and after.root == 2 and after.error is None


def test_threads_keep_their_own_stacks():
    go = threading.Barrier(2, timeout=10)

    def work():
        with profiling.span("a"):
            go.wait()
            with profiling.span("b"):
                go.wait()

    with cpu_profile():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.spans()
    assert sorted(r.name for r in recs) == ["a", "a", "b", "b"]
    for r in recs:
        if r.name == "b":
            parent = recs[r.parent]
            assert parent.name == "a" and parent.thread == r.thread
            assert r.root == r.parent


def test_trace_writes_the_spans_on_the_files_timebase(tmp_path):
    with profiling.span("before"):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("work", n=7):
            torch.ones(4096).add(1)
    assert [r.name for r in profiling.spans()] == ["work"]
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    pid = [e["pid"] for e in events if e.get("ph") == "M"
           and e.get("name") == "process_name"
           and e["args"]["name"] == "gear_tpu_torch"]
    assert len(pid) == 1
    mine = [e for e in events if e.get("pid") == pid[0] and e["ph"] == "X"]
    assert [(e["name"], e["args"]) for e in mine] == [("work", {"n": 7})]
    span = mine[0]
    add = [e for e in events if e.get("name") == "aten::add"
           and e.get("ph") == "X"]
    assert len(add) == 1
    slack = 1000.0   # us
    assert span["ts"] - slack <= add[0]["ts"]
    assert add[0]["ts"] + add[0]["dur"] <= span["ts"] + span["dur"] + slack
    assert span["dur"] >= add[0]["dur"]


def _rec(name, t0, t1, parent=None, root=0):
    return profiling.Span(name, t0, t1, parent, root, 1)


@pytest.mark.parametrize("kids,want", [
    ([], 100),
    ([(10, 30), (50, 60)], 70),          # apart
    ([(10, 40), (20, 50), (30, 35)], 60),  # overlapping
    ([(-10, 20), (90, 130)], 70),        # reaching out of the parent
], ids=["alone", "apart", "overlapping", "outside"])
def test_self_time_is_the_duration_less_the_childrens_union(kids, want):
    recs = [_rec("p", 0, 100)] + [_rec("c", a, b, parent=0)
                                  for a, b in kids]
    recs.append(_rec("open", 5, None, parent=0))
    own = profiling.self_ns(recs)
    assert own[0] == want
    assert own[1:-1] == [b - a for a, b in kids] and own[-1] is None


def test_roots_keeps_the_last_root_of_each_value():
    recs = [_rec("step", 0, 1), _rec("layer", 0, 1, parent=0),
            _rec("step", 2, 3, root=2), _rec("other", 4, 5, root=3),
            _rec("step", 6, 7, root=4)]
    for r, s in zip(recs, [1, 1, 2, 2, 1]):
        r.attrs["step"] = s
    assert profiling.roots("step", "step", recs) == {1: 4, 2: 2}
