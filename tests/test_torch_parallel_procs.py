"""The port's parallel paths (``gear_tpu_torch.parallel``) in real
``torch.distributed`` processes on the CPU (gloo), against the unsharded
port and against ``gear_tpu``'s sharded decode step.

Two spawns run every case: 2 ranks (``model``: tensor parallelism, the
mesh helpers, ``GearLM.shard``, the TP decode step held against gear_tpu's
on its 8-device CPU mesh) and 4 ranks (``data`` x ``model``, ``seq``,
``expert``, and ``seq`` x ``model`` together). The ranks rendezvous through a
``file://`` init in the test's own directory (no port, so tests under xdist
do not collide) and write what they computed there; every rank is killed if
the spawn outlives its limit. This file is also the ranks' program:
``python test_torch_parallel_procs.py CASE RANK WORLD INIT OUT_DIR``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
REPO = HERE.parent.parent
SPAWN_TIMEOUT = 240  # seconds for a whole spawn, every rank

COMP = dict(compress_method="GEARL", quantize_bit=4, group_size=16, rank=2,
            prefill_rank=4, loop=2)
PROMPTS = [[1, 5, 9, 12, 3, 44, 7], [3, 7, 100], [8, 2, 6, 4, 9], [77]]


def _spawn(out_dir: Path, case: str, world: int) -> list[dict]:
    init = f"file://{out_dir / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(HERE), case, str(r), str(world), init,
         str(out_dir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{log[-4000:]}"
    return [json.loads((out_dir / f"{case}_{r}.json").read_text())
            for r in range(world)]


# ---------------------------------------------------------------------------
# The ranks' side (torch only).
# ---------------------------------------------------------------------------

def _tiny(**kw):
    from gear_tpu_torch.models import llama

    return llama.ModelConfig.tiny(dtype=torch.float32, **kw)


def _engine(cfg, params, batch, mode="fused", comp=None, max_len=64,
            device="cpu", **ecfg):
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine

    comp = CompressionConfig(num_layers=cfg.num_layers,
                             **{**COMP, **(comp or {})})
    return InferenceEngine(cfg, params, comp,
                           EngineConfig(max_len=max_len, mode=mode, **ecfg),
                           batch_size=batch, device=device)


def _engine_pairs(mesh, cfg, params, prompts, cases, n_new=20):
    """{name: (unsharded tokens, sharded tokens)} for each
    (name, engine kwargs, generate kwargs) of ``cases``."""
    out = {}
    for name, kw, gkw in cases:
        want = _engine(cfg, params, len(prompts), **kw).generate(
            prompts, n_new, **gkw)
        got = _engine(cfg, params, len(prompts), **kw).shard(mesh).generate(
            prompts, n_new, **gkw)
        out[name] = (want, got)
    return out


# the modes of the sharded engine, each across a flush (bucket 16, group 16)
# or an eviction / a wrap / two recompressions
MODE_CASES = [
    ("fused", {}, {}),
    ("raw", dict(mode="raw"), {}),
    ("simulated", dict(mode="simulated", comp=dict(streaming_gap=8)), {}),
    ("h2o", dict(mode="h2o", comp=dict(important_size=8, recent_size=16)),
     {}),
    ("sink", dict(mode="sink", comp=dict(sink_size=4, window_size=20)), {}),
    ("fused sampled", dict(temperature=0.8), dict(seed=5)),
]


def _case_model2(out: Path) -> dict:
    import torch.distributed as dist

    from gear_tpu_torch import convert
    from gear_tpu_torch.api import GearLM
    from gear_tpu_torch.models import llama
    from gear_tpu_torch.parallel import distributed as D
    from gear_tpu_torch.parallel import sharding as S

    res = {}
    mesh = D.pod_mesh(model_parallel=2)
    res["pod_mesh"] = mesh.shape
    res["pod_mesh_seq"] = D.pod_mesh(1, seq_parallel=2).shape
    for name, fn in (("pod_mesh_3", lambda: D.pod_mesh(3)),
                     ("make_mesh_4", lambda: S.make_mesh(data=2, model=2))):
        try:
            fn()
            res[name] = "no error"
        except ValueError as e:
            res[name] = str(e)
    res["describe"] = D.describe(mesh)
    x = torch.full((2,), float(dist.get_rank() + 1))
    res["sum"] = D.all_reduce(x, mesh, "model").tolist()
    res["max"] = D.all_reduce(torch.tensor([float(dist.get_rank())]), mesh,
                              "model", "max").tolist()

    # the TP decode step against gear_tpu's sharded one: its params and
    # inits, carried across as numpy
    data = np.load(out / "tp_inputs.npz")
    cfg = _tiny(num_heads=4, num_kv_heads=4)
    params = convert.params_from_numpy(
        {k: data[k] for k in ("embed", "final_norm", "lm_head")}
        | {"layers": {k[2:]: data[k] for k in data.files
                      if k.startswith("l.")}})
    lcfg = S.local_config(cfg, mesh)
    lparams = S.shard_params(mesh, params)
    tp = S.TensorParallel(mesh)
    spec = lcfg.cache_spec(2, 64, _comp_layer(cfg))

    def init(site, shape):
        key = "/".join(str(s) for s in site[:4])
        assert site[0] == "prefill" or site[4] == 16, site
        a = data["init/" + key]
        assert a.shape == tuple(shape), (site, a.shape, shape)
        return torch.from_numpy(a)

    draw = S.sharded_inits(mesh, init, None, "cpu")
    tokens = torch.from_numpy(data["tokens"]).long()
    mask = torch.from_numpy(data["mask"])
    pos = torch.from_numpy(data["pos"])
    logits, caches = llama.forward_prefill(lparams, lcfg, tokens, pos, mask,
                                           spec, init=draw, tp=tp)
    steps = [logits[:, -1]]
    tok = torch.from_numpy(data["tok0"]).long()
    pad = torch.from_numpy(data["pad"])
    for step in range(10):
        lg, caches = llama.forward_decode(
            lparams, lcfg, tok, pos[:, -1] + 1 + step, caches, spec=spec,
            pad_start=pad, init=draw, step=step, tp=tp)
        steps.append(lg)
        tok = torch.from_numpy(data[f"tok{step + 1}"]).long()
    np.save(out / f"tp_logits_{mesh.rank}.npy",
            torch.stack(steps).numpy())
    res["tp_comp_len"] = caches.comp_len

    # a whole cache's TP slice (shard_cache) decodes as the unsharded one
    params = llama.init_params(_tiny(), seed=1, device="cpu")
    cfg = _tiny()
    fspec = cfg.cache_spec(2, 64, _comp_layer(cfg))
    gen = torch.Generator().manual_seed(3)
    _, full = llama.forward_prefill(params, cfg, tokens, pos, mask, fspec,
                                    generator=gen)
    local = S.shard_cache(mesh, full)
    res["shard_cache_contiguous"] = all(
        getattr(local, f).is_contiguous() for f in ("k_codes", "kpt"))
    tok = torch.tensor([3, 9])
    want, _ = llama.forward_decode(params, cfg, tok, pos[:, -1] + 1, full,
                                   spec=fspec, pad_start=pad)
    lcfg = S.local_config(cfg, mesh)
    got, _ = llama.forward_decode(
        S.shard_params(mesh, params), lcfg, tok, pos[:, -1] + 1, local,
        spec=lcfg.cache_spec(2, 64, _comp_layer(cfg)), pad_start=pad,
        tp=S.TensorParallel(mesh))
    res["shard_cache_err"] = float((got - want).abs().max())

    # the sharded engine in every mode, and GearLM.shard
    res["modes"] = _engine_pairs(mesh, cfg, params, PROMPTS[:2], MODE_CASES)
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig

    def lm():
        return GearLM(cfg=cfg, params=params,
                      comp=CompressionConfig(num_layers=2, **COMP),
                      engine_cfg=EngineConfig(max_len=64), batch_size=2,
                      device="cpu")
    res["gearlm"] = (lm().generate(PROMPTS[:2], 20),
                     lm().shard(mesh).generate(PROMPTS[:2], 20))
    try:
        _engine(cfg, params, 2, mode="simulated",
                comp=dict(compress_method="GEAR")).shard(mesh)
        res["simulated_gear"] = "no error"
    except ValueError as e:
        res["simulated_gear"] = str(e)
    return res


def _comp_layer(cfg):
    from gear_tpu_torch.config import CompressionConfig

    return CompressionConfig(num_layers=cfg.num_layers, **COMP).layer(0)


def _case_world4(out: Path) -> dict:
    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.models import llama
    from gear_tpu_torch.models import mixtral as MX
    from gear_tpu_torch.parallel import context as C
    from gear_tpu_torch.parallel import distributed as D
    from gear_tpu_torch.parallel import sharding as S

    res = {}
    cfg = _tiny()
    params = llama.init_params(cfg, seed=1, device="cpu")

    # data x model
    mesh = S.make_mesh(data=2, model=2)
    res["dp_mesh"] = [mesh.shape, mesh.coords]
    res["dp_modes"] = _engine_pairs(mesh, cfg, params, PROMPTS, [
        ("fused", {}, {}), ("raw", dict(mode="raw"), {}),
        ("h2o", dict(mode="h2o", comp=dict(important_size=8,
                                           recent_size=16)), {}),
        ("fused sampled", dict(temperature=0.8), dict(seed=7))])
    # eos: row 1's 4th token ends it
    first = res["dp_modes"]["fused"][0]
    eos = first[1][3]
    res["dp_modes"].update(_engine_pairs(mesh, cfg, params, PROMPTS, [
        ("fused eos", dict(eos_token_id=eos, sync_every=2), {})]))
    try:
        _engine(cfg, params, 3).shard(mesh)
        res["dp_batch_3"] = "no error"
    except ValueError as e:
        res["dp_batch_3"] = str(e)

    # seq: 4 time shards, 40 new tokens (two flushes on the last shard)
    seq = D.Mesh({"seq": 4})
    res["seq"] = {}
    for name, kw, gkw in (("greedy", {}, {}),
                          ("sampled", dict(temperature=0.8), dict(seed=2))):
        want = _engine(cfg, params, 2, max_len=128, **kw).generate(
            PROMPTS[:2], 40, **gkw)
        got = _engine(cfg, params, 2, max_len=128, **kw).shard_seq(
            seq).generate(PROMPTS[:2], 40, **gkw)
        res["seq"][name] = (want, got)
    # seq_sharded_attend over one layer, left padding and a residual tier
    spec = TC.CacheSpec(batch=2, num_kv_heads=2, head_dim=16, max_len=128,
                        bits=4, group=16, rank=2, prefill_rank=4,
                        lowrank_loop=2, dtype=torch.float32,
                        sideband_dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn((2, 2, 75, 16), generator=g) for _ in range(2))
    q = torch.randn((2, 4, 1, 16), generator=g)
    whole = TC.prefill(spec, k, v, generator=g)
    pad = torch.tensor([0, 37], dtype=torch.int32)
    want = TC.attend(spec, whole, q, pad_start=pad)
    local = C.split_cache(spec, whole, 4)[seq.index("seq")]
    got = C.seq_sharded_attend(spec, local, q, seq, pad_start=pad)
    res["seq_attend_err"] = float((got - want).abs().max())

    # seq x model together (pod_mesh)
    pod = D.pod_mesh(model_parallel=2, seq_parallel=2)
    res["pod"] = [pod.shape, pod.ranks.tolist()]
    want = _engine(cfg, params, 2, max_len=128).generate(PROMPTS[:2], 40)
    eng = _engine(cfg, params, 2, max_len=128).shard(pod).shard_seq(pod)
    res["pod_seq_model"] = (want, eng.generate(PROMPTS[:2], 40))
    res["pod_describe"] = D.describe(D.pod_mesh(model_parallel=2))

    # expert parallelism: 4 experts over 4 ranks
    ep = D.Mesh({"expert": 4})
    mcfg = MX.MixtralConfig.tiny(dtype=torch.float32)
    mparams = MX.init_params(mcfg, seed=0, device="cpu")
    lp = llama._layer_slice(mparams["layers"], 0)
    x = torch.randn((2, 5, mcfg.hidden_size), generator=g)
    want = MX.moe_block(x, lp["router"], lp["wg"], lp["wu"], lp["wd"], 2)
    local = MX.shard_experts(ep, mparams)
    llp = llama._layer_slice(local["layers"], 0)
    got = MX.moe_block_ep(x, lp["router"], llp["wg"], llp["wu"], llp["wd"],
                          2, ep)
    res["ep_err"] = float((got - want).abs().max())
    mspec = mcfg.cache_spec(1, 64, _comp_layer(mcfg))
    tokens = torch.tensor([[1, 2, 3, 4]])
    pos = torch.arange(4)[None]
    mask = torch.ones_like(tokens, dtype=torch.int32)
    steps = {}
    for name, p, kw in (("dense", mparams, {}), ("ep", local,
                                                 dict(ep_mesh=ep))):
        lg, caches = MX.forward_prefill(p, mcfg, tokens, pos, mask, mspec,
                                        generator=torch.Generator()
                                        .manual_seed(0), **kw)
        dl, _ = MX.forward_decode(p, mcfg, torch.tensor([5]),
                                  torch.tensor([4]), caches, spec=mspec, **kw)
        steps[name] = (lg, dl)
    res["ep_step_err"] = [float((a - b).abs().max()) for a, b in
                          zip(steps["dense"], steps["ep"])]
    try:
        MX.moe_block_ep(x, lp["router"][:, :3], llp["wg"], llp["wu"],
                        llp["wd"], 2, ep)
        res["ep_3"] = "no error"
    except ValueError as e:
        res["ep_3"] = str(e)
    return res


def _case_cuda_tp(out: Path) -> dict:
    """One fused prefill and decode step on cuda:0, unsharded and tensor
    parallel over the 2 ranks (which share the card): the kernels at each
    rank's kv heads."""
    from gear_tpu_torch import kernels
    from gear_tpu_torch.models import llama
    from gear_tpu_torch.parallel import sharding as S

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.ModelConfig.tiny(hidden_size=256, num_heads=4,
                                 num_kv_heads=4, head_dim=64,
                                 intermediate_size=512)
    params = llama.init_params(cfg, seed=3, device="cuda")
    mesh = S.make_mesh(model=2)
    res = {}
    for name in ("unsharded", "tp"):
        eng = _engine(cfg, params, 2, device="cuda")
        if name == "tp":
            eng.shard(mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        s = eng.bucket_len(7)
        tokens, mask = eng.left_pad(PROMPTS[:2], 0, s)
        kernels.reset_launch_counts()
        logits, caches = eng.prefill(tokens, mask, generator=gen)
        lens = mask.sum(dim=1).to(torch.int32)
        _, lg, _ = eng.decode_step(caches, logits[:, -1].argmax(-1), lens,
                                   (s - lens).to(torch.int32), generator=gen)
        res[name] = (lg.float().cpu(), kernels.launch_counts(),
                     eng.spec.num_kv_heads)
    (want, _, _), (got, counts, hkv) = res["unsharded"], res["tp"]
    return {"err": float((got - want).abs().max() / want.abs().max()),
            "counts": counts, "hkv": hkv}


CASES = {"model2": _case_model2, "world4": _case_world4,
         "cuda_tp": _case_cuda_tp}


def _rank_main(case, rank, world, init, out_dir):
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=world, RANK=rank)
    import torch.distributed as dist

    from gear_tpu_torch.parallel import distributed

    distributed.initialize_from_env("gloo", init_method=init)
    try:
        res = CASES[case](Path(out_dir))
        Path(out_dir, f"{case}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()



# ---------------------------------------------------------------------------
# The tests' side.
# ---------------------------------------------------------------------------

def _gear_tpu_sharded_steps(out: Path) -> np.ndarray:
    """gear_tpu's fused prefill and ten decode steps (a flush at step 7) of
    a tiny float32 Llama with 4 kv heads, its params sharded over the
    8-device CPU mesh (data 2 x model 4, as tests/test_sharding.py): the
    last prompt position's and each step's logits [11, B, V]. Its params,
    prompt, greedy tokens and power-iteration inits go to
    ``out/tp_inputs.npz`` for the ranks."""
    import jax
    import jax.numpy as jnp

    from gear_tpu.config import CompressionConfig as JComp
    from gear_tpu.models import llama as jllama
    from gear_tpu.parallel import sharding as jsh
    from test_torch_model import _flush_key, _uniform

    cfg = jllama.ModelConfig.tiny(num_heads=4, num_kv_heads=4,
                                  dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    spec = cfg.cache_spec(2, 64, JComp(num_layers=2, **COMP).layer(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0  # left padding
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    pad = np.array([0, 5], np.int32)
    prng = jax.random.PRNGKey(3)
    sharded = jsh.shard_params(jsh.make_mesh(data=2, model=4), params)

    logits, caches = jax.jit(lambda p, t, q, m, k: jllama.forward_prefill(
        p, cfg, t, q, m, spec, prng=k))(sharded, tokens, pos, mask, prng)
    dec = jax.jit(lambda p, t, q, c, ps, k: jllama.forward_decode(
        p, cfg, t, q, c, spec=spec, pad_start=ps, prng=k))
    steps = [np.asarray(logits[:, -1])]
    toks = {"tok0": steps[0].argmax(-1).astype(np.int32)}
    inits = {}
    for layer, lkey in enumerate(jax.random.split(prng, cfg.num_layers)):
        for which, key in zip("kv", jax.random.split(lkey)):
            inits[f"init/prefill/{layer}/{which}"] = _uniform(
                key, (2, 4, 16, 4)).numpy()
    for step in range(10):
        dkey = jax.random.PRNGKey(50 + step)
        for layer, lkey in enumerate(jax.random.split(dkey, cfg.num_layers)):
            for which in "kv":
                inits[f"init/decode/{step}/{layer}/{which}"] = _uniform(
                    _flush_key(lkey, 16, which), (2, 4, 16, 2)).numpy()
        lg, caches = dec(sharded, toks[f"tok{step}"], pos[:, -1] + 1 + step,
                         caches, pad, dkey)
        steps.append(np.asarray(lg))
        toks[f"tok{step + 1}"] = steps[-1].argmax(-1).astype(np.int32)
    layers = {f"l.{k}": np.asarray(v) for k, v in params["layers"].items()}
    np.savez(out / "tp_inputs.npz", tokens=tokens, mask=mask, pos=pos,
             pad=pad, embed=np.asarray(params["embed"]),
             final_norm=np.asarray(params["final_norm"]),
             lm_head=np.asarray(params["lm_head"]), **layers, **toks,
             **inits)
    return np.stack(steps)


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    out = tmp_path_factory.mktemp("model2")
    want = _gear_tpu_sharded_steps(out)
    res = _spawn(out, "model2", 2)
    got = [np.load(out / f"tp_logits_{r}.npy") for r in range(2)]
    return res, want, got


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), "world4", 4)


def test_mesh_helpers_across_two_ranks(model2):
    res = model2[0]
    for r, rr in enumerate(res):
        assert rr["pod_mesh"] == {"data": 1, "seq": 1, "model": 2}
        assert rr["pod_mesh_seq"] == {"data": 1, "seq": 2, "model": 1}
        assert "not divisible by model*seq = 3" in rr["pod_mesh_3"]
        assert "needs 4 ranks" in rr["make_mesh_4"]
        assert rr["describe"] == (
            "mesh {'data': 1, 'seq': 1, 'model': 2} over 2 ranks (gloo "
            f"backend), rank {r} at {{'data': 0, 'seq': 0, 'model': {r}}}")
        assert rr["sum"] == [3.0, 3.0] and rr["max"] == [1.0]


def test_tp_decode_logits_match_gear_tpu_sharded_step(model2):
    """Prefill and ten decode steps across a flush, float32, tensor
    parallel over 2 ranks: every rank's logits within 1e-4 of gear_tpu's
    step sharded over its 8-device mesh (the same params and inits)."""
    res, want, got = model2
    assert all(rr["tp_comp_len"] == 32 for rr in res)  # the flush happened
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4)


def test_shard_cache_slice_decodes_as_unsharded(model2):
    for rr in model2[0]:
        assert rr["shard_cache_contiguous"]
        assert rr["shard_cache_err"] < 1e-5


@pytest.mark.parametrize("mode", [c[0] for c in MODE_CASES])
def test_tp_engine_tokens_match_unsharded(model2, mode):
    for rr in model2[0]:
        want, got = rr["modes"][mode]
        assert got == want


def test_gearlm_shard_matches_unsharded(model2):
    for rr in model2[0]:
        want, got = rr["gearlm"]
        assert got == want


def test_tp_refuses_simulated_groups_across_ranks(model2):
    for rr in model2[0]:
        assert "mixes the heads of several ranks" in rr["simulated_gear"]


@pytest.mark.parametrize("mode", ["fused", "raw", "h2o", "fused sampled",
                                  "fused eos"])
def test_data_and_model_parallel_tokens_match_unsharded(world4, mode):
    for rr in world4:
        want, got = rr["dp_modes"][mode]
        assert got == want
    if mode == "fused eos":  # row 1 stops at its 4th token, one runs on
        assert len(want[1]) <= 4 and max(len(r) for r in want) == 20


def test_data_parallel_layout_and_uneven_batch(world4):
    coords = [rr["dp_mesh"][1] for rr in world4]
    assert coords == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    assert all("batch 3 does not split evenly over data=2" in rr["dp_batch_3"]
               for rr in world4)


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_seq_sharded_generation_matches_plain(world4, sampling):
    """Four time shards, 40 new tokens: two flushes on the last shard."""
    for rr in world4:
        want, got = rr["seq"][sampling]
        assert got == want


def test_seq_sharded_attend_matches_attend(world4):
    assert all(rr["seq_attend_err"] < 1e-5 for rr in world4)


def test_seq_and_model_parallel_together(world4):
    for rr in world4:
        assert rr["pod"] == [{"data": 1, "seq": 2, "model": 2},
                             [[[0, 1], [2, 3]]]]
        want, got = rr["pod_seq_model"]
        assert got == want
    assert "over 4 ranks (gloo backend)" in world4[3]["pod_describe"]
    assert "{'data': 1, 'seq': 0, 'model': 1}" in world4[3]["pod_describe"]


def test_expert_parallel_matches_dense_mixture(world4):
    """moe_block_ep over 4 ranks (each given its experts by shard_experts)
    against moe_block, and EP prefill and decode logits against the dense
    ones. In float32 splitting the experts changes only the order of the
    sum, so the float32 parity tolerance holds."""
    for rr in world4:
        assert rr["ep_err"] <= 1e-5
        assert max(rr["ep_step_err"]) <= 1e-5
        assert "3 experts do not split evenly over expert=4" in rr["ep_3"]


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
