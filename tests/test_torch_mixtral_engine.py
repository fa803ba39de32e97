"""Mixtral on the port's engine (``InferenceEngine`` over a ``MixtralConfig``):
against the benchmark's plain reference (``portbench/reference/mixtral.py``)
in float32, against the port's own Mixtral passes bit for bit, and sharded
over four gloo ranks (tensor parallel heads, expert parallel experts)
against the unsharded engine; and the engine's rule for which sharded steps
a CUDA graph may hold.

This file is also the ranks' program: ``python test_torch_mixtral_engine.py
CASE RANK WORLD INIT OUT_DIR``. Case ``gloo4`` runs on the CPU; case
``nccl_graph`` takes a card per rank and runs from
``tests/test_torch_cuda.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve()
REPO = HERE.parent.parent
SPAWN_TIMEOUT = 300  # seconds for a whole spawn, every rank
SEED = 11
HF = {"model_type": "mixtral", "hidden_size": 128, "intermediate_size": 64,
      "num_hidden_layers": 2, "num_attention_heads": 8,
      "num_key_value_heads": 4, "vocab_size": 128, "num_local_experts": 8,
      "num_experts_per_tok": 2, "rope_theta": 1000000.0,
      "rms_norm_eps": 1e-05, "max_position_embeddings": 512,
      "sliding_window": None, "tie_word_embeddings": False,
      "torch_dtype": "float32"}
COMP = dict(compress_method="GEAR", quantize_bit=4, group_size=16, rank=2,
            prefill_rank=4, loop=2, left=0.05)
PROMPTS = [list(range(3, 33)), [7, 9, 40, 41, 5, 6, 8, 100, 101, 3, 77]]
BUCKET, MAX_LEN, STEPS = 32, 64, 20   # step 15 flushes the residual tier


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


def _config(hf=HF):
    import dataclasses

    from gear_tpu_torch.models import mixtral
    from portbench.families.mistral import port_rope_theta
    from portbench.weights import dtype_of

    cfg = mixtral.MixtralConfig.from_hf(hf)
    return dataclasses.replace(
        cfg, dtype=dtype_of(hf),
        rope_theta=port_rope_theta(cfg.rope_theta, cfg.head_dim))


def _engine(mode, params, cfg=None, device="cpu", max_len=MAX_LEN,
            comp=COMP):
    from gear_tpu_torch.config import CompressionConfig
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine

    cfg = cfg or _config()
    return InferenceEngine(cfg, params, CompressionConfig(
        num_layers=cfg.num_layers, **comp),
        EngineConfig(max_len=max_len, mode=mode), batch_size=2, device=device)


def _served(eng, init, steps=STEPS, log=None):
    """Prompt pass and ``steps`` greedy steps -> (tokens [B, S], mask,
    served [B, steps + 1], logits [B, steps + 1, V]); with the engine's
    router ``log``, each step's probabilities are appended to ``log.kept``."""
    tokens, mask = eng.left_pad(PROMPTS, 0, BUCKET)
    logits, caches = eng.prefill(tokens, mask, init=init)
    out = [logits[:, -1]]
    cur = out[0].argmax(-1)
    served = [cur]
    plen = mask.sum(1).to(torch.int32)
    for j in range(steps):
        cur, lg, caches = eng.decode_step(caches, cur, plen + j,
                                          (BUCKET - plen).to(torch.int32),
                                          step=j, init=init)
        out.append(lg)
        served.append(cur)
        if log is not None:
            log.kept.append(log.step.clone())
    return tokens, mask, torch.stack(served, 1), torch.stack(out, 1)


# ---------------------------------------------------------------------------
# One process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_the_engine_against_the_plain_reference(mode):
    """Prompt pass and 20 steps across a flush, teacher-forced through the
    reference (top-2 experts computed sparsely, GEAR by
    ``reference/gear.py``): in float32 every logit within 2e-4."""
    from portbench import counts, inits, weights_moe
    from portbench.reference import mixtral as reference

    cpu = torch.device("cpu")
    eng = _engine(mode, weights_moe.rank_share(HF, SEED, cpu, 0, 1))
    starts = inits.Inits(SEED, cpu)
    cfg = eng.cfg
    fmt = counts.kv_format(COMP if mode == "fused" else None, cfg.head_dim)
    log = eng.log_routing()
    log.kept = []
    tokens, mask, served, logits = _served(eng, starts, log=log)
    follow = torch.cat([log.take_prompt(), torch.stack(log.kept, 2)], 2)
    ref, routing = reference.forward(
        weights_moe.outer(HF, SEED, cpu),
        lambda i: weights_moe.layer(HF, SEED, i, cpu), HF,
        torch.cat([tokens, served[:, :STEPS]], 1), mask,
        "gear" if mode == "fused" else "raw", fmt=fmt, loop=COMP["loop"],
        inits=starts.for_rows(torch.arange(2), 2, cfg.num_kv_heads,
                              cfg.head_dim, fmt), follow=follow)
    assert ref.shape == logits.shape
    assert routing["margin"].shape == (cfg.num_layers, 2, BUCKET + STEPS)
    assert float((ref - logits).abs().max()) <= 2e-4
    # the engine's log is its router's: the reference's own choices, its
    # probabilities to rounding
    real = torch.cat([mask.bool(), torch.ones(2, STEPS, dtype=torch.bool)], 1)
    assert not routing["differ"][:, real].any()
    assert float(routing["diff"][:, real].max()) <= 1e-5


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_the_engine_equals_the_mixtral_passes(mode):
    """The engine's prefill and decode steps are ``mixtral.forward_*``'s,
    bit for bit, flush included."""
    from gear_tpu_torch.models import mixtral
    from portbench import inits, weights_moe

    cpu = torch.device("cpu")
    params = weights_moe.rank_share(HF, SEED, cpu, 0, 1)
    eng = _engine(mode, params)
    starts = inits.Inits(SEED, cpu)
    tokens, mask, served, logits = _served(eng, starts)
    cfg, fused = eng.cfg, mode == "fused"
    pos = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    lg, caches = mixtral.forward_prefill(params, cfg, tokens, pos, mask,
                                         eng.spec, compress=fused,
                                         init=starts)
    assert torch.equal(lg[:, -1], logits[:, 0])
    plen = mask.sum(1).to(torch.int32)
    for j in range(STEPS):
        lg, caches = mixtral.forward_decode(
            params, cfg, served[:, j], plen + j, caches, spec=eng.spec,
            compress=fused, pad_start=(BUCKET - plen).to(torch.int32),
            init=starts, step=j)
        assert torch.equal(lg, logits[:, j + 1]), j
    assert eng.eager_steps == STEPS


def test_the_sparse_reference_mixture_equals_the_dense_form():
    """``reference.mixtral.moe`` (top-2 experts computed on their tokens)
    against the port's dense ``moe_block`` in float32."""
    from gear_tpu_torch.models import mixtral
    from portbench.reference import mixtral as reference

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 32, generator=gen)
    router = torch.randn(32, 8, generator=gen)
    wg, wu = (torch.randn(8, 32, 48, generator=gen) * 0.2 for _ in "gu")
    wd = torch.randn(8, 48, 32, generator=gen) * 0.2
    want = mixtral.moe_block(x, router, wg, wu, wd, 2)
    got, probs, idx = reference.moe(x.reshape(10, 32), router, wg, wu, wd, 2)
    torch.testing.assert_close(got.reshape(x.shape), want, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(probs.sum(-1), torch.ones(10))
    # following another router's choices: its pairs, its own weights
    other = torch.rand(10, 8, generator=gen)
    got, _, idx = reference.moe(x.reshape(10, 32), router, wg, wu, wd, 2,
                                follow=other)
    assert torch.equal(idx, other.topk(2, dim=-1).indices)


@pytest.mark.parametrize("backend,want", [("gloo", "mesh"), ("nccl", None)])
def test_a_sharded_step_is_captured_only_over_nccl(monkeypatch, backend,
                                                   want):
    """A greedy fused step of a sharded engine on the card: eager over a
    gloo mesh (its collectives pass through the host), a graph's over an
    nccl mesh; the mesh's groups are in the graph's key."""
    import torch.distributed as dist

    from gear_tpu_torch import cache as TC
    from gear_tpu_torch.parallel import distributed
    from portbench import weights_moe

    eng = _engine("fused", weights_moe.rank_share(HF, SEED, "cpu", 0, 1))
    mesh = distributed.Mesh.__new__(distributed.Mesh)
    mesh.shape, mesh._groups = {"model": 4}, {"model": object()}
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    eng.device, eng.mesh = torch.device("cuda"), mesh
    caches = TC.init_layer_cache(eng.spec)
    assert eng._eager_because(caches) == want
    tok = torch.zeros(2, dtype=torch.int64)
    key = eng._key(caches, tok, tok, None)
    assert key[-1] == (id(mesh._groups["model"]),)


# ---------------------------------------------------------------------------
# Four gloo ranks.
# ---------------------------------------------------------------------------

def _case_gloo4(out: Path) -> dict:
    import torch.distributed as dist

    from gear_tpu_torch.models import mixtral
    from gear_tpu_torch.parallel import distributed as D
    from gear_tpu_torch.parallel import sharding as S
    from portbench import weights_moe

    rank, world = dist.get_rank(), dist.get_world_size()
    cpu = torch.device("cpu")
    whole = weights_moe.rank_share(HF, SEED, cpu, 0, 1)
    mesh = S.make_mesh(model=world)
    res = {}
    for mode in ("fused", "raw"):
        want = _engine(mode, whole).generate(PROMPTS, STEPS, seed=4)
        sharded = _engine(mode, whole).shard(mesh)
        local = _engine(mode, weights_moe.rank_share(
            HF, SEED, cpu, rank, world)).shard(mesh, local=True)
        res[mode] = {"want": want, "sharded": sharded.generate(
            PROMPTS, STEPS, seed=4), "local": local.generate(
            PROMPTS, STEPS, seed=4),
            "eager": sharded.eager_steps, "captures": sharded.graph_captures,
            "experts": local.params["layers"]["wg"].shape[1],
            "same_params": all(torch.equal(a, b) for a, b in zip(
                local.params["layers"].values(),
                sharded.params["layers"].values()))}
    # the ranks' partial mixtures sum to the uncut one
    lp = {k: v[0] for k, v in whole["layers"].items()}
    x = torch.randn(2, 3, HF["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    nel = HF["num_local_experts"] // world
    part = mixtral.moe_partial(x, lp["router"],
                               *(lp[w][rank * nel:(rank + 1) * nel]
                                 for w in ("wg", "wu", "wd")), 2,
                               first=rank * nel)
    D.reset_collective_counts()
    total = D.all_reduce(part.clone(), mesh, "model")
    res["partial_err"] = float((total - mixtral.moe_block(
        x, lp["router"], lp["wg"], lp["wu"], lp["wd"], 2)).abs().max())
    res["partial_alone_err"] = float((part - total).abs().max())
    res["counts"] = D.collective_counts()
    return res


def _case_nccl_graph(out: Path) -> dict:
    """A TP/EP 2 Mixtral (bf16, GEAR int4 and raw) on a card per rank: the
    engine's replayed steps against ``llama.forward_decode`` run eagerly
    over a copy of the cache, 70 steps from the prompt pass's cache, a
    restore, 70 again."""
    import dataclasses

    import torch.distributed as dist

    from gear_tpu_torch.models import llama, mixtral
    from gear_tpu_torch.parallel import distributed as D
    from gear_tpu_torch.parallel import sharding as S
    from portbench import inits, weights_moe

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    hf = {**HF, "hidden_size": 128, "num_attention_heads": 4,
          "num_key_value_heads": 2, "num_local_experts": 4,
          "torch_dtype": "bfloat16"}
    cfg = _config(hf)
    mesh = S.make_mesh(model=world)
    comp = {**COMP, "left": 0.05}
    res = {"capturable": D.capturable(mesh)}
    for mode in ("fused", "raw"):
        params = weights_moe.rank_share(hf, SEED, dev, rank, world)
        eng = _engine(mode, params, cfg, device=dev, max_len=192,
                      comp=comp).shard(mesh, local=True)
        starts = inits.Inits(SEED, dev)
        prompts = [list(range(3, 113)), list(range(40, 70))]
        tokens, mask = eng.left_pad(prompts, 0, 112)
        logits, caches = eng.prefill(tokens, mask, init=starts)
        tok0 = logits[:, -1].argmax(-1)
        plen = mask.sum(1).to(torch.int32)
        pad = (112 - plen).to(torch.int32)
        snap = {k: v.clone() if torch.is_tensor(v) else v
                for k, v in vars(caches).items()}
        ref = dataclasses.replace(caches, **{
            k: v.clone() for k, v in vars(caches).items()
            if torch.is_tensor(v)})
        ffn = mixtral.engine_ffn(eng.cfg, eng.tp)
        # the eager steps take the engine's inits: the whole heads' draws
        init = S.sharded_inits(mesh, starts, None, dev)
        equal_tok = equal_lg = True
        D.reset_collective_counts()
        for _ in range(2):
            for c in (caches, ref):
                for k, v in snap.items():
                    if torch.is_tensor(v):
                        getattr(c, k).copy_(v)
                    else:
                        setattr(c, k, v)
            cur = cur_ref = tok0
            for j in range(70):
                cur, lg, caches = eng.decode_step(caches, cur, plen + j, pad,
                                                  step=j, init=starts)
                lg_ref, ref = llama.forward_decode(
                    eng.params, eng.cfg, cur_ref, plen + j, ref,
                    spec=eng.spec, compress=mode == "fused", pad_start=pad,
                    init=init, step=j, ffn=ffn, tp=eng.tp)
                cur_ref = lg_ref.argmax(-1)
                equal_tok &= bool(torch.equal(cur, cur_ref))
                equal_lg &= bool(torch.equal(lg, lg_ref))
        res[mode] = {"tokens_equal": equal_tok, "logits_equal": equal_lg,
                     "captures": eng.graph_captures,
                     "replays": eng.graph_replays,
                     "eager": eng.eager_steps,
                     "flushes": 8 if mode == "fused" else 0,
                     "counts": D.collective_counts(),
                     "layers": cfg.num_layers}
        del eng, caches, ref, snap, params
        torch.cuda.empty_cache()
    return res


CASES = {"gloo4": _case_gloo4, "nccl_graph": _case_nccl_graph}


def _rank_main(case, rank, world, init, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    nccl = case == "nccl_graph"
    if nccl:
        torch.cuda.set_device(int(rank))
    dist.init_process_group("nccl" if nccl else "gloo", init_method=init,
                            world_size=int(world), rank=int(rank))
    try:
        res = CASES[case](Path(out_dir))
        Path(out_dir, f"{case}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gloo4"), "gloo4", 4)


@pytest.mark.parametrize("mode", ["fused", "raw"])
def test_the_sharded_engine_serves_the_unsharded_tokens(gloo4, mode):
    """Heads and vocabulary over 4 ranks, 2 experts a rank: every rank's
    tokens equal the unsharded engine's, sharded from the whole params or
    built from the rank's own share (``shard(mesh, local=True)``), whose
    params are the same slices."""
    for r in gloo4:
        got = r[mode]
        assert got["sharded"] == got["want"] and got["local"] == got["want"]
        assert got["experts"] == 2 and got["same_params"]


def test_gloo_ranks_run_every_step_eagerly(gloo4):
    for r in gloo4:
        for mode in ("fused", "raw"):
            assert r[mode]["captures"] == 0
            assert r[mode]["eager"] == STEPS - 1


def test_the_ranks_partial_mixtures_sum_to_the_uncut_mixture(gloo4):
    """``moe_partial`` over each rank's 2 experts, routed over all 8, summed
    by one float32 ``all_reduce``: the uncut ``moe_block`` to rounding; no
    rank's part is the whole; the call and its bytes counted."""
    for r in gloo4:
        assert r["partial_err"] <= 1e-5
        assert r["partial_alone_err"] > 1e-3
        assert r["counts"] == {"calls": 1,
                               "bytes": 2 * 3 * HF["hidden_size"] * 4}


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
