"""Parity of the port's synthetic data, trainer and checkpoints
(``gear_tpu_torch.eval.synth``) with ``gear_tpu.eval.synth`` on the CPU.

Datasets, renderings and batches are identical for the same seed; the
torch trainer follows optax's AdamW and warmup-cosine schedule (three steps
from the same parameters and batches land within 1e-5 relative of
``gear_tpu``'s); checkpoints written by either package load in the other
bit for bit, the port's side without ``ml_dtypes``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gear_tpu.eval import synth as JS
from gear_tpu.models import llama as jllama
from gear_tpu_torch import convert
from gear_tpu_torch.eval import synth as TS
from gear_tpu_torch.models import llama as tllama

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: across the suite's parallel workers its
    per-op thread pool oversubscribes the cores (results do not depend on
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_tree(a: dict, b: dict) -> bool:
    fa, fb = TS._flatten(a), TS._flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for (_, x), (_, y) in zip(fa, fb))


def test_tokenizer_matches_reference():
    text = "Tom has 12 apples.\nHow many? ~{}"
    j, t = JS.CharTokenizer(), TS.CharTokenizer()
    assert t.vocab_size == j.vocab_size and t.itos == j.itos
    assert t.encode(text) == j.encode(text)
    ids = t.encode(text) + [0, 1]
    assert t.decode(ids) == j.decode(ids)
    assert t.decode(ids, False) == j.decode(ids, False)


@pytest.mark.parametrize("n,seed", [(50, 0), (400, 999)])
def test_dataset_rows_identical(n, seed, tmp_path):
    rows = TS.make_dataset(n, seed)
    assert rows == JS.make_dataset(n, seed)
    assert [TS.render_example(r) for r in rows] == [
        JS.render_example(r) for r in rows]
    TS.write_jsonl(rows, tmp_path / "t.jsonl")
    JS.write_jsonl(rows, tmp_path / "j.jsonl")
    assert (tmp_path / "t.jsonl").read_bytes() == (
        tmp_path / "j.jsonl").read_bytes()


def test_batches_identical():
    rows = TS.make_dataset(30, 3)
    spec = TS.TrainSpec(seq_len=40, batch=5, seed=7)
    jspec = JS.TrainSpec(seq_len=40, batch=5, seed=7)
    ti, ji = TS.batches(rows, TS.CharTokenizer(), spec), JS.batches(
        rows, JS.CharTokenizer(), jspec)
    for _ in range(3):
        (tx, tm), (jx, jm) = next(ti), next(ji)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("lr,warmup,decay", [(1e-3, 100, 1600), (3e-4, 1, 4)])
def test_lr_schedule_matches_optax(lr, warmup, decay):
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay,
                                             end_value=lr * 0.1)
    sched = TS.lr_schedule(lr, warmup, decay, lr * 0.1)
    for count in [0, 1, warmup - 1, warmup, warmup + 1, decay // 2, decay - 1,
                  decay, decay + 50]:
        np.testing.assert_allclose(sched(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)


def test_train_steps_match_optax():
    """Three steps (the first at step size 0) of both trainers on a float32
    tiny Llama from the same parameters and batches."""
    jcfg = jllama.ModelConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.ModelConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    rows = JS.make_dataset(64, seed=1)
    kw = dict(seq_len=48, batch=4, steps=3, lr=1e-3, warmup=100, seed=2)
    want = JS.train(jcfg, jparams, rows, JS.CharTokenizer(),
                    JS.TrainSpec(**kw), log_every=0)
    losses = []
    got = TS.train(tcfg, tparams, rows, TS.CharTokenizer(),
                   TS.TrainSpec(**kw), log_every=0, losses=losses)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, want))
    moved = 0.0
    for (path, w), (_, g), (_, p0) in zip(TS._flatten(want),
                                           TS._flatten(got),
                                           TS._flatten(tparams)):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel < 1e-5, (path, rel)
        moved = max(moved, float((w - p0).abs().max()))
    assert moved > 1e-4  # the steps did change the parameters
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert not tparams["embed"].requires_grad


def test_checkpoint_both_ways(tmp_path):
    """A bf16 checkpoint written by either package reads back in the other
    bit for bit (gear_tpu's side as bf16 leaves)."""
    cfg = jllama.ModelConfig.tiny()
    jparams = jllama.init_params(jax.random.PRNGKey(0), cfg)
    JS.save_params(jparams, tmp_path / "j.pkl")
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    got = TS.load_params(tmp_path / "j.pkl", device="cpu")
    assert _same_tree(got, want) and got["embed"].dtype == torch.bfloat16

    TS.save_params(got, tmp_path / "t.pkl")
    back = JS.load_params(tmp_path / "t.pkl")
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(back))
    assert _same_tree(
        convert.params_from_numpy(jax.tree.map(np.asarray, back)), want)
    f32 = TS.load_params(tmp_path / "t.pkl", torch.float32, device="cpu")
    assert f32["layers"]["wq"].dtype == torch.float32
    assert torch.equal(f32["layers"]["wq"], want["layers"]["wq"].float())


def test_load_without_ml_dtypes(tmp_path):
    """In a process where ``import ml_dtypes`` fails, the port reads the
    mid-scale checkpoint (bf16, written by gear_tpu), writes it again, and
    reads that back; both equal ``convert.params_from_numpy`` of the
    reference's load, bit for bit."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None; import torch; "
        "from gear_tpu_torch.eval import synth; "
        "p = synth.load_params('runs/mid_arith/params.pkl', device='cpu'); "
        "synth.save_params(p, sys.argv[1]); "
        "q = synth.load_params(sys.argv[1], device='cpu'); "
        "assert 'jax' not in sys.modules; "
        "torch.save({'p': p, 'q': q}, sys.argv[2])")
    pk, pt = tmp_path / "mid.pkl", tmp_path / "mid.pt"
    res = subprocess.run(
        [sys.executable, "-c", code, str(pk), str(pt)], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = torch.load(pt, weights_only=True)
    want = convert.params_from_numpy(jax.tree.map(
        np.asarray, JS.load_params(REPO / "runs/mid_arith/params.pkl")))
    assert want["layers"]["wq"].dtype == torch.bfloat16
    assert _same_tree(loaded["p"], want)
    assert _same_tree(loaded["q"], want)
