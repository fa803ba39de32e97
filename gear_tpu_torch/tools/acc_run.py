"""The accuracy protocol on the port: train a char-Llama on synthetic
arithmetic, then measure GSM8K-style CoT accuracy compressed against
uncompressed (the reference's result shape: Δ-accuracy against FP16 at a
config, evaluation_gsm8k.py:380-452). The port's counterpart of
``scripts/acc_run.py``, with the same protocol: zero-shot, greedy, batch 8,
48 new tokens, max_len 512, simulated mode, and the same matrix.

Usage (on the CUDA device; ``--cpu`` for the CPU):
  python3 gear_tpu_torch/tools/acc_run.py train [--scale tiny|mid] [--steps N]
  python3 gear_tpu_torch/tools/acc_run.py eval  [--scale tiny|mid] [--limit N]
                                                [--sweep]
  python3 gear_tpu_torch/tools/acc_run.py all

``eval`` reads the checkpoint, its model.json and its test.jsonl from
``runs/<scale>_arith/`` (the checkpoints the reference trained), ``all``
from what it has just trained; ``train`` writes params.pkl, model.json and
test.jsonl under ``--out``, and ``eval`` writes accuracy.json
(accuracy_sweep.json with ``--sweep``) there (default
``gear_tpu_torch/_build/<scale>_arith/``). Nothing is written under
``runs/``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The reference's two scales (scripts/acc_run.py SCALES).
SCALES = {
    "tiny": dict(vocab_size=96, hidden_size=256, intermediate_size=512,
                 num_layers=4, num_heads=8, num_kv_heads=4, head_dim=32,
                 max_position_embeddings=1024),
    "mid": dict(vocab_size=96, hidden_size=768, intermediate_size=2048,
                num_layers=8, num_heads=12, num_kv_heads=6, head_dim=64,
                max_position_embeddings=1024),
}
MAX_NEW_TOKENS = 48
MAX_LEN = 512
PROTOCOL = ("GSM8K-style CoT, zero-shot, greedy, last-number match "
            "(eval/harness.py); char-Llama trained on synthetic arithmetic "
            "(eval/synth.py)")


def ckpt_dir(scale: str) -> Path:
    return ROOT / "runs" / f"{scale}_arith"


def out_dir(scale: str) -> Path:
    return ROOT / "gear_tpu_torch" / "_build" / f"{scale}_arith"


def matrix(num_layers: int, sweep: bool = False) -> dict:
    """The reference's canonical matrix (run_template_llama2-13b.sh) at this
    scale: GEAR INT4 and INT2 with outliers, GEARL INT4, KIVI INT4, against
    NONE; ``sweep`` adds the INT2 root-cause configurations."""
    from gear_tpu_torch.config import CompressionConfig

    L = num_layers
    base = dict(num_layers=L, group_size=32, rank=2, prefill_rank=4,
                loop=3, streaming=True, streaming_gap=32)
    out = {
        "NONE": CompressionConfig(num_layers=L, compress_method="NONE"),
        "GEAR-int4": CompressionConfig(
            compress_method="GEAR", quantize_bit=4, left=0.02, **base),
        "GEARL-int4": CompressionConfig(
            compress_method="GEARL", quantize_bit=4, **base),
        "GEAR-int2": CompressionConfig(
            compress_method="GEAR", quantize_bit=2, left=0.02, **base),
        "KIVI-int4": CompressionConfig(
            compress_method="UNIFORM", quantize_bit=4, **base),
    }
    if sweep:
        g16 = dict(base, group_size=16)
        rank8 = dict(base, rank=8, prefill_rank=8)
        out.update({
            "KIVI-int2": CompressionConfig(
                compress_method="UNIFORM", quantize_bit=2, **base),
            "GEARL-int2": CompressionConfig(
                compress_method="GEARL", quantize_bit=2, **base),
            "GEAR-int2-left10": CompressionConfig(
                compress_method="GEAR", quantize_bit=2, left=0.10, **base),
            "GEAR-int2-left1.56": CompressionConfig(
                compress_method="GEAR", quantize_bit=2, left=0.015625,
                **base),
            "GEAR-int2-g16": CompressionConfig(
                compress_method="GEAR", quantize_bit=2, left=0.02, **g16),
            "GEAR-int2-rank8": CompressionConfig(
                compress_method="GEAR", quantize_bit=2, left=0.02, **rank8),
        })
    return out


def load_checkpoint(ckpt: Path, device=None):
    """-> (ModelConfig, params, test rows) from a checkpoint directory."""
    from gear_tpu_torch.eval import harness, synth
    from gear_tpu_torch.models import llama

    kw = json.loads((ckpt / "model.json").read_text())
    cfg = llama.ModelConfig(**kw)
    params = synth.load_params(ckpt / "params.pkl", device=device)
    return cfg, params, harness.load_jsonl(ckpt / "test.jsonl")


def evaluate(cfg, params, rows, comp, *, mode: str = "simulated",
             batch: int = 8, limit: int | None = None, device=None,
             init=None):
    """One configuration under the protocol -> (harness.EvalResult, the
    predictions in order)."""
    from gear_tpu_torch.engine import EngineConfig, InferenceEngine
    from gear_tpu_torch.eval import harness, synth

    eng = InferenceEngine(cfg, params, comp,
                          EngineConfig(max_len=MAX_LEN, mode=mode),
                          batch_size=batch, device=device)
    kw = {} if init is None else dict(init=init)
    gen = harness.engine_generate_fn(eng, synth.CharTokenizer(), **kw)
    preds = []

    def recording(prompts, max_new):
        outs = gen(prompts, max_new)
        for out in outs:
            out = out.split("Question:")[0]
            preds.append(harness.GSM8K.pred_fn(out))
        return outs

    res = harness.run_eval(harness.GSM8K, rows, recording,
                           few_shot_prompt="", batch_size=batch,
                           max_new_tokens=MAX_NEW_TOKENS, limit=limit)
    return res, preds


def do_train(args):
    import torch

    from gear_tpu_torch.eval import synth
    from gear_tpu_torch.models import llama

    device = "cpu" if args.cpu else None
    tok = synth.CharTokenizer()
    kw = dict(SCALES[args.scale])
    kw["vocab_size"] = max(kw["vocab_size"], tok.vocab_size)
    cfg = llama.ModelConfig(**kw)
    params = llama.init_params(cfg, seed=0, device=device)
    train_rows = synth.make_dataset(20000, seed=0)
    test_rows = synth.make_dataset(400, seed=999)
    out = Path(args.out)
    synth.write_jsonl(test_rows, out / "test.jsonl")
    t0 = time.time()
    params = synth.train(cfg, params, train_rows, tok,
                         synth.TrainSpec(steps=args.steps))
    if not args.cpu:
        torch.cuda.synchronize()
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s")
    synth.save_params(params, out / "params.pkl")
    (out / "model.json").write_text(json.dumps(kw))
    print(f"saved to {out}")


def do_eval(args, ckpt: Path):
    import torch

    device = "cpu" if args.cpu else None
    cfg, params, rows = load_checkpoint(ckpt, device=device)
    results = {}
    for name, comp in matrix(cfg.num_layers, args.sweep).items():
        t0 = time.time()
        res, _ = evaluate(cfg, params, rows, comp, batch=args.batch,
                          limit=args.limit, device=device)
        results[name] = res.to_json()
        print(f"{name}: acc {res.accuracy:.3f} ({res.correct}/{res.n}) in "
              f"{time.time() - t0:.0f}s", flush=True)
    none_acc = results["NONE"]["accuracy"]
    for r in results.values():
        r["delta_vs_none"] = round(r["accuracy"] - none_acc, 4)
    out = {
        "protocol": PROTOCOL,
        "model": json.loads((ckpt / "model.json").read_text()),
        "backend": ("cpu" if args.cpu
                    else torch.cuda.get_device_name(0)),
        "checkpoint": str(ckpt),
        "n": args.limit,
        "results": results,
    }
    path = Path(args.out) / ("accuracy_sweep.json" if args.sweep
                             else "accuracy.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=["train", "eval", "all"])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--limit", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="extra INT2 root-cause configs")
    ap.add_argument("--scale", choices=sorted(SCALES), default="tiny")
    ap.add_argument("--out", default=None,
                    help="output dir (default gear_tpu_torch/_build/"
                         "<scale>_arith)")
    args = ap.parse_args(argv)
    args.out = args.out or str(out_dir(args.scale))
    if Path(args.out).resolve().is_relative_to(ROOT / "runs"):
        raise SystemExit("acc_run writes nothing under runs/")
    if args.cmd in ("train", "all"):
        do_train(args)
    if args.cmd in ("eval", "all"):
        do_eval(args, Path(args.out) if args.cmd == "all"
                else ckpt_dir(args.scale))


if __name__ == "__main__":
    main()
