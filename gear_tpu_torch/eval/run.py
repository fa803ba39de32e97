"""CLI entry for CoT accuracy evals on a local model + local datasets, the
port of ``gear_tpu/eval/run.py`` (the same flags and defaults); it runs on
the CUDA device.

Usage (mirrors the reference's run templates, run_template_llama2-13b.sh):

  python -m gear_tpu_torch.eval.run \
    --model /path/to/llama-2-7b --task gsm8k --data /path/to/gsm8k_test.jsonl \
    --prompt_file /path/to/gsm8k_prompt.txt \
    --compress_method GEAR --quantize_bit 2 --group_size 64 --loop 3 \
    --prefill_rank 4 --rank 2 --left 0.02 --streaming --streaming_gap 64 \
    --batch_size 8 --max_new_tokens 256 --out_dir runs/

Flag set mirrors evaluation_gsm8k.py:280-330 (reference semantics; see
gear_tpu_torch/eval/harness.py for extraction rules).
"""
from __future__ import annotations

import argparse
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
# The vendored reference few-shot prompts (reference:
# GenerationTest/lib_prompt/) are text files kept once in the repository,
# beside the JAX package's eval; they are read from disk by path, never
# imported.
LIB_PROMPT = _ROOT / "gear_tpu" / "eval" / "lib_prompt"
TINY_MODEL = _ROOT / "runs" / "tiny_arith_hf"

# default few-shot prompt per task (reference: evaluation_gsm8k.py prompt_file
# flag pointing at lib_prompt/gsm8k_prompt_original.txt; aqua 8-shot;
# bbh per-task dir)
DEFAULT_PROMPT = {
    "gsm8k": LIB_PROMPT / "gsm8k_prompt_original.txt",
    "aqua": LIB_PROMPT / "aqua" / "cot_prompt_8shots.txt",
    "bbh": LIB_PROMPT,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gear_tpu_torch CoT evaluation")
    p.add_argument("--model", default=str(TINY_MODEL),
                   help="local HF checkpoint dir (default: the vendored "
                        "tiny_arith smoke checkpoint)")
    p.add_argument("--task", default="gsm8k",
                   choices=["gsm8k", "aqua", "bbh"])
    p.add_argument("--bbh_task", default=None,
                   help="single BBH subtask (default: all)")
    p.add_argument("--data", default=None,
                   help="jsonl dataset path (or dir of per-task jsonl for "
                        "bbh); default: <model>/<task>_test.jsonl")
    p.add_argument("--prompt_file", default=None,
                   help="few-shot CoT prompt text file (or dir for bbh); "
                        "pass 'auto' for the vendored lib_prompt asset "
                        "for --task (reference few-shot prompts)")
    p.add_argument("--zero_shot", action="store_true")
    # compression knobs (reference evaluation_gsm8k.py:280-330)
    p.add_argument("--compress_method", default="NONE")
    p.add_argument("--quantize_bit", type=int, default=4)
    p.add_argument("--group_size", type=int, default=64)
    p.add_argument("--rank", type=int, default=2)
    p.add_argument("--rankv", type=int, default=None)
    p.add_argument("--prefill_rank", type=int, default=4)
    p.add_argument("--prefill_rankv", type=int, default=None)
    p.add_argument("--loop", type=int, default=3)
    p.add_argument("--left", type=float, default=0.02)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--streaming_gap", type=int, default=64)
    p.add_argument("--stream_grouping", action="store_true")
    # engine knobs
    p.add_argument("--mode", default="simulated",
                   choices=["simulated", "fused", "raw"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out_dir", default="runs")
    return p


def _resolve_tokenizer(model_dir: str):
    """AutoTokenizer when the checkpoint ships HF tokenizer files; the char
    tokenizer for checkpoints marked "gear_tpu_tokenizer": "char" (the
    vendored tiny_arith smoke model)."""
    import json as _json
    cfg_path = Path(model_dir) / "config.json"
    if cfg_path.exists():
        hf_cfg = _json.loads(cfg_path.read_text())
        if hf_cfg.get("gear_tpu_tokenizer") == "char":
            from .synth import CharTokenizer
            return CharTokenizer()
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(model_dir)


def main(argv=None, *, device=None):
    """Run the evaluation the flags describe; ``device`` (not a flag)
    defaults to ``cuda`` and raises without a CUDA device."""
    args = build_parser().parse_args(argv)

    from ..config import CompressionConfig
    from ..engine import EngineConfig, InferenceEngine
    from ..models import loader
    from . import harness

    if args.data is None:
        args.data = str(Path(args.model) / f"{args.task}_test.jsonl")
    if args.prompt_file == "auto":
        args.prompt_file = str(DEFAULT_PROMPT[args.task])

    cfg, params = loader.load_params(args.model, device=device)
    comp = CompressionConfig(
        num_layers=cfg.num_layers,
        compress_method=args.compress_method,
        quantize_bit=args.quantize_bit,
        group_size=args.group_size,
        rank=args.rank, rankv=args.rankv or args.rank,
        prefill_rank=args.prefill_rank,
        prefill_rankv=args.prefill_rankv or args.prefill_rank,
        loop=args.loop, left=args.left,
        streaming=args.streaming, streaming_gap=args.streaming_gap,
        stream_grouping=args.stream_grouping,
        residual_length=args.group_size,
    )
    tokenizer = _resolve_tokenizer(args.model)
    ecfg = EngineConfig(max_len=args.max_len, mode=args.mode,
                        eos_token_id=getattr(tokenizer, "eos_token_id", None),
                        pad_token_id=getattr(tokenizer, "pad_token_id", 0)
                        or 0)
    engine = InferenceEngine(cfg, params, comp, ecfg,
                             batch_size=args.batch_size, device=device)
    gen = harness.engine_generate_fn(engine, tokenizer)

    few_shot = ""
    if args.prompt_file and not args.zero_shot and args.task != "bbh":
        few_shot = Path(args.prompt_file).read_text()

    results = []
    if args.task == "gsm8k":
        rows = harness.load_jsonl(args.data)
        results.append(harness.run_eval(
            harness.GSM8K, rows, gen, few_shot_prompt=few_shot,
            batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
            limit=args.limit))
    elif args.task == "aqua":
        rows = harness.load_jsonl(args.data)
        results.append(harness.run_eval(
            harness.AQUA, rows, gen, few_shot_prompt=few_shot,
            batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
            limit=args.limit))
    else:  # bbh
        names = ([args.bbh_task] if args.bbh_task else
                 harness.BBH_MULTIPLE_CHOICE + harness.BBH_FREE_FORM)
        for name in names:
            rows = harness.load_jsonl(Path(args.data) / f"{name}.jsonl")
            fs = ""
            if args.prompt_file and not args.zero_shot:
                fs = (Path(args.prompt_file) / f"{name}.txt").read_text()
            task = harness.bbh_task(
                name, name in harness.BBH_MULTIPLE_CHOICE)
            results.append(harness.run_eval(
                task, rows, gen, few_shot_prompt=fs,
                batch_size=args.batch_size,
                max_new_tokens=args.max_new_tokens, limit=args.limit))

    out = harness.write_results(results, args.out_dir, vars(args))
    for r in results:
        print(f"{r.task}: {r.accuracy:.4f} ({r.correct}/{r.n})")
    print(f"results -> {out}")


if __name__ == "__main__":
    main()
