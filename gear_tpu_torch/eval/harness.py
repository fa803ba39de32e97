"""CoT evaluation harness: GSM8K / BBH / AQuA against a gear_tpu_torch
engine.

A numpy-only copy of ``gear_tpu/eval/harness.py``: the same extraction
rules, tasks, runner and results files; :func:`engine_generate_fn` drives
the port's ``engine.InferenceEngine``.

Behavioral reference (semantics only):
  - reference: GenerationBench/GenerationTest/evaluation_gsm8k.py
      :63-82  answer extraction (last number regex), :280-330 flags,
      :463-529 left-padded batched greedy generate loop,
      :540-552 JSON results + accuracy logging
  - reference: evaluation_bbh_cot.py:26-58 task lists, :89 extract_ans
  - reference: evaluation_aqua_cot.py:221-242 option-letter extraction

Datasets and few-shot prompt files are read from local paths only (jsonl
for data, txt for prompts); the reference's HF-datasets loading is
replaced by `--data`.
"""
from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np


# ---------------------------------------------------------------------------
# Answer extraction
# ---------------------------------------------------------------------------

_NUMBER_RE = re.compile(r"\d*\.?\d+")


def extract_last_number(text: str) -> str | None:
    """Last number in the generation (reference evaluate_pred_answer,
    evaluation_gsm8k.py:63-82)."""
    nums = _NUMBER_RE.findall(text.replace(",", ""))
    return nums[-1] if nums else None


def extract_gold_gsm8k(answer_field: str) -> str:
    """GSM8K gold answers end with '#### <number>'."""
    if "####" in answer_field:
        answer_field = answer_field.split("####")[-1]
    num = extract_last_number(answer_field)
    return num if num is not None else answer_field.strip()


_OPTION_RE = re.compile(r"answer is[:\s]*\(?([A-E])\)?", re.IGNORECASE)


def extract_option_letter(text: str) -> str | None:
    """'the answer is (X)' extraction (reference aqua, :221-242)."""
    m = _OPTION_RE.search(text)
    if m:
        return m.group(1).upper()
    m2 = re.search(r"\(([A-E])\)", text)
    return m2.group(1).upper() if m2 else None


def numbers_equal(a: str | None, b: str | None) -> bool:
    if a is None or b is None:
        return False
    try:
        return abs(float(a) - float(b)) < 1e-4
    except ValueError:
        return a.strip() == b.strip()


# ---------------------------------------------------------------------------
# Task definitions
# ---------------------------------------------------------------------------

@dataclass
class CoTTask:
    name: str
    question_key: str
    answer_key: str
    gold_fn: Callable[[str], str | None]
    pred_fn: Callable[[str], str | None]
    match_fn: Callable[[str | None, str | None], bool]
    question_template: str = "Question: {q}\nLet's think step by step\n"

    def build_prompt(self, few_shot: str, question: str) -> str:
        return few_shot + self.question_template.format(q=question)


GSM8K = CoTTask(
    name="gsm8k", question_key="question", answer_key="answer",
    gold_fn=extract_gold_gsm8k, pred_fn=extract_last_number,
    match_fn=numbers_equal,
)

AQUA = CoTTask(
    name="aqua", question_key="question", answer_key="correct",
    gold_fn=lambda s: s.strip().upper()[:1],
    pred_fn=extract_option_letter,
    match_fn=lambda a, b: a is not None and a == b,
)


def bbh_task(name: str, multiple_choice: bool) -> CoTTask:
    """BBH tasks: 17 multiple-choice + 10 free-form
    (reference evaluation_bbh_cot.py:26-58)."""
    if multiple_choice:
        return CoTTask(
            name=f"bbh/{name}", question_key="input", answer_key="target",
            gold_fn=lambda s: re.sub(r"[()\s]", "", s).upper()[:1],
            pred_fn=extract_option_letter,
            match_fn=lambda a, b: a is not None and a == b,
        )
    return CoTTask(
        name=f"bbh/{name}", question_key="input", answer_key="target",
        gold_fn=lambda s: s.strip(),
        pred_fn=lambda s: s.split("answer is")[-1].strip().rstrip(".")
        if "answer is" in s else s.strip().split("\n")[0],
        match_fn=lambda a, b: a is not None and b is not None
        and a.lower() == b.lower(),
    )


BBH_MULTIPLE_CHOICE = [
    "temporal_sequences", "disambiguation_qa", "date_understanding",
    "tracking_shuffled_objects_three_objects", "penguins_in_a_table",
    "geometric_shapes", "snarks", "ruin_names",
    "tracking_shuffled_objects_seven_objects",
    "tracking_shuffled_objects_five_objects", "logical_deduction_three_objects",
    "hyperbaton", "logical_deduction_five_objects",
    "logical_deduction_seven_objects", "movie_recommendation",
    "salient_translation_error_detection", "reasoning_about_colored_objects",
]
BBH_FREE_FORM = [
    "multistep_arithmetic_two", "navigate", "dyck_languages", "word_sorting",
    "sports_understanding", "boolean_expressions", "object_counting",
    "formal_fallacies", "causal_judgement", "web_of_lies",
]


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

@dataclass
class EvalResult:
    task: str
    n: int
    correct: int
    accuracy: float
    wall_s: float
    samples: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "task": self.task, "n": self.n, "correct": self.correct,
            "accuracy": self.accuracy, "wall_s": self.wall_s,
        }


def load_jsonl(path: str | Path) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def run_eval(
    task: CoTTask,
    rows: list[dict],
    generate_fn: Callable[[list[str], int], list[str]],
    *,
    few_shot_prompt: str = "",
    batch_size: int = 8,
    max_new_tokens: int = 256,
    limit: int | None = None,
    keep_samples: int = 8,
    stop_at: str = "Question:",
) -> EvalResult:
    """Evaluate `task` over `rows` with a text-in/text-out generate function.

    ``generate_fn(prompts, max_new_tokens) -> completions`` abstracts the
    engine+tokenizer so the harness is model-agnostic (and unit-testable).
    Generations are truncated at the next few-shot boundary (``stop_at``),
    matching the reference's answer-window behavior.
    """
    if limit:
        rows = rows[:limit]
    t0 = time.time()
    correct = 0
    samples = []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i:i + batch_size]
        prompts = [
            task.build_prompt(few_shot_prompt, r[task.question_key])
            for r in chunk
        ]
        outs = generate_fn(prompts, max_new_tokens)
        for r, out in zip(chunk, outs):
            if stop_at and stop_at in out:
                out = out.split(stop_at)[0]
            pred = task.pred_fn(out)
            gold = task.gold_fn(str(r[task.answer_key]))
            ok = task.match_fn(pred, gold)
            correct += bool(ok)
            if len(samples) < keep_samples:
                samples.append({"pred": pred, "gold": gold, "ok": bool(ok),
                                "text": out[:500]})
    n = len(rows)
    return EvalResult(task.name, n, correct, correct / max(n, 1),
                      time.time() - t0, samples)


def engine_generate_fn(engine, tokenizer, **generate_kw):
    """Adapt (``engine.InferenceEngine``, HF or char tokenizer) into a text
    generate_fn. ``generate_kw`` goes to every ``engine.generate`` call (for
    one, ``init=`` to inject the power-iteration inits).

    Pads the batch to the engine's fixed batch size (reference pads with
    repeated rows, evaluation_gsm8k.py:463-529 uses left padding)."""
    def fn(prompts: list[str], max_new_tokens: int) -> list[str]:
        token_lists = [tokenizer.encode(p) for p in prompts]
        n = len(token_lists)
        while len(token_lists) < engine.batch:
            token_lists.append(token_lists[-1])
        outs = engine.generate(token_lists, max_new_tokens, **generate_kw)
        return [tokenizer.decode(o, skip_special_tokens=True)
                for o in outs[:n]]
    return fn


def write_results(results: list[EvalResult], out_dir: str | Path,
                  run_config: dict) -> Path:
    """Per-run JSON results + macro accuracy + TensorBoard scalars
    (reference evaluation_gsm8k.py:540-552 writes JSON and SummaryWriter
    scalars; bbh adds per-task scalars, evaluation_bbh_cot.py:441)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    macro = float(np.mean([r.accuracy for r in results])) if results else 0.0
    payload = {
        "config": run_config,
        "results": [r.to_json() for r in results],
        "macro_accuracy": macro,
        "samples": {r.task: r.samples for r in results},
    }
    path = out_dir / f"results_{int(time.time())}.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)

    from ..metrics import ScalarWriter

    with ScalarWriter(out_dir / "tb") as w:
        for r in results:
            w.scalar(f"accuracy/{r.task}", r.accuracy)
        w.scalar("accuracy/macro", macro)
    return path
