"""Synthetic GSM8K-style arithmetic: dataset, char tokenizer and a torch
trainer, the port of ``gear_tpu/eval/synth.py``.

The accuracy protocol of GEAR (GSM8K CoT accuracy, compressed against
uncompressed, evaluation_gsm8k.py:380-452) run end to end on a
character-level Llama trained on templated arithmetic word problems and
evaluated with the same harness (``eval.harness``: last-number extraction,
``#### N`` golds), with compression on and off.

The tokenizer, the dataset (stdlib ``random.Random``: the same seed gives
the same rows in both packages), the rendering and the batches (numpy rng)
are copies of the reference's. :func:`train` is optax's AdamW with its
warmup-cosine schedule, written out in torch. :func:`save_params` and
:func:`load_params` read and write the reference's checkpoint, a pickle of
numpy arrays whose bf16 leaves name ``ml_dtypes.bfloat16``, without
importing ``ml_dtypes``: a checkpoint written by either package loads in
the other.
"""
from __future__ import annotations

import importlib
import json
import math
import pickle
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device


# ---------------------------------------------------------------------------
# Char tokenizer (HF-tokenizer-compatible surface for eval.harness).
# ---------------------------------------------------------------------------

_VOCAB = (
    "\n !\"#$%&'()*+,-./0123456789:;<=>?"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
)


class CharTokenizer:
    """Byte-simple char tokenizer. id 0 = PAD, id 1 = UNK, chars from 2."""

    pad_token_id = 0
    unk_token_id = 1

    def __init__(self, vocab: str = _VOCAB):
        self.itos = ["<pad>", "<unk>"] + list(vocab)
        self.stoi = {c: i + 2 for i, c in enumerate(vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def encode(self, text: str) -> list[int]:
        return [self.stoi.get(c, 1) for c in text]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i < 2:
                if not skip_special_tokens:
                    out.append(self.itos[i])
                continue
            out.append(self.itos[i])
        return "".join(out)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

_NAMES = ["Tom", "Ann", "Sam", "Liz", "Max", "Joy", "Ben", "Eva"]
_ITEMS = ["apples", "coins", "books", "cards", "pens", "shells"]

_TEMPLATES = [
    # (question_fmt, cot_fn(a, b) -> (cot_text, answer))
    ("{n} has {a} {it}. {n} gets {b} more. How many {it} does {n} have now?",
     lambda a, b: (f"{a} + {b} = {a + b}.", a + b)),
    ("{n} has {a} {it}. {n} gives away {b}. How many {it} are left?",
     lambda a, b: (f"{a} - {b} = {a - b}.", a - b)),
    ("{n} has {a} bags with {b} {it} each. How many {it} in total?",
     lambda a, b: (f"{a} * {b} = {a * b}.", a * b)),
    ("{n} has {a} {it} and finds {b} more, then loses 3. How many now?",
     lambda a, b: (f"{a} + {b} = {a + b}. {a + b} - 3 = {a + b - 3}.",
                   a + b - 3)),
]


def make_problem(rng: random.Random) -> dict:
    t, cot_fn = _TEMPLATES[rng.randrange(len(_TEMPLATES))]
    name = _NAMES[rng.randrange(len(_NAMES))]
    item = _ITEMS[rng.randrange(len(_ITEMS))]
    # Small operand ranges: the model trained here is a 4-layer char LM; the
    # protocol needs a high uncompressed baseline accuracy so compression
    # deltas carry signal (not generalization difficulty).
    if "each" in t:
        a, b = rng.randint(2, 9), rng.randint(2, 9)
    else:
        a, b = rng.randint(4, 19), rng.randint(2, 9)
        if a < b:
            a, b = b, a
    q = t.format(n=name, a=a, b=b, it=item)
    cot, ans = cot_fn(a, b)
    return {"question": q,
            "answer": f"{cot} #### {ans}",
            "completion": f"{cot} The answer is {ans}\n"}


def make_dataset(n: int, seed: int = 0) -> list[dict]:
    rng = random.Random(seed)
    return [make_problem(rng) for _ in range(n)]


def write_jsonl(rows: list[dict], path: str | Path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


# The SAME template the eval harness prepends (harness.CoTTask default).
QUESTION_TEMPLATE = "Question: {q}\nLet's think step by step\n"


def render_example(row: dict) -> str:
    return QUESTION_TEMPLATE.format(q=row["question"]) + row["completion"]


# ---------------------------------------------------------------------------
# Trainer (next-token LM on the rendered examples)
# ---------------------------------------------------------------------------

@dataclass
class TrainSpec:
    seq_len: int = 160
    batch: int = 64
    steps: int = 1500
    lr: float = 1e-3
    warmup: int = 100
    seed: int = 0


def batches(rows, tok: CharTokenizer, spec: TrainSpec):
    """Yield (tokens [B,S], loss_mask [B,S]) forever; answer positions only
    are trained a bit harder by masking the question? — no: full-LM loss,
    simple and sufficient for this scale."""
    rng = np.random.default_rng(spec.seed)
    enc = [tok.encode(render_example(r))[: spec.seq_len] for r in rows]
    while True:
        idx = rng.integers(0, len(enc), spec.batch)
        x = np.zeros((spec.batch, spec.seq_len), np.int32)
        m = np.zeros((spec.batch, spec.seq_len), np.int32)
        for j, i in enumerate(idx):
            e = enc[i]
            x[j, : len(e)] = e
            m[j, : len(e)] = 1
        yield x, m


def lr_schedule(lr: float, warmup: int, decay_steps: int,
                end_value: float):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps,
    end_value): the step size at each update count, 0 at count 0, in
    float32 arithmetic as optax computes it."""
    f = np.float32
    alpha = f(end_value / lr if lr else 0.0)
    span = f(decay_steps - warmup)

    def sched(count: int) -> float:
        if count < warmup:  # linear from 0 to lr
            frac = f(1) - f(count) / f(warmup)
            return float(-f(lr) * frac + f(lr))
        t = min(f(count - warmup), span)
        cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * t / span))
        return float(f(lr) * ((f(1) - alpha) * cosine + alpha))

    return sched


def _flatten(tree: dict, prefix=()) -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flatten(v, prefix + (k,)) if isinstance(v, dict) else [
            (prefix + (k,), v)]
    return out


def _unflatten(items) -> dict:
    tree: dict = {}
    for path, v in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def masked_nll(logits: torch.Tensor, x: torch.Tensor, m: torch.Tensor):
    """Mean next-token negative log-likelihood over the non-pad targets,
    float32 log-softmax."""
    ll = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -ll.gather(-1, x[:, 1:, None])[..., 0]
    tmask = m[:, 1:].float()
    return (nll * tmask).sum() / tmask.sum()


def train(cfg, params: dict, rows, tok: CharTokenizer, spec: TrainSpec,
          log_every: int = 100, log=print, losses: list | None = None):
    """AdamW next-token training of a gear_tpu_torch llama on rendered
    examples, on the device the params lie on.

    The reference's optimizer, written out: ``optax.adamw(sched,
    weight_decay=0.01)`` (b1 0.9, b2 0.999, eps 1e-8) over every leaf, its
    moments in the parameters' dtype, with the warmup-cosine schedule
    :func:`lr_schedule` (step size 0 at the first update). Right-padded
    batches, loss over the non-pad next-token targets. Returns the trained
    params; ``losses``, when given, receives every step's loss.
    """
    from ..models import llama

    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
    warmup = min(spec.warmup, max(spec.steps // 10, 1))
    sched = lr_schedule(spec.lr, warmup, spec.steps + warmup, spec.lr * 0.1)
    items = _flatten(params)
    ps = [p.detach().clone().requires_grad_(True) for _, p in items]
    mus = [torch.zeros_like(p) for p in ps]
    nus = [torch.zeros_like(p) for p in ps]
    tree = _unflatten((path, p) for (path, _), p in zip(items, ps))
    dev = ps[0].device
    history = []
    it = batches(rows, tok, spec)
    for i in range(spec.steps):
        x, m = next(it)
        x = torch.from_numpy(x).to(dev, torch.int64)
        m = torch.from_numpy(m).to(dev)
        positions = torch.clamp(torch.cumsum(m, dim=1) - 1, min=0)
        logits, _ = llama.forward_prefill_grad(tree, cfg, x, positions, m)
        loss = masked_nll(logits, x, m)
        grads = torch.autograd.grad(loss, ps)
        count = torch.tensor(i + 1, dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        step = -sched(i)
        with torch.no_grad():
            for p, g, mu, nu in zip(ps, grads, mus, nus):
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                u = (mu / bc1.to(mu.dtype)) / (
                    torch.sqrt(nu / bc2.to(nu.dtype)) + eps)
                u = torch.tensor(step, dtype=p.dtype, device=dev) * (
                    u + wd * p)
                p.copy_((p + u).to(p.dtype))
        history.append(loss.detach())
        if log_every and (i % log_every == 0 or i == spec.steps - 1):
            log(f"step {i}: loss {float(history[-1]):.4f}")
    if losses is not None:
        losses.extend(torch.stack(history).tolist() if history else [])
    return _unflatten((path, p.detach()) for (path, _), p in zip(items, ps))


# ---------------------------------------------------------------------------
# Checkpoints: the reference's pickle of numpy arrays, without ml_dtypes
# ---------------------------------------------------------------------------

# bf16 leaves pickle as numpy does it: ``_reconstruct(ndarray, (0,), b'b')``
# and a state (1, shape, dtype, fortran, raw bytes) whose dtype is
# ``numpy.dtype(ml_dtypes.bfloat16, False, True)`` with the state below.
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _MlDtypes:
    """Pickles as ``importlib.import_module("ml_dtypes")``."""

    def __reduce__(self):
        return importlib.import_module, ("ml_dtypes",)


class _MlBf16:
    """Pickles as ``ml_dtypes.bfloat16`` (through getattr, so that writing
    needs no ml_dtypes)."""

    def __reduce__(self):
        return getattr, (_MlDtypes(), "bfloat16")


class _Bf16Dtype:
    """Pickles as numpy's bfloat16 dtype; unpickled, stands for it."""

    def __reduce__(self):
        return np.dtype, (_MlBf16(), False, True), _BF16_DTYPE_STATE

    def __setstate__(self, state):
        pass


class _Bf16Array:
    """A bf16 tensor's bytes, pickled as numpy pickles a bfloat16 array."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu().contiguous()
        self.shape = tuple(t.shape)
        self.raw = t.view(torch.int16).numpy().tobytes()

    def __reduce__(self):
        return (np.empty(0).__reduce__()[0], (np.ndarray, (0,), b"b"),
                (1, self.shape, _Bf16Dtype(), False, self.raw))


class _Leaf:
    """An array as the unpickler rebuilds it, before it becomes a tensor."""

    def __setstate__(self, state):
        _, self.shape, self.dtype, self.fortran, self.raw = state

    def tensor(self) -> torch.Tensor:
        bf16 = isinstance(self.dtype, _Bf16Dtype)
        a = np.frombuffer(self.raw, dtype=np.int16 if bf16 else self.dtype)
        a = a.reshape(self.shape, order="F" if self.fortran else "C")
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
        return t.view(torch.bfloat16) if bf16 else t


def _reconstruct(cls, shape, typecode):
    return _Leaf()


def _dtype(obj, align=False, copy=True):
    return _Bf16Dtype() if obj is _Bf16Dtype else np.dtype(obj, align, copy)


def _import_module(name):
    if name == "ml_dtypes":
        return _MlBf16Namespace
    return importlib.import_module(name)


class _MlBf16Namespace:
    bfloat16 = _Bf16Dtype


class _Unpickler(pickle.Unpickler):
    """Reads numpy arrays as :class:`_Leaf` and ``ml_dtypes.bfloat16`` as a
    stand-in, so that no ml_dtypes is needed."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Dtype
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if (module, name) == ("importlib", "import_module"):
            return _import_module
        if name == "_reconstruct" and module in ("numpy.core.multiarray",
                                                 "numpy._core.multiarray"):
            return _reconstruct
        return super().find_class(module, name)


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, _Leaf):
        return tree.tensor()
    raise TypeError(f"unexpected leaf {type(tree).__name__} in a checkpoint")


def save_params(params: dict, path: str | Path):
    """Write params (tensors or numpy arrays, the reference's layout) as the
    reference's pickle of numpy arrays; bf16 leaves name
    ``ml_dtypes.bfloat16``, as numpy writes them."""
    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                return _Bf16Array(x)
            return x.detach().cpu().numpy()
        return np.asarray(x)

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(leaf(params), f, protocol=4)


def load_params(path: str | Path, dtype: torch.dtype | None = None, *,
                device=None) -> dict:
    """Read a checkpoint of either package -> params in the port's layout
    (``convert.params_from_numpy``'s), bf16 leaves bit for bit, on
    ``device`` (default ``cuda``, raising without one). ``dtype`` casts the
    floating leaves."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        tree = _to_tensors(_Unpickler(f).load())

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return x.to(dev)

    return place(tree)
