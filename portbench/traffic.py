"""Inputs of a run, made from its seed.

Every seed gets the same set of sizes in another order, so that the work a
run does does not change with the seed: lengths are spread evenly over
their range (the middles of ``n`` equal strata) and shuffled; token ids are
uniform over the vocabulary without the ids 0-2 (padding, BOS, EOS).
"""
from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of the seed for one named use (prompts, sampling)."""
    return np.random.default_rng([seed, sum(stream.encode())])


def even_lengths(lo: int, hi: int, n: int, r: np.random.Generator):
    """``n`` lengths evenly spread over [lo, hi], in the seed's order."""
    mids = lo + (np.arange(n) + 0.5) * (hi - lo) / n
    return [int(x) for x in r.permutation(np.round(mids).astype(int))]


def prompts(lengths, vocab: int, r: np.random.Generator):
    """Token lists of the given lengths."""
    return [r.integers(3, vocab, size=n).tolist() for n in lengths]


def left_pad(token_lists, to_len: int, pad_id: int = 0):
    """-> (tokens [B, to_len] int64, mask [B, to_len] int32) as numpy."""
    b = len(token_lists)
    tokens = np.full((b, to_len), pad_id, dtype=np.int64)
    mask = np.zeros((b, to_len), dtype=np.int32)
    for i, t in enumerate(token_lists):
        if len(t) > to_len:
            raise ValueError(f"prompt of {len(t)} tokens over {to_len}")
        tokens[i, to_len - len(t):] = t
        mask[i, to_len - len(t):] = 1
    return tokens, mask
