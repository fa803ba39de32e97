"""The power-iteration starts, drawn from the seed and handed to both sides.

The port's model passes ask ``init(site, shape)`` for the start of each
low-rank fit (``site`` names the pass, the layer, K or V and, at a flush,
the step and the compressed length). Each start is uniform [0, 1), drawn
by a generator seeded from the run's seed and the site, so the same site
gets the same start in every replay of a run and in the reference, which
reads the rows it checks from the same tensor. Starts are kept once drawn.
"""
from __future__ import annotations

import hashlib

import torch


class Inits:
    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = device
        self.bank: dict = {}

    def __call__(self, site: tuple, shape: tuple) -> torch.Tensor:
        key = (site, tuple(shape))
        t = self.bank.get(key)
        if t is None:
            h = hashlib.sha256(repr((self.seed, site)).encode()).digest()
            gen = torch.Generator(device=self.device).manual_seed(
                int.from_bytes(h[:8], "little") >> 1)
            t = torch.rand(shape, generator=gen, device=self.device)
            self.bank[key] = t
        return t

    def for_rows(self, rows, batch: int, heads: int, dim: int, fmt):
        """The reference's view, ``site -> start`` of the given rows: the
        start the program is handed for that site at the whole batch's
        shape ([batch, heads, dim, rank], the rank of the prompt pass or of
        a flush as ``fmt`` sets them)."""
        def get(site):
            rank = fmt.prefill_rank if site[0] == "prefill" else fmt.rank
            return self(site, (batch, heads, dim, rank))[rows]
        return get
