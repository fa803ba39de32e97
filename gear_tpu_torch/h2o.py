"""H2O (Heavy-Hitter Oracle) KV-cache eviction, PyTorch port of
``gear_tpu/h2o.py``.

A fixed-budget cache: when full, it keeps the ``important`` positions with
the most accumulated attention plus the newest ``recent - 1`` positions and
evicts the rest, leaving one slot for the incoming token. Scores accumulate
per (batch, kv head, slot) as in the H2O paper (arXiv:2306.14048): the sum
of the attention probabilities each position has received, over the query
heads of its group.

As in the reference the cache holds one length for the whole batch; here it
is a host int (the JAX cache carries an int32 scalar), so the decision to
evict costs no device sync. :func:`append` and :func:`attend` update the
cache in place. Ties in the heavy-hitter vote go to the lower slot, as
``jax.lax.top_k`` gives them (``core.outliers.top_k_stable``).

``attend`` is plain torch on the card as on the CPU: in the reference it is
plain ``jnp`` outside any Pallas kernel, so there is no TPU kernel to port.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .core.outliers import top_k_stable


@dataclass(frozen=True)
class H2OSpec:
    batch: int
    num_kv_heads: int
    head_dim: int
    budget: int          # total kept positions (important + recent)
    important: int       # heavy-hitter slots
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.important >= self.budget - 1:
            raise ValueError("important must be < budget - 1")

    @property
    def recent(self) -> int:
        return self.budget - self.important


@dataclass
class H2OCache:
    k: torch.Tensor        # [B, H, budget, D] (a leading layer axis if stacked)
    v: torch.Tensor
    score: torch.Tensor    # [B, H, budget] f32 accumulated attention mass
    pos: torch.Tensor      # [B, H, budget] int32 original positions (-1 empty)
    length: int = 0        # valid slots

    def layer(self, i: int) -> "H2OCache":
        return H2OCache(k=self.k[i], v=self.v[i], score=self.score[i],
                        pos=self.pos[i], length=self.length)

    def set_lengths(self, other: "H2OCache") -> None:
        self.length = other.length


def init(spec: H2OSpec, device=None) -> H2OCache:
    b, h, d = spec.batch, spec.num_kv_heads, spec.head_dim
    return H2OCache(
        k=torch.zeros((b, h, spec.budget, d), dtype=spec.dtype, device=device),
        v=torch.zeros((b, h, spec.budget, d), dtype=spec.dtype, device=device),
        score=torch.zeros((b, h, spec.budget), dtype=torch.float32,
                          device=device),
        pos=torch.full((b, h, spec.budget), -1, dtype=torch.int32,
                       device=device),
    )


def stack_layers(caches: list[H2OCache]) -> H2OCache:
    return H2OCache(k=torch.stack([c.k for c in caches]),
                    v=torch.stack([c.v for c in caches]),
                    score=torch.stack([c.score for c in caches]),
                    pos=torch.stack([c.pos for c in caches]),
                    length=caches[0].length)


def _evict(spec: H2OSpec, c: H2OCache) -> H2OCache:
    """Keep the top ``important`` slots by score among the slots that are
    not among the newest ``recent - 1`` positions, and those newest ones;
    compact them left (heavy hitters first), in place. Runs when full."""
    nr, imp = spec.recent - 1, spec.important
    order = torch.argsort(c.pos, dim=-1, stable=True)  # ascending positions
    recent_idx = order[..., -nr:]                       # [B, H, nr]
    protect = torch.zeros(c.score.shape, dtype=torch.bool,
                          device=c.score.device)
    protect.scatter_(-1, recent_idx, True)
    masked = c.score.masked_fill(protect, float("-inf"))
    _, hh_idx = top_k_stable(masked, imp)               # [B, H, imp]
    keep = torch.cat([hh_idx, recent_idx], dim=-1)      # [B, H, budget - 1]
    kept = keep.shape[-1]
    idx_d = keep[..., None].expand(*keep.shape, spec.head_dim)
    k, v = c.k.gather(2, idx_d), c.v.gather(2, idx_d)
    score, pos = c.score.gather(-1, keep), c.pos.gather(-1, keep)
    c.k[:, :, :kept] = k
    c.v[:, :, :kept] = v
    c.score[..., :kept] = score
    c.pos[..., :kept] = pos
    c.k[:, :, kept:] = 0
    c.v[:, :, kept:] = 0
    c.score[..., kept:] = 0
    c.pos[..., kept:] = -1
    c.length = kept
    return c


def append(spec: H2OSpec, c: H2OCache, k_new, v_new, position) -> H2OCache:
    """Append one token's K/V [B, H, 1, D] at ``position`` (an int or [B]),
    evicting first when the cache is full; in place."""
    if c.length >= spec.budget:
        _evict(spec, c)
    i = c.length
    c.k[:, :, i:i + 1] = k_new.to(spec.dtype)
    c.v[:, :, i:i + 1] = v_new.to(spec.dtype)
    pos = torch.as_tensor(position, dtype=torch.int32, device=c.pos.device)
    c.pos[:, :, i] = pos.reshape(-1, 1).expand(spec.batch, spec.num_kv_heads)
    c.length = i + 1
    return c


def attend(spec: H2OSpec, c: H2OCache, q: torch.Tensor, *,
           sm_scale: float | None = None) -> torch.Tensor:
    """Decode attention of q [B, Hq, 1, D] over the kept positions, in
    float32; adds each slot's attention mass to its score (in place).
    Returns [B, Hq, 1, D] in q's dtype."""
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    gq = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = q.reshape(b, hkv, gq * qn, d).float()
    s = torch.einsum("bhqd,bhtd->bhqt", qf, c.k.float()) * sm_scale
    slots = torch.arange(spec.budget, device=q.device)
    valid = (slots < c.length)[None, None, None, :] & (c.pos >= 0)[:, :, None]
    s = s.masked_fill(~valid, float("-inf"))
    w = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bhqt,bhtd->bhqd", w, c.v.float())
    c.score += w.sum(dim=2)  # over the query heads of the group
    return out.reshape(b, hq, qn, d).to(q.dtype)
