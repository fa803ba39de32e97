"""StreamingLLM attention-sink cache (bounded window + sink tokens), PyTorch
port of ``gear_tpu/sink.py``.

The first ``num_sink`` tokens stay; the rest go to a ring of ``window``
slots. Keys are stored UNROTATED and rotated at attend time by their current
cache-relative position, so eviction is a plain overwrite of the ring slot.
Positions are cache-relative (StreamingLLM): sinks keep 0..num_sink-1, the
oldest token in the window gets num_sink, the newest the last position, and
the query takes the newest position. The length, the count of tokens ever
appended, is a host int here (an int32 scalar in the JAX cache).

``attend`` is plain torch on the card as on the CPU: in the reference it is
plain ``jnp`` outside any Pallas kernel, so there is no TPU kernel to port.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .models.llama import apply_rope, rope_cos_sin


@dataclass(frozen=True)
class SinkSpec:
    batch: int
    num_kv_heads: int
    head_dim: int
    num_sink: int = 4
    window: int = 252     # total capacity = num_sink + window
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def capacity(self) -> int:
        return self.num_sink + self.window


@dataclass
class SinkCache:
    k: torch.Tensor        # [B, H, cap, D] UNROTATED keys (a leading layer
    v: torch.Tensor        # axis if stacked)
    length: int = 0        # tokens ever appended

    def layer(self, i: int) -> "SinkCache":
        return SinkCache(k=self.k[i], v=self.v[i], length=self.length)

    def set_lengths(self, other: "SinkCache") -> None:
        self.length = other.length


def init(spec: SinkSpec, device=None) -> SinkCache:
    shape = (spec.batch, spec.num_kv_heads, spec.capacity, spec.head_dim)
    return SinkCache(k=torch.zeros(shape, dtype=spec.dtype, device=device),
                     v=torch.zeros(shape, dtype=spec.dtype, device=device))


def stack_layers(caches: list[SinkCache]) -> SinkCache:
    return SinkCache(k=torch.stack([c.k for c in caches]),
                     v=torch.stack([c.v for c in caches]),
                     length=caches[0].length)


def _slot_for(spec: SinkSpec, n: int) -> int:
    """Ring slot of the n-th appended token: sinks stay put, the window
    wraps."""
    ns, w = spec.num_sink, spec.window
    return n if n < ns else ns + (n - ns) % w


def append(spec: SinkSpec, c: SinkCache, k_unrot, v_new) -> SinkCache:
    """Append one token's UNROTATED K and V [B, H, 1, D], in place."""
    slot = _slot_for(spec, c.length)
    c.k[:, :, slot:slot + 1] = k_unrot.to(spec.dtype)
    c.v[:, :, slot:slot + 1] = v_new.to(spec.dtype)
    c.length += 1
    return c


def _relative_positions(spec: SinkSpec, length: int, device=None):
    """Cache-relative position [cap] int64 of each slot after ``length``
    appended tokens; -1 for an empty slot."""
    ns, w = spec.num_sink, spec.window
    slots = torch.arange(spec.capacity, device=device)
    n_win = min(max(length - ns, 0), w)         # tokens in the window
    newest_slot = ns + (max(length - ns, 1) - 1) % w
    age = (newest_slot - slots) % w             # 0 = newest
    win_pos = ns + n_win - 1 - age
    pos = torch.where(slots < ns, slots, win_pos)
    valid = torch.where(slots < ns, slots < length, age < n_win)
    return torch.where(valid, pos, torch.full_like(pos, -1))


def attend(spec: SinkSpec, c: SinkCache, q_unrot: torch.Tensor, *,
           sm_scale: float | None = None) -> torch.Tensor:
    """Decode attention, float32. q_unrot [B, Hq, 1, D] is rotated to the
    current cache-relative query position, the keys to their slots'
    positions. Returns [B, Hq, 1, D] in q's dtype."""
    b, hq, qn, d = q_unrot.shape
    hkv = spec.num_kv_heads
    gq = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    dev = q_unrot.device
    pos = _relative_positions(spec, c.length, dev)          # [cap]
    q_pos = min(c.length - 1, spec.capacity - 1)

    cosk, sink_ = rope_cos_sin(pos.clamp(min=0)[None].expand(b, -1), d,
                               spec.rope_theta)
    k_rot = apply_rope(c.k, cosk, sink_)
    cosq, sinq = rope_cos_sin(
        torch.full((b, 1), q_pos, dtype=torch.int64, device=dev), d,
        spec.rope_theta)
    q_rot = apply_rope(q_unrot, cosq, sinq)

    qf = q_rot.reshape(b, hkv, gq * qn, d).float()
    s = torch.einsum("bhqd,bhtd->bhqt", qf, k_rot.float()) * sm_scale
    s = s.masked_fill((pos < 0)[None, None, None, :], float("-inf"))
    w = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bhqt,bhtd->bhqd", w, c.v.float())
    return out.reshape(b, hq, qn, d).to(q_unrot.dtype)
