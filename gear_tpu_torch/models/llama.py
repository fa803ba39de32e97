"""Llama-family model with compressed-KV decode, PyTorch port of
``gear_tpu/models/llama.py`` (the fused, raw and simulated paths).

  * Parameters are a plain dict: ``embed``, ``final_norm``, ``lm_head`` and
    ``layers``, a dict of per-layer tensors stacked on a leading axis, in
    the JAX package's layout (``x @ W`` weights).
  * The layer loop is a Python loop (``lax.scan`` in JAX).
  * Weights stay in the model dtype; attention and quant math run in fp32.
  * Decode appends to the cache in place, then attends through
    ``kernels.decode.attend_fused`` (compressed cache) or
    ``kernels.flash.raw_attend_flash`` (raw bf16 cache): the CUDA kernels
    for tensors on the card, the plain ``cache.attend`` / :func:`raw_attend`
    on the CPU.
  * HF conventions: rotate-half RoPE, GQA head grouping, RMSNorm, SwiGLU.

The power-iteration inits can be injected with ``init(site, shape)``;
``site`` is ``("prefill", layer, which)`` in :func:`forward_prefill` and
``("decode", step, layer, which, comp_len)`` in :func:`forward_decode`
(``which`` is ``"k"`` or ``"v"``; ``comp_len`` is the layer's compressed
length before the flush). The serving paths use
``("serve_decode", slot, layer, which, comp_len)`` for a slot's flush
(:func:`forward_decode_paged` and the dense ``serving.ServingEngine``) and
``("serve_prefill", rid, layer, which)`` for a request's admission prefill.
Without ``init`` the inits are drawn from ``generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from .. import cache as kvcache
from ..cache import CacheSpec
from ..device import resolve_device
from ..kernels import decode as fused
from ..kernels import flash

InitFn = Callable[[tuple, tuple], torch.Tensor]


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    sliding_window: int | None = None  # Mistral-style; None = full attention
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """Small config for tests; GQA on by default to exercise grouping."""
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    max_position_embeddings=512)
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama2_7b(cls) -> "ModelConfig":
        return cls()

    @classmethod
    def llama2_13b(cls) -> "ModelConfig":
        return cls(hidden_size=5120, intermediate_size=13824, num_layers=40,
                   num_heads=40, num_kv_heads=40)

    @classmethod
    def llama2_70b(cls) -> "ModelConfig":
        return cls(hidden_size=8192, intermediate_size=28672, num_layers=80,
                   num_heads=64, num_kv_heads=8)

    @classmethod
    def llama3_8b(cls) -> "ModelConfig":
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8,
                   rope_theta=500000.0, max_position_embeddings=8192)

    @classmethod
    def from_hf(cls, cfg: dict) -> "ModelConfig":
        """Build from a HF config.json dict (LlamaConfig/MistralConfig keys)."""
        num_heads = cfg["num_attention_heads"]
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=cfg.get("num_key_value_heads", num_heads),
            head_dim=cfg.get("head_dim", cfg["hidden_size"] // num_heads),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            sliding_window=cfg.get("sliding_window"),
        )

    def cache_spec(self, batch: int, max_len: int, comp) -> CacheSpec:
        """CacheSpec for this model from a LayerCompressionConfig."""
        # In fused mode the method acts through two switches only, as in
        # the reference: names that start with GEAR but not GEARL carry
        # outliers (the `left` fraction of entries kept exact), names that
        # end in KCVT take whole-span K scales at prefill. (So OUTLIER, for
        # one, carries no outliers here.)
        ko = 0
        if comp.compress_method.startswith("GEAR") and \
                not comp.compress_method.startswith("GEARL"):
            ko = int(comp.left * comp.group_size * self.head_dim)
            ko -= ko % 2
        return CacheSpec(
            batch=batch,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            max_len=max_len,
            bits=comp.quantize_bit,
            group=comp.group_size,
            rank=comp.rank,
            prefill_rank=comp.prefill_rank,
            rank_v=comp.rankv,
            prefill_rank_v=comp.prefill_rankv,
            lowrank_loop=comp.loop,
            outliers_per_block=ko,
            kcvt_prefill=comp.compress_method.endswith("KCVT"),
            dtype=self.dtype,
            sideband_dtype=self.dtype,
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random init from a seeded ``torch.Generator`` on ``device`` (for tests
    and benchmarks; real weights via models.loader)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e, f, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def init(*shape, scale):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * scale).to(dt)

    params = {
        "embed": init(cfg.vocab_size, e, scale=0.02),
        "layers": {
            "attn_norm": torch.ones((l, e), dtype=dt, device=dev),
            "mlp_norm": torch.ones((l, e), dtype=dt, device=dev),
            "wq": init(l, e, hq * dh, scale=e ** -0.5),
            "wk": init(l, e, hkv * dh, scale=e ** -0.5),
            "wv": init(l, e, hkv * dh, scale=e ** -0.5),
            "wo": init(l, hq * dh, e, scale=(hq * dh) ** -0.5),
            "wg": init(l, e, f, scale=e ** -0.5),
            "wu": init(l, e, f, scale=e ** -0.5),
            "wd": init(l, f, e, scale=f ** -0.5),
        },
        "final_norm": torch.ones((e,), dtype=dt, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(e, cfg.vocab_size, scale=e ** -0.5)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin [B, S, head_dim] for HF rotate-half RoPE."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half * 2
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B,H,S,D]; cos/sin [B,S,D]. HF convention: x*cos + rotate_half(x)*sin."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[:, None] + rot.float() * sin[:, None]).to(x.dtype)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def causal_attention(q, k, v, attn_mask, sliding_window=None, *,
                     blockwise_threshold: int = 2048) -> torch.Tensor:
    """Full prefill attention. q [B,Hq,S,D], k/v [B,Hkv,S,D] (GQA grouped),
    attn_mask [B,S] 1=valid. fp32 softmax. Prompts over
    ``blockwise_threshold`` tokens run blockwise (online softmax over KV
    chunks), so memory stays O(S * chunk)."""
    b, hq, s, d = q.shape
    if s > blockwise_threshold:
        return _causal_attention_blockwise(q, k, v, attn_mask, sliding_window)
    hkv = k.shape[1]
    gq = hq // hkv
    qg = q.reshape(b, hkv, gq, s, d).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (d ** -0.5)
    ii = torch.arange(s, device=q.device)
    mask = ii[:, None] >= ii[None, :]
    if sliding_window is not None:
        mask = mask & (ii[:, None] - ii[None, :] < sliding_window)
    mask = mask[None, None, None]
    if attn_mask is not None:
        mask = mask & attn_mask[:, None, None, None, :].bool()
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)  # fully-masked rows (left padding)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def _causal_attention_blockwise(q, k, v, attn_mask, sliding_window=None,
                                chunk: int = 512) -> torch.Tensor:
    """Flash-style prefill: loop over KV chunks, online-softmax merge."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    gq = hq // hkv
    ck = chunk
    while s % ck:
        ck //= 2
    qg = q.reshape(b, hkv, gq, s, d).float() * (d ** -0.5)
    qpos = torch.arange(s, device=q.device)
    acc = torch.zeros((b, hkv, gq, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, gq, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, gq, s), dtype=torch.float32, device=q.device)
    for j in range(s // ck):
        sl = slice(j * ck, (j + 1) * ck)
        kj, vj = k[:, :, sl].float(), v[:, :, sl].float()
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kj)
        kpos = qpos[sl]
        msk = qpos[:, None] >= kpos[None, :]
        if sliding_window is not None:
            msk = msk & (qpos[:, None] - kpos[None, :] < sliding_window)
        msk = msk[None, None, None]
        if attn_mask is not None:
            msk = msk & attn_mask[:, sl].bool()[:, None, None, None, :]
        scores = scores.masked_fill(~msk, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]).masked_fill(~msk, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)


def mlp_block(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def _layer_slice(layers: dict, idx: int) -> dict:
    return {k: v[idx] for k, v in layers.items()}


def _qkv(cfg: ModelConfig, lp: dict, h, cos, sin):
    x = rmsnorm(h, lp["attn_norm"], cfg.rms_eps)
    q = _split_heads(x @ lp["wq"], cfg.num_heads, cfg.head_dim)
    k = _split_heads(x @ lp["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(x @ lp["wv"], cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_layer(cfg: ModelConfig, lp: dict, h, attn):
    b, s = h.shape[:2]
    h = h + attn.transpose(1, 2).reshape(b, s, -1) @ lp["wo"]
    x2 = rmsnorm(h, lp["mlp_norm"], cfg.rms_eps)
    return h + mlp_block(x2, lp["wg"], lp["wu"], lp["wd"])


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, attn_mask: torch.Tensor,
                    spec: CacheSpec | None, *, compress: bool = True,
                    init: InitFn | None = None,
                    generator: torch.Generator | None = None,
                    use_lowrank: bool = True, kv_hook=None):
    """Run the prompt, return (logits [B,S,V] f32, caches).

    With ``spec`` and ``compress``, each layer's KV is compressed into a
    two-tier LayerCache (prefill block at prefill_rank + residual tail), and
    the layers are stacked. With ``compress=False`` a stacked
    RawLayerCache is built (the bf16 baseline); with no ``spec`` the stacked
    (k, v) pair.

    ``kv_hook(layer, k, v) -> (k, v)`` runs after RoPE and BEFORE the prompt
    attention (the simulated mode's compression): the prompt's logits see
    the hooked K/V, and they are what gets cached.
    """
    h = params["embed"][tokens].to(cfg.dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        if kv_hook is not None:
            k, v = kv_hook(i, k, v)
        attn = causal_attention(q, k, v, attn_mask, cfg.sliding_window)
        h = _finish_layer(cfg, lp, h, attn)
        if spec is None:
            caches.append((k, v))
        elif compress:
            p0 = None if init is None else (
                lambda which, shape, i=i: init(("prefill", i, which), shape))
            caches.append(kvcache.prefill(spec, k, v, p0=p0,
                                          generator=generator,
                                          use_lowrank=use_lowrank))
        else:
            caches.append(raw_prefill(spec, k, v))
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = logits_from_hidden(params, cfg, h)
    if spec is None:
        return logits, (torch.stack([c[0] for c in caches]),
                        torch.stack([c[1] for c in caches]))
    if compress:
        return logits, kvcache.stack_layers(caches)
    return logits, raw_stack(caches)


@torch.no_grad()
def forward_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                   position: torch.Tensor, caches, *, spec: CacheSpec,
                   compress: bool = True,
                   pad_start: torch.Tensor | None = None,
                   init: InitFn | None = None,
                   generator: torch.Generator | None = None, step: int = 0,
                   use_lowrank: bool = True):
    """One decode step: append KV (in place), attend over the whole cache.

    token/position [B]; ``caches`` is the stacked cache from
    :func:`forward_prefill` and is updated in place and returned, with the
    logits [B, V] f32. ``step`` only labels the init sites.
    """
    h = params["embed"][token].to(cfg.dtype)[:, None]
    cos, sin = rope_cos_sin(position[:, None], cfg.head_dim, cfg.rope_theta)
    lc = None
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        lc = caches.layer(i)
        if compress:
            p0 = None if init is None else (
                lambda which, shape, i=i, c=lc.comp_len:
                init(("decode", step, i, which, c), shape))
            kvcache.append(spec, lc, k, v, p0=p0, generator=generator,
                           use_lowrank=use_lowrank)
            attn = fused.attend_fused(spec, lc, q, pad_start=pad_start,
                                      window=cfg.sliding_window)
        else:
            raw_append(spec, lc, k, v)
            attn = flash.raw_attend_flash(spec, lc, q, pad_start=pad_start,
                                          window=cfg.sliding_window)
        h = _finish_layer(cfg, lp, h, attn)
    caches.set_lengths(lc)
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return logits_from_hidden(params, cfg, h)[:, 0], caches


@torch.no_grad()
def forward_decode_paged(params: dict, cfg: ModelConfig, token: torch.Tensor,
                         position: torch.Tensor, pools, seqs, *, pspec,
                         pad_start: torch.Tensor | None = None,
                         init: InitFn | None = None,
                         generator: torch.Generator | None = None,
                         live=None, live_dev: torch.Tensor | None = None):
    """One decode step over paged caches with per-sequence lengths: every
    slot masks by its own comp_len / resid_len, so slots of different ages
    decode in one forward pass.

    token/position [B] (B = serving slots); ``pools`` is a ``paged.PagePool``
    and ``seqs`` a ``paged.PagedSeqs`` whose residual tiers carry a leading
    layer axis. Both are updated in place and returned after the logits
    [B, V] f32. The lengths advance once per step (all layers share them).
    ``live`` (host bools; ``live_dev`` the same mask on the device) parks
    slots: a parked slot neither appends nor flushes. Attention goes through
    ``kernels.decode.attend_paged``: the paged CUDA kernel for tensors on
    the card, ``paged.attend_gathered`` on the CPU.
    """
    from .. import paged

    h = params["embed"][token].to(cfg.dtype)[:, None]
    cos, sin = rope_cos_sin(position[:, None], cfg.head_dim, cfg.rope_theta)
    plan = paged.plan_append(pspec, seqs, live, live_dev=live_dev)
    comp_before = {row: comp for row, comp, _, _ in plan.flushes}
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        lpool, lseqs = pools.layer(i), seqs.layer(i)
        p0 = None if init is None else (
            lambda row, which, shape, i=i:
            init(("serve_decode", row, i, which, comp_before[row]), shape))
        paged.apply_append(pspec, lpool, lseqs, k, v, plan, p0=p0,
                           generator=generator)
        attn = fused.attend_paged(pspec, lpool, lseqs, q, pad_start=pad_start,
                                  window=cfg.sliding_window)
        h = _finish_layer(cfg, lp, h, attn)
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return logits_from_hidden(params, cfg, h)[:, 0], pools, seqs


def logits_from_hidden(params: dict, cfg: ModelConfig, h: torch.Tensor):
    w = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return h.float() @ w.float()


# ---------------------------------------------------------------------------
# Uncompressed baseline cache (bf16) — for accuracy and speed baselines.
# ---------------------------------------------------------------------------

@dataclass
class RawLayerCache:
    k: torch.Tensor        # [B, H, max_len, D] (a leading layer axis if stacked)
    v: torch.Tensor
    length: int = 0

    def layer(self, i: int) -> "RawLayerCache":
        return RawLayerCache(k=self.k[i], v=self.v[i], length=self.length)

    def set_lengths(self, other: "RawLayerCache") -> None:
        self.length = other.length


def raw_init(spec: CacheSpec, device=None) -> RawLayerCache:
    shape = (spec.batch, spec.num_kv_heads, spec.max_len, spec.head_dim)
    return RawLayerCache(k=torch.zeros(shape, dtype=spec.dtype, device=device),
                         v=torch.zeros(shape, dtype=spec.dtype, device=device))


def raw_prefill(spec: CacheSpec, k: torch.Tensor, v: torch.Tensor):
    c = raw_init(spec, device=k.device)
    s = k.shape[2]
    c.k[:, :, :s] = k
    c.v[:, :, :s] = v
    c.length = s
    return c


def raw_append(spec: CacheSpec, c: RawLayerCache, k_new, v_new):
    """Append [B,H,n,D] in place."""
    n = k_new.shape[2]
    if c.length + n > spec.max_len:
        raise ValueError(f"raw cache full at max_len {spec.max_len}")
    c.k[:, :, c.length:c.length + n] = k_new
    c.v[:, :, c.length:c.length + n] = v_new
    c.length += n
    return c


def raw_stack(caches: list[RawLayerCache]) -> RawLayerCache:
    return RawLayerCache(k=torch.stack([c.k for c in caches]),
                         v=torch.stack([c.v for c in caches]),
                         length=caches[0].length)


def raw_attend(spec: CacheSpec, c: RawLayerCache, q: torch.Tensor, *,
               sm_scale: float | None = None,
               pad_start: torch.Tensor | None = None,
               window: int | None = None) -> torch.Tensor:
    """Decode attention of q [B,Hq,Qn,D] over the raw cache in float32: the
    plain version of the flash-decode kernel (``kernels.flash``) and the CPU
    path. Tokens ``max(pad_start, length - window) <= t < length`` count."""
    b, hq, qn, d = q.shape
    hkv = spec.num_kv_heads
    gq = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qg = q.reshape(b, hkv, gq * qn, d).float()
    scores = torch.einsum("bhqd,bhtd->bhqt", qg, c.k.float()) * sm_scale
    pos = torch.arange(spec.max_len, device=q.device)
    valid = (pos < c.length)[None, None, None, :]
    if pad_start is not None:
        valid = valid & (pos[None, :] >= pad_start[:, None])[:, None, None, :]
    if window is not None:
        valid = valid & (pos >= c.length - window)[None, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqt,bhtd->bhqd", w, c.v.float())
    return out.reshape(b, hq, qn, d).to(q.dtype)
