"""The plain reference of the benchmark's decoder models, in float32.

Mistral-7B (GQA, the published rotate-half RoPE, RMSNorm, SwiGLU, sliding
window), read from the configuration's Hugging Face keys. It imports
nothing of the program: the weights are the benchmark's own inputs
(``portbench.weights``), cast to float32 a layer at a time, and GEAR's
compression is worked out by ``reference.gear``.

:func:`forward` runs rows teacher-forced over their left-padded prompt and
the tokens the program served, one layer at a time over the whole
sequence, and returns the logits at the positions that produced those
tokens. The cache it attends is the cell's:

  * ``raw``: every earlier token's exact K/V (past the padding, inside the
    window);
  * ``gear``: the prompt attends its exact K/V; then the prompt's whole
    groups are compressed (at the prefill rank), the decode tokens stay raw
    until ``group`` of them gather and are compressed as one block (at the
    decode rank) before the step that completed the block attends; a
    decode token attends the compressed prefix, read back, and the raw
    tokens after it.

``precision="fp8"`` is the control: every weight product takes float8
(e4m3) operands, the weight scaled per tensor and the activations per row;
the rest stays float32.

Power-iteration starts come from ``inits(site, rows)``, with the sites the
port's model passes name: ``("prefill", layer, which)`` and ``("decode",
step, layer, which, compressed_len_before)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import gear

FP8_MAX = 448.0
Q_CHUNK = 512  # prompt queries per attention block


def rope_inv_freq(theta: float, head_dim: int, device=None) -> torch.Tensor:
    """The published rotate-half RoPE's frequencies, theta ** (-2i / D) for
    i < D / 2 (Hugging Face's ``inv_freq``)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                         dtype=torch.float32) / head_dim))


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """x through float8 e4m3 with an absmax scale over ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _lin(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, (-2, -1))
    return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _attend(q, k, v, q_idx, k_idx, pad_start, window):
    """q [n,Hq,m,D] at slots ``q_idx`` [m] over k/v [n,Hkv,L,D] at slots
    ``k_idx`` [L]: causal, past ``pad_start`` [n], inside ``window``."""
    n, hq, m, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(n, hkv, hq // hkv, m, d)
    scores = torch.einsum("nhgmd,nhld->nhgml", qg, k) / math.sqrt(d)
    ok = k_idx[None, :] <= q_idx[:, None]
    if window is not None:
        ok = ok & (q_idx[:, None] - k_idx[None, :] < window)
    ok = ok[None] & (k_idx[None, None, :] >= pad_start[:, None, None])
    scores = scores.masked_fill(~ok[:, None, None], float("-inf"))
    w = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    return torch.einsum("nhgml,nhld->nhgmd", w, v).reshape(n, hq, m, d)


def _prompt_attention(q, k, v, pad_start, window):
    s = q.shape[2]
    idx = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for a in range(0, s, Q_CHUNK):
        b = min(a + Q_CHUNK, s)
        hi = b  # keys after the chunk's last query are masked anyway
        out[:, :, a:b] = _attend(q[:, :, a:b], k[:, :, :hi], v[:, :, :hi],
                                 idx[a:b], idx[:hi], pad_start, window)
    return out


def _gear_decode(q, k, v, s, layer, pad_start, window, fmt, loop, inits,
                 dtype):
    """Attention of the decode tokens (slots ``s`` ..) over the compressed
    cache, compressing as the program's cache does. q/k/v [n,H,s+T,D] over
    the whole sequence; returns [n,Hq,T,D]."""
    n, hq, total, d = q.shape
    g = fmt.group
    dev = q.device
    comp = (s // g) * g
    kh = torch.empty_like(k[:, :, :comp + ((total - comp) // g) * g])
    vh = torch.empty_like(kh)
    if comp:
        kh[:, :, :comp] = gear.compress(
            k[:, :, :comp], "k", fmt, fmt.prefill_rank, loop,
            inits(("prefill", layer, "k")), dtype)
        vh[:, :, :comp] = gear.compress(
            v[:, :, :comp], "v", fmt, fmt.prefill_rank, loop,
            inits(("prefill", layer, "v")), dtype)
    out = torch.empty_like(q[:, :, s:])
    idx = torch.arange(total, device=dev)
    j, steps = 0, total - s
    while j < steps:
        flush_j = comp + g - s - 1  # the step whose append fills the tier
        end = min(flush_j, steps)
        if end > j:
            keys = torch.cat([kh[:, :, :comp], k[:, :, comp:s + end]], 2)
            vals = torch.cat([vh[:, :, :comp], v[:, :, comp:s + end]], 2)
            out[:, :, j:end] = _attend(q[:, :, s + j:s + end], keys, vals,
                                       idx[s + j:s + end], idx[:s + end],
                                       pad_start, window)
        if flush_j >= steps:
            break
        site = ("decode", flush_j, layer)
        blk = slice(comp, comp + g)
        kh[:, :, blk] = gear.compress(k[:, :, blk], "k", fmt, fmt.rank,
                                      loop, inits((*site, "k", comp)), dtype)
        vh[:, :, blk] = gear.compress(v[:, :, blk], "v", fmt, fmt.rank,
                                      loop, inits((*site, "v", comp)), dtype)
        comp += g
        t = s + flush_j
        out[:, :, flush_j:flush_j + 1] = _attend(
            q[:, :, t:t + 1], kh[:, :, :comp], vh[:, :, :comp],
            idx[t:t + 1], idx[:comp], pad_start, window)
        j = flush_j + 1
    return out


@torch.no_grad()
def forward(weights: dict, hf: dict, tokens: torch.Tensor,
            mask: torch.Tensor, cache: str, fmt=None, loop: int = 3,
            inits=None, precision: str = "fp32"):
    """Teacher-forced logits of rows ``tokens`` [n, S + T] (the left-padded
    prompt bucket, then the T decode tokens fed), ``mask`` [n, S] the
    prompt's real tokens; ``cache`` "raw" or "gear" (``fmt`` its
    ``counts.KVFormat``, ``loop`` its power-iteration rounds, ``inits`` its
    starts). -> logits [n, T + 1, V] float32 at slots S - 1 .. S + T - 1."""
    if tokens.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n, total = tokens.shape
    s = mask.shape[1]
    e = hf["hidden_size"]
    hq = hf["num_attention_heads"]
    hkv = hf.get("num_key_value_heads", hq)
    d = hf.get("head_dim") or e // hq
    eps = hf.get("rms_norm_eps", 1e-5)
    window = hf.get("sliding_window")
    dev = tokens.device
    lw_all = weights["layers"]

    mask = mask.to(dev)
    plen = mask.sum(1)
    pad_start = (s - plen).to(torch.int64)
    pos = torch.cat([torch.clamp(torch.cumsum(mask, 1) - 1, min=0),
                     plen[:, None] + torch.arange(total - s, device=dev)], 1)
    half = d // 2
    inv = rope_inv_freq(hf.get("rope_theta", 10000.0), d, dev)
    ang = pos.float()[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = torch.cos(ang), torch.sin(ang)

    h = weights["embed"][tokens].float()
    for i in range(hf["num_hidden_layers"]):
        lw = {key: val[i] for key, val in lw_all.items()}
        x = _rms(h, lw["attn_norm"].float(), eps)

        def heads(w, nh):
            y = _lin(x, lw[w].float(), precision)
            return y.reshape(n, total, nh, d).transpose(1, 2)

        q = _rope(heads("wq", hq), cos, sin)
        k = _rope(heads("wk", hkv), cos, sin)
        v = heads("wv", hkv)
        attn = torch.empty_like(q)
        if cache == "raw":
            attn[:, :, :s] = _prompt_attention(q[:, :, :s], k[:, :, :s],
                                               v[:, :, :s], pad_start, window)
            idx = torch.arange(total, device=dev)
            attn[:, :, s:] = _attend(q[:, :, s:], k, v, idx[s:], idx,
                                     pad_start, window)
        else:
            attn[:, :, :s] = _prompt_attention(q[:, :, :s], k[:, :, :s],
                                               v[:, :, :s], pad_start, window)
            attn[:, :, s:] = _gear_decode(
                q, k, v, s, i, pad_start, window, fmt, loop, inits,
                weights["embed"].dtype)
        del q, k, v
        h = h + _lin(attn.transpose(1, 2).reshape(n, total, hq * d),
                     lw["wo"].float(), precision)
        del attn
        x2 = _rms(h, lw["mlp_norm"].float(), eps)
        hg = F.silu(_lin(x2, lw["wg"].float(), precision))
        hg = hg * _lin(x2, lw["wu"].float(), precision)
        h = h + _lin(hg, lw["wd"].float(), precision)
        del x2
    hs = _rms(h[:, s - 1:], weights["final_norm"].float(), eps)
    logits = _lin(hs, weights["lm_head"].float(), precision)
    return logits
