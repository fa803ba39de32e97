"""The plain reference of Mixtral-8x7B, in float32.

The published block (Hugging Face's ``MixtralDecoderLayer``): RMSNorm, GQA
attention with rotate-half RoPE at the published ``rope_theta``, then the
sparse mixture: the router's softmax over the experts, the top
``num_experts_per_tok`` kept and renormalised, and only the chosen experts
computed, each on the tokens that chose it (as ``MixtralSparseMoeBlock``
does), each a SwiGLU. It imports nothing of the program: the weights come
from the caller a layer at a time (``layer(i)``: the layer's whole
weights, experts stacked on a leading axis; ``outer``: the embedding, the
final norm and the output head), cast to float32 as they are used, and
the attention, RoPE and GEAR's compression are ``reference.decoder``'s and
``reference.gear``'s.

:func:`forward` runs rows teacher-forced as ``decoder.forward`` does,
and, given the router probabilities a program computed (``follow``), it
also follows the program's choice of experts at every layer and position,
as it follows the program's tokens: the weights of the chosen experts are
still its own probabilities, renormalised. A random mixture of experts is
chaotic: where the second and the third probability nearly tie, rounding
picks the pair, and a pair chosen otherwise at one position of a long
prompt changes every later position through attention, so a float32
reference that routes on its own parts from any bf16 program. Following
the program's choices keeps the two on one path, and the choices are
checked instead: beside the logits it returns, at every layer and
position, its own margin (the second probability less the third), whether
its own pair differs from the one followed, and the widest difference
between its probabilities and the followed ones.

``precision="fp8"`` is the control: every weight product, the router's
too, takes float8 (e4m3) operands, as in ``decoder``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .decoder import (_attend, _gear_decode, _lin, _prompt_attention, _rms,
                      _rope, rope_inv_freq)


def moe(x: torch.Tensor, router: torch.Tensor, wg, wu, wd, top_k: int,
        precision: str = "fp32", follow: torch.Tensor | None = None):
    """The sparse mixture of x [N, E] (float32) -> (out [N, E], the router
    probabilities [N, NE], the chosen experts [N, top_k]). ``wg``/``wu``/
    ``wd`` [NE, ...] in any float type; only the chosen experts' rows are
    computed. The chosen experts are the top ``top_k`` of its own
    probabilities, or of ``follow`` [N, NE] where given."""
    probs = torch.softmax(_lin(x, router.float(), precision), dim=-1)
    idx = torch.topk(probs if follow is None else follow, top_k,
                     dim=-1).indices
    w = probs.gather(-1, idx)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(router.shape[-1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(_lin(xe, wg[e].float(), precision)) * _lin(
            xe, wu[e].float(), precision)
        out.index_add_(0, rows, _lin(h, wd[e].float(), precision)
                       * w[rows, slot, None])
    return out, probs, idx


def margin(probs: torch.Tensor) -> torch.Tensor:
    """The second router probability less the third, at each row."""
    top = torch.topk(probs, 3, dim=-1).values
    return top[..., 1] - top[..., 2]


@torch.no_grad()
def forward(outer: dict, layer, hf: dict, tokens: torch.Tensor,
            mask: torch.Tensor, cache: str, fmt=None, loop: int = 3,
            inits=None, precision: str = "fp32", follow=None):
    """Teacher-forced logits of rows ``tokens`` [n, S + T] (the left-padded
    prompt bucket, then the T decode tokens fed), ``mask`` [n, S] the
    prompt's real tokens; ``cache`` "raw" or "gear" (``fmt``, ``loop`` and
    ``inits`` as ``decoder.forward``); ``follow`` [L, n, S + T, NE] the
    router probabilities whose choices of experts it follows (None: its
    own). -> (logits [n, T + 1, V] float32 at slots S - 1 .. S + T - 1,
    routing), ``routing`` a dict of [L, n, S + T] tensors at every slot:
    ``probs`` (its own probabilities, [..., NE]), ``margin`` (its second
    probability less its third), ``differ`` (its own pair is not the one
    followed) and ``diff`` (the widest difference between its
    probabilities and the followed ones)."""
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
    top_k = hf["num_experts_per_tok"]
    dev = tokens.device

    mask = mask.to(dev)
    plen = mask.sum(1)
    pad_start = (s - plen).to(torch.int64)
    pos = torch.cat([torch.clamp(torch.cumsum(mask, 1) - 1, min=0),
                     plen[:, None] + torch.arange(total - s, device=dev)], 1)
    ang = pos.float()[..., None] * rope_inv_freq(
        hf.get("rope_theta", 10000.0), d, dev)
    ang = torch.cat([ang, ang], -1)
    cos, sin = torch.cos(ang), torch.sin(ang)

    h = outer["embed"][tokens].float()
    routing = {"probs": [], "margin": [], "differ": [], "diff": []}
    for i in range(hf["num_hidden_layers"]):
        lw = layer(i)
        x = _rms(h, lw["attn_norm"].float(), eps)

        def heads(w, nh):
            y = _lin(x, lw[w].float(), precision)
            return y.reshape(n, total, nh, d).transpose(1, 2)

        q = _rope(heads("wq", hq), cos, sin)
        k = _rope(heads("wk", hkv), cos, sin)
        v = heads("wv", hkv)
        attn = torch.empty_like(q)
        attn[:, :, :s] = _prompt_attention(q[:, :, :s], k[:, :, :s],
                                           v[:, :, :s], pad_start, window)
        if cache == "raw":
            idx = torch.arange(total, device=dev)
            attn[:, :, s:] = _attend(q[:, :, s:], k, v, idx[s:], idx,
                                     pad_start, window)
        else:
            attn[:, :, s:] = _gear_decode(
                q, k, v, s, i, pad_start, window, fmt, loop, inits,
                outer["embed"].dtype)
        del q, k, v
        h = h + _lin(attn.transpose(1, 2).reshape(n, total, hq * d),
                     lw["wo"].float(), precision)
        del attn
        x2 = _rms(h, lw["mlp_norm"].float(), eps).reshape(n * total, e)
        fol = None if follow is None else follow[i].reshape(n * total, -1)
        out, probs, idx = moe(x2, lw["router"], lw["wg"], lw["wu"], lw["wd"],
                              top_k, precision, fol)
        h = h + out.reshape(n, total, e)
        own = torch.topk(probs, top_k, dim=-1).indices
        differ = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        diff = (torch.zeros_like(probs[:, 0]) if fol is None else
                (probs - fol).abs().amax(-1))
        for key, val in (("probs", probs), ("margin", margin(probs)),
                         ("differ", differ), ("diff", diff)):
            routing[key].append(val.reshape(n, total, *val.shape[1:]))
        del x2, out, probs, lw
    hs = _rms(h[:, s - 1:], outer["final_norm"].float(), eps)
    return (_lin(hs, outer["lm_head"].float(), precision),
            {k: torch.stack(v) for k, v in routing.items()})
