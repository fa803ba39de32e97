"""Inference engine: bucketed prefill + decode loop, PyTorch port of
``gear_tpu/engine.py`` (modes ``fused`` and ``raw``).

PyTorch runs eagerly, so there is nothing to compile: each decode step runs
the layer loop directly and updates the caches in place (the JAX engine
donates them to a jitted step instead). Greedy tokens stay on the device
between steps; the host syncs only every ``sync_every`` steps to check for
end-of-sequence, and once at the end.

Modes:
  * ``fused``     — two-tier compressed cache (the speed + memory path), for
    every method of ``config.METHODS`` and for sliding-window models.
  * ``raw``       — uncompressed bf16 cache (the baseline fused mode is
    compared with), attended by the flash-decode kernel on the card.
  * ``simulated`` — the raw cache with fake-quant recompression (the
    accuracy path): the prompt's K/V compressed inside the prefill, before
    its attention, then every ``streaming_gap`` decode steps the newest
    ``streaming_gap`` tokens (``stream_grouping``) or the whole cache
    (the default) compressed again; decode attends the raw cache through
    the flash-decode kernel on the card.
The JAX engine's other modes (``h2o``, ``sink``) raise
``NotImplementedError``.

Init sites of the simulated mode (``init(site, shape)``, see
``models.llama``): ``("sim_prefill", layer, which)`` for the prompt's
compression and ``("sim_recompress", step, layer, which)`` for the one after
decode step ``step``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .config import CompressionConfig
from .core import simulated
from .device import resolve_device
from .models import llama

MODES = ("fused", "raw", "simulated")


@dataclass(frozen=True)
class EngineConfig:
    max_len: int = 2048
    mode: str = "fused"            # fused | raw | simulated
    eos_token_id: int | None = None
    pad_token_id: int = 0
    temperature: float = 0.0       # 0 = greedy
    sync_every: int = 16           # host<->device sync cadence for early exit
    use_lowrank: bool = True       # False: leave the error bases zero


class InferenceEngine:
    """Holds params and runs prefill + decode for one model.

    ``device`` defaults to ``cuda`` and raises without a CUDA device; the
    params must already lie on it.
    """

    def __init__(self, model_cfg: llama.ModelConfig, params: dict,
                 comp: CompressionConfig | None = None,
                 engine_cfg: EngineConfig = EngineConfig(),
                 batch_size: int = 1, *, device=None):
        self.device = resolve_device(device)
        if engine_cfg.mode not in MODES:
            raise NotImplementedError(
                f"engine mode {engine_cfg.mode!r} is not ported yet "
                f"(ported: {MODES})")
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        self.cfg = model_cfg
        self.params = params
        self.comp = comp or CompressionConfig(num_layers=model_cfg.num_layers)
        self.ecfg = engine_cfg
        self.batch = batch_size
        lcomp = self.comp.layer(0)
        if engine_cfg.max_len % lcomp.group_size:
            raise ValueError("max_len must be a multiple of group_size")
        win = model_cfg.sliding_window
        if win is not None and win < lcomp.group_size:
            # attend_fused would raise the same only mid-generation: the
            # residual tier (up to group_size of the newest tokens) must fit
            # inside the attention window
            raise ValueError(
                f"sliding_window {win} < group_size {lcomp.group_size}: "
                "the compressed cache masks the window over the packed "
                "prefix only; use group_size <= sliding_window")
        self.spec = model_cfg.cache_spec(batch_size, engine_cfg.max_len, lcomp)

    # -- bucketing ------------------------------------------------------

    def bucket_len(self, s: int) -> int:
        """Round up to a multiple of the quant group so left-padding always
        lands in the compressed prefix (keeps pad masking exact)."""
        g = self.spec.group
        b = ((s + g - 1) // g) * g
        if b > self.ecfg.max_len:
            raise ValueError(f"prompt length {s} exceeds max_len {self.ecfg.max_len}")
        return b

    def left_pad(self, token_lists: list[list[int]], pad_id: int, to_len: int):
        """-> (tokens [B,S] int64, mask [B,S] int32) on the engine's device."""
        b = len(token_lists)
        tokens = torch.full((b, to_len), pad_id, dtype=torch.int64)
        mask = torch.zeros((b, to_len), dtype=torch.int32)
        for i, t in enumerate(token_lists):
            t = t[-to_len:]
            tokens[i, to_len - len(t):] = torch.tensor(t, dtype=torch.int64)
            mask[i, to_len - len(t):] = 1
        return tokens.to(self.device), mask.to(self.device)

    # -- stages ---------------------------------------------------------

    @property
    def simulating(self) -> bool:
        """Simulated mode with a method that compresses, streaming on."""
        lcomp = self.comp.layer(0)
        return (self.ecfg.mode == "simulated" and lcomp.streaming
                and lcomp.compress_method != "NONE")

    def _compress(self, k, v, site, *, prefill, init, generator):
        """compress_kv of one layer's [B,H,S,D] K/V (float32 math), back in
        the cache's dtype."""
        p0 = None if init is None else (
            lambda which, shape: init((*site, which), shape))
        kc, vc = simulated.compress_kv(
            k.float(), v.float(), self.comp.layer(0), prefill=prefill, p0=p0,
            generator=generator)
        return kc.to(k.dtype), vc.to(v.dtype)

    def prefill(self, tokens: torch.Tensor, mask: torch.Tensor, *,
                init=None, generator: torch.Generator | None = None):
        """Prompt pass -> (logits [B,S,V], stacked caches)."""
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        hook = None
        if self.simulating:
            def hook(layer, k, v):
                return self._compress(k, v, ("sim_prefill", layer),
                                      prefill=True, init=init,
                                      generator=generator)
        return llama.forward_prefill(
            self.params, self.cfg, tokens, positions, mask, self.spec,
            compress=self.ecfg.mode == "fused", init=init,
            generator=generator, use_lowrank=self.ecfg.use_lowrank,
            kv_hook=hook)

    def recompress(self, caches, end: int, *, step: int = 0, init=None,
                   generator: torch.Generator | None = None):
        """Simulated mode's recompression of the raw cache's first ``end``
        tokens, in place: the newest ``streaming_gap`` of them with
        ``stream_grouping``, else all of them."""
        lcomp = self.comp.layer(0)
        start = end - lcomp.streaming_gap if lcomp.stream_grouping else 0
        for i in range(self.cfg.num_layers):
            k, v = caches.k[i, :, :, start:end], caches.v[i, :, :, start:end]
            kc, vc = self._compress(k, v, ("sim_recompress", step, i),
                                    prefill=False, init=init,
                                    generator=generator)
            k.copy_(kc)
            v.copy_(vc)
        return caches

    def decode_step(self, caches, token, position, pad_start, *, step: int = 0,
                    init=None, generator: torch.Generator | None = None):
        """One decode step -> (next token [B] int64, logits [B,V], caches)."""
        logits, caches = llama.forward_decode(
            self.params, self.cfg, token, position, caches, spec=self.spec,
            compress=self.ecfg.mode == "fused", pad_start=pad_start,
            init=init, generator=generator, step=step,
            use_lowrank=self.ecfg.use_lowrank)
        return self._pick(logits, generator), logits, caches

    def _pick(self, logits: torch.Tensor, generator) -> torch.Tensor:
        temp = self.ecfg.temperature
        if temp > 0:
            probs = torch.softmax(logits / temp, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    # -- public API -----------------------------------------------------

    @torch.no_grad()
    def generate(self, token_lists: list[list[int]], max_new_tokens: int, *,
                 seed: int = 0, init=None,
                 echo_prompt: bool = False) -> list[list[int]]:
        """Greedy/sampled generation for a batch of prompts.

        Returns generated token ids per row (without the prompt unless
        ``echo_prompt``); stops early once every row hit eos. ``seed`` seeds
        the generator for sampling and the power-iteration inits; ``init``
        injects the inits instead (see ``models.llama``).
        """
        if len(token_lists) != self.batch:
            raise ValueError(f"engine built for batch {self.batch}, got "
                             f"{len(token_lists)} prompts")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        s = self.bucket_len(max(len(t) for t in token_lists))
        tokens, mask = self.left_pad(token_lists, self.ecfg.pad_token_id, s)
        logits, caches = self.prefill(tokens, mask, init=init, generator=gen)

        prompt_len = mask.sum(dim=1).to(torch.int32)
        pad_start = (s - prompt_len).to(torch.int32)
        cur = self._pick(logits[:, -1], gen)

        eos = self.ecfg.eos_token_id
        done = torch.zeros((self.batch,), dtype=torch.bool, device=self.device)
        if eos is not None:
            done = done | (cur == eos)
        out = [cur]
        for step_i in range(max_new_tokens - 1):
            position = prompt_len + step_i
            nxt, _, caches = self.decode_step(
                caches, cur, position, pad_start, step=step_i, init=init,
                generator=gen)
            if eos is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
            out.append(nxt)
            cur = nxt
            if (self.simulating
                    and (step_i + 1) % self.comp.layer(0).streaming_gap == 0):
                self.recompress(caches, s + step_i + 1, step=step_i,
                                init=init, generator=gen)
            if eos is not None and (step_i + 1) % self.ecfg.sync_every == 0:
                if bool(done.all()):
                    break

        gen_tok = torch.stack(out, dim=1).cpu().tolist()  # [B, T]
        results = []
        for i in range(self.batch):
            row = gen_tok[i]
            if eos is not None and eos in row:
                row = row[: row.index(eos) + 1]
            results.append((list(token_lists[i]) if echo_prompt else []) + row)
        return results
