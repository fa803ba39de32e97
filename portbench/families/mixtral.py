"""The program's entries for a Mixtral configuration: the port's
``engine.InferenceEngine`` over a ``models.mixtral.MixtralConfig`` in the
cell's mode, sharded over ``world`` ranks (``InferenceEngine.shard`` over a
``model`` axis: heads and vocabulary tensor parallel, experts expert
parallel) from the rank's own share of the weights, its ``prefill`` and
``decode_step`` driven as the window drives them."""
from __future__ import annotations

import dataclasses

from gear_tpu_torch.config import CompressionConfig
from gear_tpu_torch.engine import EngineConfig, InferenceEngine
from gear_tpu_torch.models import mixtral
from gear_tpu_torch.parallel import distributed, sharding
from portbench.families.mistral import port_rope_theta
from portbench.weights import dtype_of


def model_config(hf: dict) -> mixtral.MixtralConfig:
    cfg = mixtral.MixtralConfig.from_hf(hf)
    return dataclasses.replace(
        cfg, dtype=dtype_of(hf),
        rope_theta=port_rope_theta(cfg.rope_theta, cfg.head_dim))


def collective_bytes() -> int | None:
    """Bytes the program's collectives have reduced so far in this
    process; None where the program does not count them."""
    counts = getattr(distributed, "collective_counts", None)
    return None if counts is None else counts()["bytes"]


class Program:
    def __init__(self, hf: dict, params: dict, comp: dict | None, mode: str,
                 max_len: int, batch: int, device, world: int = 1):
        cfg = model_config(hf)
        self.rope = {"published_theta": hf.get("rope_theta", 10000.0),
                     "port_theta": cfg.rope_theta}
        ccfg = CompressionConfig(num_layers=cfg.num_layers, **(comp or {}))
        self.eng = InferenceEngine(cfg, params, ccfg,
                                   EngineConfig(max_len=max_len, mode=mode),
                                   batch_size=batch, device=device)
        if world > 1:
            self.eng.shard(sharding.make_mesh(model=world), local=True)

    def router_log(self):
        """The engine's log of its router probabilities
        (``mixtral.RouterLog``), kept from now on; None where the program
        keeps none."""
        log = getattr(self.eng, "log_routing", None)
        return None if log is None else log()

    def prefill(self, tokens, mask, init):
        """-> (next-token logits [B, V] of the prompts, the caches)."""
        logits, caches = self.eng.prefill(tokens, mask, init=init)
        last = logits[:, -1].clone()
        del logits
        return last, caches

    def decode(self, caches, token, position, pad_start, step, init):
        """One greedy decode step -> (tokens [B], caches)."""
        nxt, _, caches = self.eng.decode_step(caches, token, position,
                                              pad_start, step=step, init=init)
        return nxt, caches
