"""Inference engine: bucketed prefill + decode loop, PyTorch port of
``gear_tpu/engine.py`` (every mode, and its tensor, data and sequence
parallelism).

PyTorch runs eagerly, so there is nothing to compile: each decode step runs
the layer loop directly and updates the caches in place (the JAX engine
donates them to a jitted step instead). Greedy tokens stay on the device
between steps; the host syncs only every ``sync_every`` steps to check for
end-of-sequence, and once at the end.

CUDA graphs (the jitted step's counterpart on the card). A decode step
launches some sixty operations a layer, each enqueued by the host, which
then sets the pace. The fused and raw modes' step is one body,
``llama.forward_decode``, whose launches read the step's lengths from a
small buffer in device memory (``cache.StepLens``), staged from the
cache's host integers before the step; the host integers are the cache's
bookkeeping, moved on after the step (``cache.advance``), so a flush or a
cache restored in place between steps needs nothing from a graph. So on
the card a greedy step of those modes that does not flush, on an engine
with no mesh or one over ``nccl`` (``shard``: each rank captures its share
of the step with its collectives inside, and all ranks replay in step), is
captured once as a CUDA graph over static buffers and replayed: on the
second such step in a row over the same cache storages and input shapes
(the first runs eagerly, so a short generation never pays for a capture it
cannot use), after one run of the same body on a side stream. The engine
keeps one graph; a new cache or new shapes replace it. Every other step
runs the body eagerly: on the CPU, in the other modes (their own steps),
sharded over ``gloo`` (whose collectives pass through the host) or over
time (``shard_seq``), sampled (its draws would need the generator inside
the graph) and flushing steps. ``graph_captures``, ``graph_replays`` and
``eager_steps`` count this rank's steps of each kind, and the
``engine.decode_step`` span's ``graph`` attribute names its step's.

Models: a ``models.llama.ModelConfig`` runs Llama's passes; a
``models.mixtral.MixtralConfig`` the same passes with its expert mixture as
each layer's feed-forward block (``mixtral.engine_ffn``), in modes
``fused``, ``raw`` and ``simulated``.

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
  * ``h2o``       — a fixed budget of ``important_size + recent_size``
    positions with heavy-hitter eviction (``h2o.py``).
  * ``sink``      — ``sink_size`` attention sinks and a ring of
    ``window_size`` positions, keys rotated at attend time (``sink.py``).
In ``h2o`` and ``sink`` mode the prompt's bucket must fit the budget or the
capacity; attention there is plain torch (the reference runs no Pallas
kernel in either).

Init sites of the simulated mode (``init(site, shape)``, see
``models.llama``): ``("sim_prefill", layer, which)`` for the prompt's
compression and ``("sim_recompress", step, layer, which)`` for the one after
decode step ``step``.

Parallelism (``parallel/``): every rank of a ``torch.distributed`` process
group builds the same engine and calls ``generate`` with the same prompts.
``shard(mesh)`` splits the heads and the FFN (a mixture's experts) over the
mesh's ``model`` axis and the batch over its ``data`` axis, in every mode;
``shard_seq(mesh)`` splits the compressed cache along time over its ``seq``
axis (fused mode).
Each rank draws every random init and sample for the whole batch and all
heads from the shared seeded generator and keeps its own, so a sharded run
takes the unsharded run's draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import cache as kvcache
from . import h2o, kernels, profiling, sink
from .config import CompressionConfig
from .core import simulated
from .device import resolve_device
from .models import llama, mixtral
from .parallel import context, distributed, sharding

MODES = ("fused", "raw", "simulated", "h2o", "sink")


@dataclass(frozen=True)
class EngineConfig:
    max_len: int = 2048
    mode: str = "fused"            # fused | raw | simulated | h2o | sink
    eos_token_id: int | None = None
    pad_token_id: int = 0
    temperature: float = 0.0       # 0 = greedy
    sync_every: int = 16           # host<->device sync cadence for early exit
    use_lowrank: bool = True       # False: leave the error bases zero


class _StepGraph:
    """The static inputs of a decode step in device memory, and the CUDA
    graph that replays the step over them once it is captured."""

    def __init__(self, key, token, position, pad_start, device):
        self.key = key
        self.lens = kvcache.StepLens(device)
        self.token = torch.empty(token.shape, dtype=token.dtype,
                                 device=device)
        self.position = torch.empty(position.shape, dtype=position.dtype,
                                    device=device)
        self.pad_start = (torch.zeros(token.shape, dtype=torch.int32,
                                      device=device) if pad_start is None
                          else torch.empty(pad_start.shape,
                                           dtype=pad_start.dtype,
                                           device=device))
        self.graph = None     # the torch.cuda.CUDAGraph, once captured
        self.out = None       # its static (token, logits)
        self.launches = {}    # the kernel launches a replay makes, by wrapper
        self.collectives = {}  # the collective calls and bytes it makes


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
            raise ValueError(f"unknown engine mode {engine_cfg.mode!r} "
                             f"(modes: {MODES})")
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        moe = isinstance(model_cfg, mixtral.MixtralConfig)
        if moe and engine_cfg.mode not in ("fused", "raw", "simulated"):
            raise ValueError(f"a mixture of experts runs in modes fused, raw "
                             f"and simulated, not {engine_cfg.mode!r}")
        self.cfg = model_cfg
        self.params = params
        # each layer's feed-forward block: Llama's, or the expert mixture
        self.ffn = mixtral.engine_ffn(model_cfg) if moe else llama.mlp_ffn
        self.comp = comp or CompressionConfig(num_layers=model_cfg.num_layers)
        self.ecfg = engine_cfg
        self.batch = batch_size
        self.mesh = None       # shard(): the (data, model) mesh
        self.tp = None         # its model-axis collectives
        self.seq_mesh = None   # shard_seq(): the mesh with the seq axis
        self.seq_axis = "seq"
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
        self._set_specs(batch_size)
        self.graph_captures = 0   # decode steps captured as a CUDA graph
        self.graph_replays = 0    # decode steps replayed from it
        self.eager_steps = 0      # decode steps run operation by operation
        self.router_log = None    # log_routing(): a mixture's routing
        self._graph: _StepGraph | None = None
        self._warm_key = None     # the key of the last step, if it could
                                  # have been captured and ran eagerly

    def _set_specs(self, batch: int) -> None:
        """The cache specs of this rank's ``batch`` rows and ``self.cfg``'s
        kv heads."""
        cfg, lcomp = self.cfg, self.comp.layer(0)
        self.spec = cfg.cache_spec(batch, self.ecfg.max_len, lcomp)
        if self.ecfg.mode == "h2o":
            self.hspec = h2o.H2OSpec(
                batch=batch, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim,
                budget=lcomp.important_size + lcomp.recent_size,
                important=lcomp.important_size, dtype=cfg.dtype)
        elif self.ecfg.mode == "sink":
            self.sspec = sink.SinkSpec(
                batch=batch, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, num_sink=lcomp.sink_size,
                window=lcomp.window_size, rope_theta=cfg.rope_theta,
                dtype=cfg.dtype)

    # -- parallelism ----------------------------------------------------

    def shard(self, mesh, *, local: bool = False) -> "InferenceEngine":
        """Tensor and data parallelism over ``mesh``'s ``model`` and
        ``data`` axes (``parallel.sharding``; an absent axis counts as 1).
        This rank keeps its slices of the params and runs its share of the
        heads and the FFN, or of a mixture's experts (``self.cfg`` becomes
        the rank's config), for its rows of the batch; the layer loop
        reduces the partial sums and gathers the logits, and ``generate``
        gathers every row's tokens. With ``local`` the engine's params
        already are this rank's slices, as ``sharding.shard_params`` leaves
        them (a model no card holds whole is never made whole).
        Raises unless the heads, the FFN, the vocabulary and the batch
        divide evenly, and, in simulated mode, unless the method's token
        groups (along the flattened heads) stay within a rank's heads:
        methods GEARL and KIVI, ``group_size`` dividing the rank's
        ``num_kv_heads * head_dim``."""
        nd, nm = mesh.axis_size("data"), mesh.axis_size("model")
        if self.batch % nd:
            raise ValueError(f"batch {self.batch} does not split evenly "
                             f"over data={nd}")
        cfg = sharding.local_config(self.cfg, mesh)
        lcomp = self.comp.layer(0)
        if self.simulating and nm > 1 and (
                lcomp.compress_method not in ("GEARL", "KIVI_V2", "UNIFORM")
                or cfg.num_kv_heads * cfg.head_dim % lcomp.group_size):
            raise ValueError(
                f"simulated mode's {lcomp.compress_method} (group "
                f"{lcomp.group_size}) mixes the heads of several ranks: "
                "tensor parallelism there takes GEARL or KIVI with groups "
                "inside a rank's heads")
        if not local:
            self.params = sharding.shard_params(mesh, self.params)
        self.cfg = cfg
        self.mesh = mesh
        self.tp = sharding.TensorParallel(mesh) if nm > 1 else None
        self._set_specs(self.batch // nd)
        if isinstance(cfg, mixtral.MixtralConfig):
            self.ffn = mixtral.engine_ffn(cfg, self.tp, self.router_log)
        return self

    def log_routing(self) -> "mixtral.RouterLog":
        """Keep a mixture's router probabilities from now on, for this
        rank's rows (``mixtral.RouterLog``: every prompt pass's, and each
        decode step's, replayed or not)."""
        if not isinstance(self.cfg, mixtral.MixtralConfig):
            raise ValueError("only a mixture of experts routes")
        self.router_log = mixtral.RouterLog(
            self.cfg.num_layers, self.spec.batch, self.cfg.num_experts,
            self.device)
        self.ffn = mixtral.engine_ffn(self.cfg, self.tp, self.router_log)
        return self.router_log

    def _log_begin(self, prompt: bool) -> None:
        if self.router_log is not None:
            self.router_log.begin(prompt)

    def shard_seq(self, mesh, axis: str = "seq") -> "InferenceEngine":
        """Sequence-parallel decode (context parallelism) over ``mesh``'s
        ``axis``: every rank runs the whole prefill, then keeps its time
        shard of the compressed cache (``parallel.context.split_cache``),
        and each decode step runs ``llama.forward_decode_seqsharded``. Fused
        mode only. Raises for a model whose sliding window could bind
        (``sliding_window < max_len``): the sharded attention has no
        window."""
        if self.ecfg.mode != "fused":
            raise ValueError("sequence-parallel decode requires mode='fused'")
        if self.ffn is not llama.mlp_ffn:
            raise ValueError("sequence-parallel decode runs Llama's "
                             "feed-forward block only")
        win = self.cfg.sliding_window
        if win is not None and win < self.ecfg.max_len:
            raise ValueError(
                f"sliding_window {win} < max_len {self.ecfg.max_len}: "
                "sequence-parallel decode attends the whole cache")
        context.shard_spec(self.spec, mesh.axis_size(axis))
        self.seq_mesh, self.seq_axis = mesh, axis
        return self

    def _rows(self) -> slice:
        """This rank's rows of the batch."""
        if self.mesh is None:
            return slice(0, self.batch)
        n = self.batch // self.mesh.axis_size("data")
        i = self.mesh.index("data")
        return slice(i * n, (i + 1) * n)

    def _inits(self, init, generator):
        """The init hook the model passes get: under ``shard``, each draw
        taken from the whole batch's and heads' (``sharding.sharded_inits``);
        else ``init`` itself (None: the passes draw from ``generator``)."""
        if self.mesh is None:
            return init
        return sharding.sharded_inits(self.mesh, init, generator, self.device)

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
        """Prompt pass of this rank's rows -> (logits [B,S,V], stacked
        caches)."""
        with profiling.span("engine.prefill", batch=tokens.shape[0],
                            bucket=tokens.shape[1]):
            self._log_begin(prompt=True)
            positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
            s = tokens.shape[1]
            mode, tp = self.ecfg.mode, self.tp
            init = self._inits(init, generator)
            if mode == "h2o":
                if s > self.hspec.budget:
                    raise ValueError(
                        f"h2o mode: prompt bucket {s} exceeds the H2O "
                        f"budget {self.hspec.budget}")
                return llama.forward_prefill_h2o(self.params, self.cfg, tokens,
                                                 positions, mask, self.hspec,
                                                 tp=tp)
            if mode == "sink":
                if s > self.sspec.capacity:
                    raise ValueError(
                        f"sink mode: prompt bucket {s} exceeds the sink "
                        f"capacity {self.sspec.capacity}")
                return llama.forward_prefill_sink(self.params, self.cfg,
                                                  tokens, positions, mask,
                                                  self.sspec, tp=tp)
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
                kv_hook=hook, ffn=self.ffn, tp=tp)

    def recompress(self, caches, end: int, *, step: int = 0, init=None,
                   generator: torch.Generator | None = None):
        """Simulated mode's recompression of the raw cache's first ``end``
        tokens, in place: the newest ``streaming_gap`` of them with
        ``stream_grouping``, else all of them."""
        lcomp = self.comp.layer(0)
        start = end - lcomp.streaming_gap if lcomp.stream_grouping else 0
        init = self._inits(init, generator)
        for i in range(self.cfg.num_layers):
            k, v = caches.k[i, :, :, start:end], caches.v[i, :, :, start:end]
            kc, vc = self._compress(k, v, ("sim_recompress", step, i),
                                    prefill=False, init=init,
                                    generator=generator)
            k.copy_(kc)
            v.copy_(vc)
        return caches

    def decode_step(self, caches, token, position, pad_start, *, step: int = 0,
                    init=None, generator: torch.Generator | None = None,
                    n_tokens: int | None = None):
        """One decode step of this rank's rows -> (next token [B] int64,
        logits [B,V], caches). After ``shard_seq``, ``caches`` is this
        rank's time shard and ``n_tokens`` the tokens the whole cache holds
        before the step. A step replayed from a CUDA graph (see the
        module's docstring) returns copies of the graph's outputs."""
        key = (None if self._eager_because(caches) is not None
               else self._key(caches, token, position, pad_start))
        g = self._graph
        if key is None:
            kind, self._warm_key = "eager", None
        elif g is not None and g.key == key:
            kind = "replay"
        elif self._warm_key == key:
            kind = "capture"
        else:
            kind, self._warm_key = "eager", key
        with profiling.span("engine.decode_step", step=step,
                            batch=token.shape[0], graph=kind):
            if kind == "replay":
                return self._replay(g, caches, token, position, pad_start)
            if kind == "capture":
                return self._capture(key, caches, token, position, pad_start)
            self.eager_steps += 1
            return self._step(caches, token, position, pad_start, step=step,
                              init=init, generator=generator,
                              n_tokens=n_tokens)

    def _step(self, caches, token, position, pad_start, *, step: int = 0,
              init=None, generator=None, n_tokens=None, lens=None):
        """The decode step's body -> (next token, logits, caches): eager,
        or, with ``lens``, over a graph's buffers to be captured (the host
        lengths then left to the caller)."""
        self._log_begin(prompt=False)
        mode, tp = self.ecfg.mode, self.tp
        init = self._inits(init, generator)
        if self.seq_mesh is not None:
            if n_tokens is None:
                raise ValueError("a sequence-sharded decode step needs "
                                 "n_tokens")
            logits, caches = llama.forward_decode_seqsharded(
                self.params, self.cfg, token, position, caches,
                self.seq_mesh, spec=self.spec, n_tokens=n_tokens,
                axis=self.seq_axis, pad_start=pad_start, init=init,
                generator=generator, step=step,
                use_lowrank=self.ecfg.use_lowrank, tp=tp)
        elif mode == "h2o":
            logits, caches = llama.forward_decode_h2o(
                self.params, self.cfg, token, position, caches,
                hspec=self.hspec, tp=tp)
        elif mode == "sink":
            logits, caches = llama.forward_decode_sink(
                self.params, self.cfg, token, position, caches,
                sspec=self.sspec, tp=tp)
        else:
            logits, caches = llama.forward_decode(
                self.params, self.cfg, token, position, caches,
                spec=self.spec, compress=mode == "fused",
                pad_start=pad_start, init=init, generator=generator,
                step=step, use_lowrank=self.ecfg.use_lowrank, ffn=self.ffn,
                tp=tp, lens=lens)
        return self._pick(logits, generator), logits, caches

    # -- CUDA graphs of the decode step -----------------------------------

    def _eager_because(self, caches) -> str | None:
        """Why the next decode step over ``caches`` runs eagerly, or None
        if a CUDA graph can replay it."""
        if self.device.type != "cuda":
            return "device"
        if self.ecfg.mode not in ("fused", "raw"):
            return "mode"
        if self.seq_mesh is not None or (
                self.mesh is not None
                and not distributed.capturable(self.mesh)):
            return "mesh"   # gloo's collectives pass through the host
        if self.ecfg.temperature > 0:
            return "sampling"
        if self.ecfg.mode == "raw":
            # a full cache: the eager step raises
            return "full" if caches.length >= self.spec.max_len else None
        return "flush" if caches.resid_len + 1 >= self.spec.group else None

    def _key(self, caches, token, position, pad_start) -> tuple:
        """What a captured step holds besides its static inputs: the
        storages of the cache and of the params, the inputs' shapes and
        types, and the process groups of its collectives."""
        tensors = [t for t in vars(caches).values() if torch.is_tensor(t)]
        dicts = [self.params]
        while dicts:
            for v in dicts.pop().values():
                if isinstance(v, dict):
                    dicts.append(v)
                else:
                    tensors.append(v)
        groups = (None if self.mesh is None else
                  tuple(id(self.mesh.group(a)) for a in self.mesh.shape))
        if self.router_log is not None:
            tensors.append(self.router_log.step)
        return (tuple((t.data_ptr(), t.shape) for t in tensors),
                token.shape, token.dtype, position.shape, position.dtype,
                None if pad_start is None else (pad_start.shape,
                                                pad_start.dtype), groups)

    def _load(self, g: _StepGraph, caches, token, position, pad_start):
        """Write the step's inputs into ``g``'s buffers on the current
        stream: its lengths (``StepLens.stage``), the token, the position
        and ``pad_start``."""
        kvcache.StepLens.stage(self.spec, caches, self.cfg.sliding_window,
                               g.lens)
        g.token.copy_(token)
        g.position.copy_(position)
        if pad_start is not None:
            g.pad_start.copy_(pad_start)

    def _capture(self, key, caches, token, position, pad_start):
        """Run the step over new static buffers on a side stream, then
        capture it there as the graph later steps replay. The capture pass
        launches nothing, so the kernel wrappers' and the collectives'
        counts keep the run's, and each replay adds the capture's. A
        sharded capture holds its ranks' collectives, and is made in
        thread-local mode, so that the process group's own threads may go
        on querying its earlier work."""
        self._graph = None   # the old graph's memory first
        g = _StepGraph(key, token, position, pad_start, self.device)
        self._load(g, caches, token, position, pad_start)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        args = (caches, g.token, g.position, g.pad_start)
        with torch.cuda.stream(side):
            nxt, logits, _ = self._step(*args, lens=g.lens)
        cur.wait_stream(side)
        nxt.record_stream(cur)
        logits.record_stream(cur)
        before = kernels.launch_counts()
        sent = distributed.collective_counts()
        g.graph = torch.cuda.CUDAGraph()
        mode = "global" if self.mesh is None else "thread_local"
        with torch.cuda.graph(g.graph, stream=side,
                              capture_error_mode=mode):
            g.out = self._step(*args, lens=g.lens)[:2]
        g.launches = {k: n - before[k]
                      for k, n in kernels.launch_counts().items()
                      if n != before[k]}
        kernels.add_launch_counts({k: -n for k, n in g.launches.items()})
        g.collectives = {k: n - sent[k]
                         for k, n in distributed.collective_counts().items()}
        distributed.add_collective_counts(
            {k: -n for k, n in g.collectives.items()})
        self._graph = g
        kvcache.advance(self.spec, caches)
        self.graph_captures += 1
        return nxt, logits, caches

    def _replay(self, g: _StepGraph, caches, token, position, pad_start):
        self._load(g, caches, token, position, pad_start)
        g.graph.replay()
        kernels.add_launch_counts(g.launches)
        distributed.add_collective_counts(g.collectives)
        kvcache.advance(self.spec, caches)
        self.graph_replays += 1
        nxt, logits = g.out
        return nxt.clone(), logits.clone(), caches

    def _pick(self, logits: torch.Tensor, generator) -> torch.Tensor:
        """Greedy, or sampled at ``temperature`` by the inverse of each
        row's cumulative distribution at a uniform draw; the draws are
        taken for the whole batch and a rank keeps its rows'."""
        temp = self.ecfg.temperature
        if temp <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand((self.batch,), generator=generator,
                       device=logits.device)[self._rows()]
        cdf = torch.cumsum(torch.softmax(logits.float() / temp, dim=-1), -1)
        tok = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
        return tok[:, 0].clamp(max=logits.shape[-1] - 1)

    # -- public API -----------------------------------------------------

    @torch.no_grad()
    def generate(self, token_lists: list[list[int]], max_new_tokens: int, *,
                 seed: int = 0, init=None,
                 echo_prompt: bool = False) -> list[list[int]]:
        """Greedy/sampled generation for a batch of prompts.

        Returns generated token ids per row (without the prompt unless
        ``echo_prompt``); stops early once every row hit eos. ``seed`` seeds
        the generator for sampling and the power-iteration inits; ``init``
        injects the inits instead (see ``models.llama``; asked for at the
        whole batch's and heads' shape). Sharded, every rank passes the
        same prompts and gets every row's tokens.
        """
        if len(token_lists) != self.batch:
            raise ValueError(f"engine built for batch {self.batch}, got "
                             f"{len(token_lists)} prompts")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        # the bucket and the left padding of the whole batch, so that every
        # row's positions are the unsharded run's
        s = self.bucket_len(max(len(t) for t in token_lists))
        tokens, mask = self.left_pad(token_lists, self.ecfg.pad_token_id, s)
        rows = self._rows()
        tokens, mask = tokens[rows], mask[rows]
        logits, caches = self.prefill(tokens, mask, init=init, generator=gen)

        prompt_len = mask.sum(dim=1).to(torch.int32)
        pad_start = (s - prompt_len).to(torch.int32)
        cur = self._pick(logits[:, -1], gen)
        del logits
        if self.seq_mesh is not None:
            n = self.seq_mesh.axis_size(self.seq_axis)
            caches = context.split_cache(self.spec, caches, n)[
                self.seq_mesh.index(self.seq_axis)]

        eos = self.ecfg.eos_token_id
        done = torch.zeros(cur.shape, dtype=torch.bool, device=self.device)
        if eos is not None:
            done = done | (cur == eos)
        out = [cur]
        for step_i in range(max_new_tokens - 1):
            position = prompt_len + step_i
            nxt, _, caches = self.decode_step(
                caches, cur, position, pad_start, step=step_i, init=init,
                generator=gen, n_tokens=s + step_i)
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
                if self._all_done(done):
                    break

        gen_tok = torch.stack(out, dim=1)  # [B, T]
        if self.mesh is not None:
            gen_tok = distributed.gather(gen_tok, self.mesh, "data", 0)
        gen_tok = gen_tok.cpu().tolist()
        results = []
        for i in range(self.batch):
            row = gen_tok[i]
            if eos is not None and eos in row:
                row = row[: row.index(eos) + 1]
            results.append((list(token_lists[i]) if echo_prompt else []) + row)
        return results

    def _all_done(self, done: torch.Tensor) -> bool:
        """Whether every row of the whole batch hit eos: one sum over the
        data ranks, so that all of them stop at the same step."""
        left = (~done).sum().reshape(1)
        if self.mesh is not None:
            left = distributed.all_reduce(left, self.mesh, "data")
        return int(left) == 0
