"""Static long-context decode of a model sharded over the cell's chips: one
process a card, joined over NCCL (over gloo on the CPU, in a rehearsal),
each driving its rank of the program through ``static_decode``'s window.

The parent (``run.py``'s process) starts one process a rank with this file
as its program (``python -m portbench.drivers.tp_decode ARGS``), waits for
them, and ends every rank as soon as one fails: a rank that exits with an
error, or any still running past the deadline, makes the parent kill the
others and raise, so that the run exits non-zero instead of leaving ranks
waiting on a dead sibling. The process group's own timeout ends a rank
stuck in a collective.

Each rank makes its share of the weights from the seed
(``weights_moe.rank_share``: no process holds the whole model), the same
prompts as every other rank (``static_decode``'s), runs the prompt pass,
keeps a device copy of its cache, warms up and replays as
``static_decode`` does, and reads its tokens back after every step. The
ranks step together: rank 0 alone reads the clock and, once ``--seconds``
have passed, names through a file they all map the step after which every
rank stops (a rank can read that step's tokens only after rank 0 has
launched it, so all see the same step). A traced run profiles the same
steps on every rank; rank 0's trace gives the device metrics, every
rank's spans the graph share.

The check: the ``check_rows`` rows (``static_decode.check_rows``) are
spread over the ranks, and each rank runs the plain reference
(``reference.mixtral``, float32, one layer at a time from the seed,
``weights_moe.layer``) teacher-forced over its rows: over the tokens the
program served and along the experts the program chose, which the engine
logs (``InferenceEngine.log_routing``: the prompt pass's router
probabilities, and each step's, copied after the step inside the timed
loop). ``max_logit_gap`` is the widest gap by which a served token's
reference logit lies below the reference's best, ``mean_logit_gap`` the
mean over the checked positions. ``routing_mismatch`` is
the share of the real positions' (layer, position) pairs whose reference
routing is decided (its second router probability above its third by at
least the cell's ``router_margin``) where the program chose another pair
of experts. Beside them (not limited) the share of undecided pairs, the
widest difference between the two sides' router probabilities, and both
numbers at other margins.

End-to-end metrics as ``static_decode``'s, from rank 0's clock, but
``kv_bytes_per_token``: every rank's cache bytes together, over
``batch * max_len`` tokens; ``memory_peak_bytes`` is the fullest card's.
"""
from __future__ import annotations

import argparse
import json
import mmap
import os
import struct
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PG_TIMEOUT_S = 300     # a collective that waits longer ends its rank
DEADLINE_S = 1800      # past --seconds, the longest the ranks may take
RANK_THREADS = 4       # each rank's CPU threads on the card's host


# -- the parent --------------------------------------------------------------

def run(ctx) -> dict:
    args = {"workload": ctx.cell.name, "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": ctx.trace, "fault": ctx.fault,
            "control": bool(getattr(ctx, "control", False)),
            "t_start": ctx.t_start}
    res = spawn("portbench.drivers.tp_decode", args, ctx.cell.chips,
                ctx.device.type == "cpu", ctx.seconds + DEADLINE_S)
    return _merge(res, ctx.traffic)


def spawn(module: str, args: dict, world: int, rehearse: bool,
          limit: float) -> list:
    """Run ``python -m module`` once a rank with ``args`` (and ``rank``,
    ``world``, ``rehearse`` and ``dir``, a directory of their own) and
    return what each rank saved as ``dir/rank<r>.pt``."""
    import torch

    with tempfile.TemporaryDirectory(prefix="portbench_tp_") as tmp:
        tmp = Path(tmp)
        (tmp / "stop").write_bytes(struct.pack("<q", -1))
        args = {**args, "world": world, "rehearse": rehearse,
                "dir": str(tmp)}
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep),
            "OMP_NUM_THREADS": "1" if rehearse else str(RANK_THREADS)}
        procs, logs = [], []
        try:
            for r in range(world):
                logs.append(open(tmp / f"rank{r}.log", "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module,
                     json.dumps({**args, "rank": r})], cwd=ROOT, env=env,
                    stdout=logs[-1], stderr=subprocess.STDOUT))
            _wait(procs, tmp, limit)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _wait(procs, tmp: Path, limit: float) -> None:
    """Until every rank has exited 0; else kill them all and raise with the
    first failed rank's log."""
    t0 = time.time()
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        late = time.time() - t0 > limit
        if bad or late:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            r = bad[0] if bad else 0
            tail = (tmp / f"rank{r}.log").read_text()[-4000:]
            why = (f"rank {r} exited with code {codes[r]}" if bad else
                   f"the ranks ran past {limit:.0f} s")
            raise RuntimeError(f"tp_decode: {why}; every rank ended. "
                               f"Its log ends:\n{tail}")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.2)


MARGINS = (0.01, 0.03, 0.1, 0.2, 0.3, 0.5, 1.0)   # the routing's table


def _routing(rows: list, delta: float) -> dict:
    """Over the checked rows' (layer, position) pairs: the share whose
    reference margin is below ``delta`` (undecided), and the share of the
    others where the program's pair of experts is not the reference's."""
    n = sum(r["margin"].numel() for r in rows)
    decided = [r["margin"] >= delta for r in rows]
    m = sum(int(d.sum()) for d in decided)
    bad = sum(int((r["differ"] & d).sum()) for r, d in zip(rows, decided))
    return {"undecided_share": 1.0 - m / n if n else 1.0,
            "routing_mismatch": bad / m if m else 0.0}


def _numbers(rows: list, limits: dict, delta: float) -> list:
    """(name, number, limit) of each number the cell limits, over the
    checked rows (see the module's docstring)."""
    gaps = [r["gaps"] for r in rows]
    values = {"max_logit_gap": max(float(g.max()) for g in gaps),
              "mean_logit_gap": float(sum(g.sum() for g in gaps)
                                      / sum(g.numel() for g in gaps)),
              **_routing(rows, delta)}
    return [(name, values[name], lim) for name, lim in limits.items()]


def _routing_table(rows: list) -> dict:
    """The routing's numbers at other margins, and the widest difference
    between the program's router probabilities and the reference's."""
    return {"router_prob_diff": max(float(r["diff"].max()) for r in rows),
            "by_margin": {str(d): _routing(rows, d) for d in MARGINS}}


def _merge(res: list, tr: dict) -> dict:
    import torch

    from portbench.drivers import static_decode as sd

    first = res[0]
    rows = sorted((row for r in res for row in r["rows"]),
                  key=lambda r: r["row"])
    delta = tr["router_margin"]
    e2e = dict(first["e2e"])
    e2e["kv_bytes_per_token"] = sum(r["kv_bytes_per_token"] for r in res)
    ctx = dict(first["ctx"])
    ctx["graph_kinds"] = [r["graph_kinds"] for r in res]
    extra = dict(first["extra"])
    extra["checked_rows"] = [r["row"] for r in rows]
    extra["gaps"] = sd.gap_stats(torch.cat([r["gaps"] for r in rows]))
    extra["routing"] = _routing_table(rows)
    extra["ranks"] = [{"memory_peak_bytes": r["memory_peak_bytes"],
                       "graph": r["graph_counts"]} for r in res]
    if all("control" in r for r in rows):
        ctrl = [r["control"] for r in rows]
        extra["control_numbers"] = {n: v for n, v, _ in
                                    _numbers(ctrl, tr["limits"], delta)}
        extra["control_gaps"] = sd.gap_stats(torch.cat(
            [r["gaps"] for r in ctrl]))
        extra["control_routing"] = _routing_table(ctrl)
    return {"e2e": e2e, "ctx": ctx, "attempted": first["attempted"],
            "failed": 0,
            "memory_peak_bytes": max(r["memory_peak_bytes"] for r in res),
            "trace": ctx["trace"],
            "checks": _numbers(rows, tr["limits"], delta), "extra": extra}


# -- a rank -------------------------------------------------------------------

class _Stop:
    """The step after which every rank stops, in a file all ranks map:
    -1 until rank 0 names it."""

    def __init__(self, path: Path):
        self.f = open(path, "r+b")
        self.m = mmap.mmap(self.f.fileno(), 8)

    def get(self) -> int:
        return struct.unpack_from("<q", self.m)[0]

    def set(self, k: int) -> None:
        struct.pack_into("<q", self.m, 0, k)


def join(a: dict):
    """Join a rank to the process group (NCCL on its card, gloo on the CPU
    in a rehearsal) -> (its device, the cell, its family's module)."""
    import torch
    import torch.distributed as dist

    from portbench import harness

    rank = a["rank"]
    cell = harness.find_cell(a["workload"])
    if a["rehearse"]:
        cell = harness.rehearsal(cell)
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.set_num_threads(RANK_THREADS)
    dist.init_process_group("gloo" if a["rehearse"] else "nccl",
                            init_method=f"file://{Path(a['dir']) / 'pg'}",
                            world_size=a["world"], rank=rank,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    family = harness.load_module(
        harness.BENCH_DIR / "families" / f"{cell.hf['model_type']}.py",
        f"portbench_family_{cell.hf['model_type']}")
    return dev, cell, family


def prompts(hf: dict, tr: dict, seed: int, dev):
    """The cell's prompts (``static_decode``'s) -> (lengths, tokens [B, S],
    mask [B, S])."""
    import torch

    from portbench import traffic

    r = traffic.rng(seed, "prompts")
    lens = traffic.even_lengths(*tr["prompt_len"], tr["batch"], r)
    tok_np, mask_np = traffic.left_pad(traffic.prompts(lens, hf["vocab_size"],
                                                       r), tr["bucket"])
    return (lens, torch.from_numpy(tok_np).to(dev),
            torch.from_numpy(mask_np).to(dev))


def _rank(a: dict) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from portbench import counts, inits, trace, weights_moe
    from portbench.drivers import static_decode as sd
    from portbench.reference import mixtral as reference

    rank, world, tmp = a["rank"], a["world"], Path(a["dir"])
    dev, cell, family = join(a)
    hf, tr = cell.hf, cell.traffic
    b, s, steps = tr["batch"], tr["bucket"], tr["replay_steps"]
    comp = tr.get("compression")
    raw = tr["mode"] == "raw"
    hd = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    fmt = counts.kv_format(None if raw else comp, hd)
    stop = _Stop(tmp / "stop")

    def sync():   # every rank here, the device's work done
        x = torch.zeros(1, device=dev)
        dist.all_reduce(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params = weights_moe.rank_share(hf, a["seed"], dev, rank, world)
    lens, tokens, mask = prompts(hf, tr, a["seed"], dev)
    prog = family.Program(hf, params, comp, tr["mode"], tr["max_len"], b,
                          dev, world)
    decode = sd._faulty(prog.decode, a["fault"], hf["vocab_size"])
    rope = prog.rope
    starts = inits.Inits(a["seed"], dev)
    # the router's probabilities of this rank's checked rows
    rows = sd.check_rows(lens, tr["check_rows"], a["seed"])[rank::world]
    ridx_all = torch.tensor(rows, device=dev, dtype=torch.int64)
    log = prog.router_log()

    logits0, caches = prog.prefill(tokens, mask, starts)
    tok0 = torch.argmax(logits0, dim=-1)
    del logits0
    hist = done_hist = prompt_route = None
    if log is not None:
        prompt_route = log.take_prompt().index_select(1, ridx_all)
        hist, done_hist = (torch.zeros((steps, *log.step.shape[:1],
                                        len(rows), log.step.shape[2]),
                                       device=dev) for _ in "ab")
    prompt_len = mask.sum(dim=1).to(torch.int32)
    pad_start = (s - prompt_len).to(torch.int32)
    positions = [prompt_len + j for j in range(steps)]
    snap = sd.snapshot(caches)
    kv_bytes = sd.store_bytes(caches) / (b * tr["max_len"])
    cur = tok0
    for j in range(tr["warm_steps"]):
        cur, caches = decode(caches, cur, positions[j], pad_start, j, starts)
        cur.tolist()
    sd.restore(caches, snap)
    sync()
    setup_s = time.time() - a["t_start"]

    # -- the window (static_decode's, the ranks in step) --------------------
    from torch.profiler import record_function

    stretch = trace.Stretch(a["trace"], tr["trace_from"], tr["trace_steps"])
    first, n_tr = tr["trace_from"], tr["trace_steps"]
    clock = sd.Clock(dev)
    done, served, replays = None, [], 0
    j = k = 0
    sent = {}
    cur = tok0
    t0 = time.perf_counter()
    clock.mark()
    while True:
        if j == steps:
            done, served, replays = served, [], replays + 1
            hist, done_hist = done_hist, hist
            with record_function("portbench.restore"):
                sd.restore(caches, snap)
            j, cur = 0, tok0
        if k in (first, first + n_tr):
            sent[k] = family.collective_bytes()
        with stretch.step(k, tag=j):
            with record_function("portbench.step"):
                cur, caches = decode(caches, cur, positions[j], pad_start, j,
                                     starts)
                clock.mark()
                if hist is not None:
                    torch.index_select(log.step, 1, ridx_all, out=hist[j])
                cur.tolist()
        served.append(cur)
        j += 1
        k += 1
        if rank == 0 and stop.get() < 0 and \
                time.perf_counter() - t0 >= a["seconds"]:
            stop.set(k + 1)
        if 0 <= stop.get() <= k:
            break
    t_end = time.perf_counter()
    stretch.close()
    gaps = clock.gaps_ms()
    attempted = b * (replays + (1 if served else 0))
    if done is None:  # finish the replay in progress, after the close
        while j < steps:
            cur, caches = decode(caches, cur, positions[j], pad_start, j,
                                 starts)
            if hist is not None:
                torch.index_select(log.step, 1, ridx_all, out=hist[j])
            served.append(cur)
            j += 1
        done, done_hist = served, hist
    served_tok = torch.stack([tok0] + done, dim=1)        # [B, steps + 1]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    eng = prog.eng
    graph_counts = {n: getattr(eng, n, None) for n in
                    ("graph_captures", "graph_replays", "eager_steps")}
    kinds = _step_kinds(stretch.steps)
    comm = None
    if sent.get(first) is not None and sent.get(first + n_tr) is not None:
        comm = (sent[first + n_tr] - sent[first]) / n_tr
    del caches, snap, prog, decode, served, done, eng, params, log, hist
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- this rank's share of the check --------------------------------------
    outer = weights_moe.outer(hf, a["seed"], dev)

    def layer(i):
        return weights_moe.layer(hf, a["seed"], i, dev)

    def judged(ref, routing, real, tok):
        """A row's gaps of ``tok`` [1, T + 1] below the reference's best,
        and its routing at the real positions."""
        best = ref.max(dim=-1).values
        got = torch.gather(ref, -1, tok[..., None])[..., 0]
        return {"gaps": (best - got)[0].cpu(),
                **{k: routing[k][:, 0, real].cpu()
                   for k in ("margin", "differ", "diff")}}

    mine = []
    for k_row, row in enumerate(rows):
        ridx = ridx_all[k_row:k_row + 1]
        seq = torch.cat([tokens[ridx], served_tok[ridx, :steps]], dim=1)
        real = torch.cat([mask[row].bool(),
                          torch.ones(steps, dtype=torch.bool, device=dev)])
        kw = dict(fmt=fmt, loop=(comp or {}).get("loop", 3),
                  inits=starts.for_rows(ridx, b, hf["num_key_value_heads"],
                                        hd, fmt))
        cache = "raw" if raw else "gear"
        follow = None if done_hist is None else torch.cat(
            [prompt_route[:, k_row], done_hist[:, :, k_row].transpose(0, 1)],
            1)[:, None]
        ref, routing = reference.forward(outer, layer, hf, seq, mask[ridx],
                                         cache, follow=follow, **kw)
        out = {"row": row, **judged(ref, routing, real, served_tok[ridx])}
        if a["control"]:
            low, lr = reference.forward(outer, layer, hf, seq, mask[ridx],
                                        cache, precision="fp8", **kw)
            ref, routing = reference.forward(outer, layer, hf, seq,
                                             mask[ridx], cache,
                                             follow=lr["probs"], **kw)
            out["control"] = judged(ref, routing, real, low.argmax(-1))
        mine.append(out)

    traced = stretch.summary
    metric_ctx = {
        "hf": hf, "fmt": fmt, "raw": raw, "trace": traced,
        "steps": stretch.steps, "bucket": s, "world": world,
        "prefill_len": 0 if raw else (s // fmt.group) * fmt.group,
        "pad_starts": pad_start.tolist(), "comm_bytes_per_step": comm,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else None,
    }
    e2e = {"output_tok_s": k * b / (t_end - t0),
           "itl_p95_ms": float(np.percentile(gaps, 95)),
           "setup_s": setup_s}
    extra = {"window": {"steps": k, "replays_done": replays,
                        "seconds": t_end - t0,
                        "gap_ms_median": float(np.median(gaps)),
                        "gap_ms_max": max(gaps)},
             "rope": rope}
    torch.save({"rank": rank, "e2e": e2e, "ctx": metric_ctx,
                "kv_bytes_per_token": kv_bytes, "memory_peak_bytes": peak,
                "graph_kinds": kinds, "graph_counts": graph_counts,
                "attempted": attempted, "rows": mine, "extra": extra},
               tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


def _step_kinds(steps) -> list | None:
    """The ``graph`` attribute of each counted step's root span on this
    rank; None where the program records no spans or no attribute."""
    from gear_tpu_torch import profiling

    if not hasattr(profiling, "roots") or not steps:
        return None
    recs = profiling.spans()
    last = profiling.roots("engine.decode_step", "step", recs)
    kinds = [recs[last[t]].attrs.get("graph") for t in set(steps)
             if t in last]
    return kinds if kinds and None not in kinds else None


def main(argv=None) -> None:
    """A rank's program, over the JSON arguments the parent gave."""
    ap = argparse.ArgumentParser()
    ap.add_argument("args")
    a = json.loads(ap.parse_args(argv).args)
    try:
        _rank(a)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)   # no wait on a process group a sibling left
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
