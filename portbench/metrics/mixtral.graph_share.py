"""mixtral.graph_share: the share, in %, of the counted decode steps, on
every rank together, that the program replayed from a CUDA graph: those
whose ``engine.decode_step`` root span carries ``graph="replay"``. Each
rank reads its own spans (only a step's root span is recorded in a
replay); None where a rank records no ``graph`` attribute. Layer: model
step."""
from __future__ import annotations


def read(ctx):
    ranks = ctx.get("graph_kinds")
    if not ranks or any(k is None for k in ranks):
        return None
    kinds = [k for r in ranks for k in r]
    return 100.0 * kinds.count("replay") / len(kinds)
