#!/usr/bin/env python3
"""Compare the attention kernels of two trees of this repository on one
card, in one call.

    python3 gear_tpu_torch/tools/ab_kernels.py PARENT . . PARENT

Each argument is the root of a checkout (for the parent: ``git archive
<commit> | tar -x -C <dir>`` into a directory that ``.gitignore`` lists, such
as ``gear_tpu_torch/_build/parent``). For each, in the order given and in a
process of its own, the kernels are built from that tree's sources and
timed with that tree's ``chip_smoke.py``: every case of ``phase_decode``
(B1), two paged cases (B5: the serving path's shapes, and GEARL over rows of
1,900 tokens and less), every case of ``phase_flash`` (B4) with
``scaled_dot_product_attention`` timed beside it in the same process, and
every case of ``phase_pack`` (B2, B3), and B1 and B4 at the benchmark
cells' shapes (and at GQ 2 and 8). Per tree one line with the registers
and spills (``ptxas -v``) of every kernel instantiation, one with the
device ms of each case. Give the trees in the order parent, change,
change, parent, so that drift of the card shows.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from gear_tpu_torch.kernels import _build  # noqa: E402

CODE = r'''
import json, re, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from gear_tpu_torch.kernels import _build

_, build_log = _build.build()
_build.library()
for ln in build_log.splitlines():
    if re.search(r"Compiling entry function|spill stores|Used \d+ registers", ln):
        print("LOG", ln)

timer = cs.Timer(torch)
rows = {}
decode_case, flash_case, pack_cases = cs.decode_case, cs.flash_case, \
    cs.pack_cases


def timed_case(torch_, timer_, gen, name, *args, **kw):
    res = decode_case(torch_, timer_, gen, name, *args, **kw)
    rows[name] = round(res["ms"], 4)
    return res


def timed_flash(torch_, timer_, gen, hkv, hq, b, t, length, pad, window,
                **kw):
    res = flash_case(torch_, timer_, gen, hkv, hq, b, t, length, pad, window,
                     **kw)
    name = f"flash B={b} {hkv}/{hq} heads {length} tokens pad={pad} " \
           f"window={window} d={kw.get('d', 128)}"
    rows[name] = round(res["ms"], 4)
    rows[name + " (sdpa)"] = round(res["library_ms"], 4)
    return res


def timed_packs(torch_, timer_, x, xk, bits, g, note):
    res = pack_cases(torch_, timer_, x, xk, bits, g, note)
    for r in res:
        rows[f"{r['name']} bits={bits} {list(x.shape)} {note}"] = \
            round(r["ms"], 4)
    return res


cs.log = lambda *a: None
cs.decode_case, cs.flash_case, cs.pack_cases = (timed_case, timed_flash,
                                                timed_packs)
try:   # the rows timed so far are printed even if a phase fails
    cs.phase_decode(torch, timer, {})
    # B1 at the cells' shapes, 70 steps into their windows: mistral7b-gear4-
    # decode-4k (batch 16, 8 / 32 heads, int4, GEAR outliers, window 4096) and
    # one rank of mixtral8x7b-gear2-tp4-8k (batch 16, 2 / 8 heads, int2)
    gen = torch.Generator(device="cuda").manual_seed(19)
    pad_4k = [52 + 25 * i for i in range(16)]
    pad_8k = [42 + 23 * i for i in range(16)]
    timed_case(torch, timer, gen, "cell gear4", dict(outliers_per_block=162),
               8, 32, pad_4k, 4096, b=16, t=4608, n_prefill=4352, n_append=70)
    timed_case(torch, timer, gen, "cell mixtral rank",
               dict(outliers_per_block=162, bits=2), 2, 8, pad_8k, None, b=16,
               t=8448, n_prefill=8192, n_append=70)
    # the same rows at GQ 2 and 8 (twice and half the kv heads), for the
    # decode kernel's choice of products at each GQ
    for gq, hkv4, hkv8 in ((2, 16, 4), (8, 4, 1)):
        timed_case(torch, timer, gen, f"cell gear4 at GQ {gq}",
                   dict(outliers_per_block=162), hkv4, 32, pad_4k, 4096,
                   b=16, t=4608, n_prefill=4352, n_append=70)
        timed_case(torch, timer, gen, f"cell mixtral rank at GQ {gq}",
                   dict(outliers_per_block=162, bits=2), hkv8, 8, pad_8k,
                   None, b=16, t=8448, n_prefill=8192, n_append=70)
    if hasattr(cs, "paged_case"):
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name, kw, extra in (
                ("paged gear, serving path shapes",
                 dict(outliers_per_block=162),
                 dict(prompt_lens=(3008, 2944, 2880, 1100, 640, 320),
                      max_len=4096, n_pages=96)),
                ("paged gearl", dict(), {})):
            res = cs.paged_case(torch, timer, gen, name, kw, 32, 32, 4, None,
                                None, **extra)
            rows[name] = round(res["ms"], 4)
    cs.phase_flash(torch, timer, {})
    # B4 at mistral7b-raw-decode-4k's shape, 70 steps into its window
    timed_flash(torch, timer, gen, 8, 32, 16, 4608, 4422, pad_4k, 4096)
    cs.phase_pack(torch, timer, {})
finally:
    print("MS", json.dumps(rows))
'''


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    failed = 0
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:   # the other trees' turns still run
            print(tree, "failed:", out.stderr[-2000:], flush=True)
            failed = 1
        log = "\n".join(ln[4:] for ln in out.stdout.splitlines()
                        if ln.startswith("LOG "))
        usage = _build.ptxas_usage(log)
        print(tree, "REGS (registers, spill stores, spill loads):",
              json.dumps(usage), flush=True)
        for ln in out.stdout.splitlines():
            if ln.startswith("MS"):
                print(tree, ln, flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
