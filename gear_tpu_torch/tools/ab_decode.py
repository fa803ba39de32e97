#!/usr/bin/env python3
"""Compare the decode kernels of two trees of this repository on one card,
in one call.

    python3 gear_tpu_torch/tools/ab_decode.py PARENT . . PARENT

Each argument is the root of a checkout (for the parent: ``git archive
<commit> | tar -x -C <dir>`` into a directory that ``.gitignore`` lists, such
as ``gear_tpu_torch/_build/parent``). For each, in the order given and in a
process of its own, the kernels are built from that tree's sources and
``chip_smoke.phase_decode`` times every dense case; a tree that has the paged
kernel also times two paged cases. One line per tree with the registers a
thread of every ``decode_split_kernel`` instantiation uses (``ptxas -v``),
one with the device ms of each case. Give the trees in the order parent,
change, change, parent, so that drift of the card shows.
"""
import subprocess
import sys

CODE = r'''
import json, re, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from gear_tpu_torch.kernels import _build

_, build_log = _build.build()
_build.library()
regs, cur = {}, None
for ln in build_log.splitlines():
    m = re.search(r"decode_split_kernelILi(\d+)ELi(\d+)ELb(\d)E(Lb(\d)E)?", ln)
    if m and "Compiling" in ln:
        cur = "/".join((m.group(1), m.group(2), m.group(3), m.group(5) or "-"))
    m = re.search(r"Used (\d+) registers", ln)
    if m and cur:
        regs[cur], cur = int(m.group(1)), None
print("REGS bits/gq/base8/paged:", json.dumps(regs))

timer = cs.Timer(torch)
rows = {}
cs.log = lambda *a: None
decode_case = cs.decode_case


def timed_case(torch_, timer_, gen, name, *args, **kw):
    res = decode_case(torch_, timer_, gen, name, *args, **kw)
    rows[name] = round(res["ms"], 4)
    return res


cs.decode_case = timed_case
cs.phase_decode(torch, timer, {})
if hasattr(cs, "paged_case"):
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, kw, extra in (
            ("paged gear, serving path shapes", dict(outliers_per_block=162),
             dict(prompt_lens=(3008, 2944, 2880, 1100, 640, 320),
                  max_len=4096, n_pages=96)),
            ("paged gearl", dict(), {})):
        res = cs.paged_case(torch, timer, gen, name, kw, 32, 32, 4, None,
                            None, **extra)
        rows[name] = round(res["ms"], 4)
print("MS", json.dumps(rows))
'''


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            print(tree, "failed:", out.stderr[-2000:], flush=True)
            return 1
        for ln in out.stdout.splitlines():
            if ln.startswith(("REGS", "MS")):
                print(tree, ln, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
