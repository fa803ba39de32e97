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
every case of ``phase_pack`` (B2, B3). Per tree one line with the registers
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
decode_case = cs.decode_case


def timed_case(torch_, timer_, gen, name, *args, **kw):
    res = decode_case(torch_, timer_, gen, name, *args, **kw)
    rows[name] = round(res["ms"], 4)
    return res


def flash_log(*parts):
    ln = " ".join(str(p) for p in parts)
    m = re.search(r"flash hkv=(\d+) hq=(\d+) batch=(\d+) max_len=\d+ "
                  r"length=(\d+) pad=(.*?) window=(\S+) .*kernel_ms=(\S+) "
                  r".*library_ms=(\S+)", ln)
    if m:
        hkv, hq, b, n, pad, win, ms, lib = m.groups()
        name = f"flash B={b} {hkv}/{hq} heads {n} tokens pad={pad} window={win}"
        rows[name] = round(float(ms), 4)
        rows[name + " (sdpa)"] = round(float(lib), 4)


cs.log = lambda *a: None
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


def pack_log(*parts):
    ln = " ".join(str(p) for p in parts)
    m = re.search(r"pack (\w+) bits=(\d) \[(\S+)\]( float32| bfloat16)?"
                  r"( outlier-cleaned)? bit-equal kernel_ms=(\S+)", ln)
    if m:
        kern, bits, shape, dtype, cleaned, ms = m.groups()
        name = (f"{kern} bits={bits} [{shape}] "
                f"{(dtype or ' float32').strip()}{cleaned or ''}")
        rows[name] = round(float(ms), 4)


cs.log = flash_log
cs.phase_flash(torch, timer, {})
cs.log = pack_log
cs.phase_pack(torch, timer, {})
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
        log = "\n".join(ln[4:] for ln in out.stdout.splitlines()
                        if ln.startswith("LOG "))
        usage = _build.ptxas_usage(log)
        print(tree, "REGS (registers, spill stores, spill loads):",
              json.dumps(usage), flush=True)
        for ln in out.stdout.splitlines():
            if ln.startswith("MS"):
                print(tree, ln, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
