#!/usr/bin/env python3
"""A script's first and second run through the port on one GPU, two
checkouts alternated, each run in a fresh process.

    python3 scripts/first_run_ab.py --tree _tree/parent [--seq PCCPPC]
        [--path H|O]

The input is chip_smoke.py's path H (the default): the 10,125-atom
polarizable fluid (fluid_script_case), float64 at polar precision 1e-11,
5 steps on the panel engine; or its path O: the fluid at O_SIDE (1,536
atoms) with `kspace_style pppm 1e-4`, 5 steps on the dense route.  Each
process of the sequence (P: the checkout at
`--tree`, C: this one) writes the input, runs it twice through
LammpsScript and prints both runs' `Loop time` lines (setup included):
the first run carries what a fresh process pays once (the kernels'
build in a checkout's first process, the CUDA context, the allocator's
first requests), the second the run alone.  Each line names the card
and its power limit.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
import chip_smoke
from lidp_tpu_torch.io.script import LammpsScript
work = tempfile.mkdtemp()
if sys.argv[2] == "H":
    _, path = chip_smoke.fluid_script_case(work)
else:
    chip_smoke.fluid_script_case(work, n_side=chip_smoke.O_SIDE)
    path = os.path.join(work, "in.o")
    with open(path, "w") as fh:
        fh.write(chip_smoke.kspace_script(chip_smoke.FLUID_SCRIPT,
                                          "pppm 1e-4"))
for k in range(2):
    logs = []
    s = LammpsScript(dtype=torch.float64, log=logs.append)
    s.variables.update(prec="1e-11", nstep="5")
    s.file(path)
    loop = [line for line in logs if line.startswith("Loop time")][0]
    print(f"{sys.argv[1]} run {k + 1}: {loop}; {chip_smoke.smi_line()}")
    del s
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="the other checkout (P), e.g. the parent unpacked "
                    "by git archive")
    ap.add_argument("--seq", default="PCCPPC")
    ap.add_argument("--path", default="H", choices=("H", "O"))
    args = ap.parse_args()
    trees = {"P": os.path.abspath(args.tree), "C": ROOT}
    for name in args.seq:
        out = subprocess.run([sys.executable, "-c", RUN, name, args.path],
                             cwd=trees[name], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
