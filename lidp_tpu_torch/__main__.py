"""CLI entry point (lidp_tpu/__main__.py):

    python -m lidp_tpu_torch -in script.input [-log file|none] [-var k v]...
        [-echo style] [--f32] [-device cuda|cpu]

The analog of the reference's lmp binary (main.cpp:53; CLI flags
lammps.cpp:109-221, the subset -in, -log, -var, -echo).  Runs in float64
(the JAX CLI's default), float32 with --f32; on the GPU unless given
-device cpu, and raises without one.  Each output line is printed and
written to the log file.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lidp_tpu_torch")
    ap.add_argument("-in", dest="infile", required=True)
    ap.add_argument("-log", dest="logfile", default="log.lidp")
    ap.add_argument("-var", dest="vars", nargs=2, action="append", default=[])
    ap.add_argument("-echo", dest="echo", default="none")
    ap.add_argument("--x64", action="store_true", default=True)
    ap.add_argument("--f32", dest="x64", action="store_false")
    ap.add_argument("-device", dest="device", default="cuda",
                    choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    logf = open(args.logfile, "w") if args.logfile != "none" else None

    def log(line):
        print(line, flush=True)
        if logf:
            logf.write(line + "\n")
            logf.flush()

    try:
        script = LammpsScript(
            dtype=torch.float64 if args.x64 else torch.float32,
            device=args.device, log=log)
        for k, v in args.vars:
            script.variables[k] = v
        script.file(args.infile)
    finally:
        if logf:
            logf.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
