#!/usr/bin/env python3
"""Where the time of the port's polarizable step goes, on one GPU.

    python scripts/profile_torch_polar.py [--steps 10] [--trace FILE]

Builds the 10,125-atom synthetic fluid of lidp_tpu_torch.models.polar_bench
(float32, CUDA panel kernels), runs the initial forces and 3 warm-up steps,
then times `--steps` steps twice:

  1. CUDA events around each phase of PolarStep (pair_wolf panel, special
     correction, Ewald k-sum, each eind matvec, dipole panel) — the CG's
     remaining vector work and host reads are the step time less the
     phases;
  2. torch.profiler (CPU + CUDA) over the same number of steps: device time
     by kernel name and the device's busy and idle share of the window;
     with --trace, its Chrome trace is written to FILE.

Prints the card (nvidia-smi name, power limit) first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class PhaseTimer:
    """Wraps callables so each call is bracketed by CUDA events; times are
    read once, after the window."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        import torch

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out

        return timed

    def totals(self):
        return {name: (sum(s.elapsed_time(e) for s, e in evs), len(evs))
                for name, evs in self.events.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_polar: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lidp_tpu_torch.models import polar_bench

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    bench = polar_bench.build_synthetic()
    polar_bench.setup_forces(bench)
    polar_bench.run(bench, 3)
    torch.cuda.synchronize()

    # 1. phase times by CUDA events
    st = bench.step
    timer = PhaseTimer()
    phases = {"_pair_wolf": "pair_wolf_panel",
              "_special_correction": "special_correction",
              "_ewald": "ewald_ksum", "_eind": "eind_panel",
              "_dipole": "dipole_panel"}
    saved = {attr: st.__dict__.get(attr) for attr in phases}
    for attr, name in phases.items():
        setattr(st, attr, timer.wrap(name, getattr(st, attr)))
    t0 = time.perf_counter()
    _, per_step = polar_bench.run(bench, args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for attr, fn in saved.items():     # back to the unwrapped phases
        if fn is None:
            delattr(st, attr)
        else:
            setattr(st, attr, fn)
    scf = [e["scf_iters"] for e in per_step]
    step_ms = 1e3 * wall / args.steps
    print(f"events window: {args.steps} steps, {args.steps / wall:.3f} "
          f"steps/s, {step_ms:.3f} ms/step, scf_iters mean "
          f"{statistics.mean(scf):.2f}")
    phase_sum = 0.0
    for name, (ms, calls) in timer.totals().items():
        per = ms / args.steps
        phase_sum += per
        print(f"  {name:20s} {per:8.3f} ms/step  {calls / args.steps:5.2f} "
              f"calls/step  {100 * per / step_ms:5.1f}%")
    rest = step_ms - phase_sum
    print(f"  {'rest (CG vectors, host reads, integrator)':20s} "
          f"{rest:8.3f} ms/step  {100 * rest / step_ms:5.1f}%")

    # 2. torch.profiler over the same number of steps
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        polar_bench.run(bench, args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side entries only: the kernels themselves, not the
        # operators that launched them (which would count them twice)
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, ev.count, ev.key))
    rows.sort(reverse=True)
    if not rows:
        print("profiler window: key_averages() holds no device-side "
              "entries; the CUDA-event phases above stand alone")
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profiler window: {args.steps} steps in {wall * 1e3:.1f} ms; "
          f"device busy {busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}%"
          f", idle {100 * (1 - busy_ms / (wall * 1e3)):.1f}%")
    for dev, count, key in rows[:15]:
        print(f"  {dev / 1e3 / args.steps:8.3f} ms/step  {count / args.steps:6.1f}"
              f" calls/step  {key[:90]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
