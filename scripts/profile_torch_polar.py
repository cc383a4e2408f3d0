#!/usr/bin/env python3
"""Where the time of the port's polarizable step goes, on one GPU.

    python scripts/profile_torch_polar.py [--steps 10] [--trace FILE]
    python scripts/profile_torch_polar.py --path host64 [--steps 5]

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

--path host64 profiles the float64 / polar_precision 1e-11 host-phase
path instead (HostPolarForces with the mixed-precision solve through the
f64-grade kernels): after the initial forces and 2 warm-up steps, `--steps`
steps with HostPolarForces' own CUDA-event ticks (pair, Ewald k-blocks,
each outer float64 pass, each inner float32 CG, dipole), summed per step,
then the same torch.profiler window.

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


def fused32_events(bench, run_steps, steps):
    """Phase times of the float32 fused step by CUDA events around the
    panels, the special correction and the Ewald sum."""
    import torch

    st = bench.step
    timer = PhaseTimer()
    panels = {"pair_wolf": "pair_wolf_panel", "eind": "eind_panel",
              "dipole": "dipole_panel"}
    methods = {"_special_correction": "special_correction",
               "_ewald": "ewald_ksum"}
    saved = dict(st._k)
    for key, name in panels.items():
        st._k[key] = timer.wrap(name, st._k[key])
    for attr, name in methods.items():
        setattr(st, attr, timer.wrap(name, getattr(st, attr)))
    t0 = time.perf_counter()
    per_step = run_steps(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st._k.update(saved)                # back to the unwrapped phases
    for attr in methods:
        delattr(st, attr)
    scf = [e["scf_iters"] for e in per_step]
    step_ms = 1e3 * wall / steps
    print(f"events window: {steps} steps, {steps / wall:.3f} "
          f"steps/s, {step_ms:.3f} ms/step, scf_iters mean "
          f"{statistics.mean(scf):.2f}")
    phase_sum = 0.0
    for name, (ms, calls) in timer.totals().items():
        per = ms / steps
        phase_sum += per
        print(f"  {name:20s} {per:8.3f} ms/step  {calls / steps:5.2f} "
              f"calls/step  {100 * per / step_ms:5.1f}%")
    rest = step_ms - phase_sum
    print(f"  {'rest (CG vectors, host reads, integrator)':20s} "
          f"{rest:8.3f} ms/step  {100 * rest / step_ms:5.1f}%")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    ap.add_argument("--path", choices=["fused32", "host64"],
                    default="fused32")
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
    if args.path == "host64":
        bench = polar_bench.build_synthetic(dtype=torch.float64,
                                            precision=1e-11)
        polar_bench.host_setup_forces(bench, mixed=True)
        for _ in range(2):
            polar_bench.host_cg_step(bench, mixed=True)
        torch.cuda.synchronize()

        def run_steps(k):
            return [polar_bench.host_cg_step(bench, mixed=True)[1]
                    for _ in range(k)]

        # 1. phase times by HostPolarForces' own CUDA-event ticks
        bench.hpf.timing = True
        sums, wall, scf = {}, 0.0, []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            en = run_steps(1)[0]
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            scf.append(en["scf_iters"])
            for label, ms in bench.hpf.last_timing.items():
                sums[label] = sums.get(label, 0.0) + ms
        bench.hpf.timing = False
        step_ms = 1e3 * wall / args.steps
        print(f"events window (host64, each step synchronised for its "
              f"ticks): {args.steps} steps, {step_ms:.3f} ms/step, "
              f"scf_iters mean {statistics.mean(scf):.2f}")
        for label, ms in sums.items():
            per = ms / args.steps
            print(f"  {label:20s} {per:8.3f} ms/step  "
                  f"{100 * per / step_ms:5.1f}%")
        t0 = time.perf_counter()
        run_steps(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"untimed window: {args.steps} steps, "
              f"{args.steps / wall:.3f} steps/s, "
              f"{1e3 * wall / args.steps:.3f} ms/step")
    else:
        bench = polar_bench.build_synthetic()
        polar_bench.setup_forces(bench)
        polar_bench.run(bench, 3)
        torch.cuda.synchronize()

        def run_steps(k):
            return polar_bench.run(bench, k)[1]

        fused32_events(bench, run_steps, args.steps)

    # 2. torch.profiler over the same number of steps
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(args.steps)
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
