#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lidp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from lidp_tpu_torch/csrc (nvcc, in parallel);
  3. kernel parity: each panel kernel against its plain PyTorch version on
     the card in float32, on a random case at the main path's shape
     (12,288 x 12,288) and on a ragged one (1,000 rows with masked atoms,
     alpha=0 atoms and special lists); per-row outputs rtol 1e-4,
     atol 1e-5*max|ref|, scalars rel 1e-4 (float32 sums over ~1e8 pairs in
     another order); median kernel and plain times (CUDA events) and the
     FP32 bound;
  4. the main path: the 10,125-atom synthetic fluid in float32 through the
     kernels, initial forces + 20 velocity-Verlet steps, with every launch
     counter reset just before and read just after; then step 0 held
     against the float64 plain path on the card (energies rel 1e-4, epol
     abs 2e-2, forces rtol 5e-4, atol 5e-5*max);
  5. one JSON line {"kernels": [...]} with each kernel's launches, times
     and bound, then the nvidia-smi line, then the device line last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NSTEPS = 20
FP32_PEAK = 67e12        # H100 SXM FP32 CUDA-core FLOP/s (data sheet, 700 W)
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s
# wrapper -> (TPU kernel it replaces, flops per pair of its CostEstimate)
KERNELS = {
    "eind_panel": ("lidp_tpu/ops/pallas_panel.py:194", 45),
    "pair_wolf_panel": ("lidp_tpu/ops/pallas_panel.py:1386", 100),
    "dipole_panel": ("lidp_tpu/ops/pallas_panel.py:1140", 140),
}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_case(n_live, npad, L, seed, n_masked=0, dev="cuda"):
    """Random panel operands on the GPU: jittered-lattice positions, random
    charges, types 1-2, 3-atom molecules, 5% alpha=0 atoms, small dipoles,
    `n_masked` live-range atoms masked out, padding masked, and special
    lists holding each atom's molecule partners (unused slots: n_live)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    side = math.ceil(n_live ** (1 / 3))
    i = torch.arange(n_live, device=dev)
    grid = torch.stack([i // (side * side), (i // side) % side, i % side], 1)
    h = L / side
    x = torch.zeros((npad, 3), dtype=f32, device=dev)
    x[:n_live] = (grid + 0.5) * h + (torch.rand(
        (n_live, 3), generator=g, device=dev) - 0.5) * 0.4 * h

    def live(v, fill=0.0):
        out = torch.full((npad,) + v.shape[1:], fill, dtype=f32, device=dev)
        out[:n_live] = v
        return out

    mask = live(torch.ones(n_live, device=dev))
    if n_masked:
        drop = torch.randperm(n_live, generator=g, device=dev)[:n_masked]
        mask[drop] = 0.0
    alpha = live(0.5 + 1.5 * torch.rand(n_live, generator=g, device=dev))
    alpha[torch.rand(npad, generator=g, device=dev) < 0.05] = 0.0
    alpha = alpha * mask
    mu = live(0.01 * torch.randn((n_live, 3), generator=g, device=dev))
    mu = mu * (alpha != 0)[:, None]
    q = live(0.5 * torch.randn(n_live, generator=g, device=dev))
    typ = live(torch.randint(1, 3, (n_live,), generator=g,
                             device=dev).to(f32))
    mol = live((i // 3 + 1).to(f32))
    base = 3 * (torch.arange(npad, device=dev) // 3)
    sp = torch.full((npad, 8), n_live, dtype=torch.int32, device=dev)
    k = torch.arange(npad, device=dev) % 3
    sp[:, 0] = (base + (k + 1) % 3).to(torch.int32)
    sp[:, 1] = (base + (k + 2) % 3).to(torch.int32)
    sp[n_live:] = n_live
    sp = torch.where(sp < n_live, sp, n_live)
    Lt = torch.full((3,), L, dtype=f32, device=dev)
    return dict(x=x, q=q, type=typ, mol=mol, mask=mask, alpha=alpha, mu=mu,
                sp=sp.contiguous(), L=Lt)


def tabs_for(ff_pair):
    import torch

    return torch.stack([ff_pair.lj3, ff_pair.lj4, ff_pair.offset,
                        ff_pair.cut_ljsq, ff_pair.cutsq]).float().contiguous()


def kernel_calls(c, tabs, pair, s):
    """{name: (wrapper call, plain call)} on case c."""
    from lidp_tpu_torch.ops import panel

    pd, dmp = s.polar_damp, s.damping_type
    eind_args = (c["x"], c["alpha"], c["mu"], c["L"], pd)
    pw_args = (c["x"], c["q"], c["type"], c["mol"], c["mask"], tabs, c["L"],
               pair.cut_coulsq, pair.qqrd2e, pair.g_ewald)
    dp_args = (c["x"], c["q"], c["mol"], c["alpha"], c["mu"], c["mask"],
               c["L"], pd, pair.cut_coulsq, pair.qqrd2e)
    return {
        "eind_panel": (
            lambda: panel.eind_panel(*eind_args, damping_type=dmp),
            lambda: panel.eind_panel_plain(*eind_args, damping_type=dmp)),
        "pair_wolf_panel": (
            lambda: panel.pair_wolf_panel(*pw_args, sp=c["sp"]),
            lambda: panel.pair_wolf_panel_plain(*pw_args, sp=c["sp"])),
        "dipole_panel": (
            lambda: panel.dipole_panel(*dp_args, damping_type=dmp),
            lambda: panel.dipole_panel_plain(*dp_args, damping_type=dmp)),
    }


def compare(name, got, ref):
    """Per-row outputs rtol 1e-4, atol 1e-5*max|ref|; scalars rel 1e-4.
    Returns the largest per-row absolute difference and the largest |ref|
    of the per-row outputs."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst = scale = 0.0
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        if g.dim() == 2:
            err = (g - r).abs()
            tol = 1e-4 * r.abs() + 1e-5 * r.abs().max()
            bad = int((err > tol).sum())
            if bad or not torch.isfinite(g).all():
                raise AssertionError(f"{name}: {bad} per-row values off, max "
                                     f"abs err {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
            scale = max(scale, float(r.abs().max()))
        else:
            err = (g - r).abs()
            tol = 1e-4 * r.abs().reshape(-1).max().clamp(min=1e-30)
            if (err > tol).any():
                raise AssertionError(f"{name}: scalar {g.tolist()} vs "
                                     f"{r.tolist()}")
    return worst, scale


def bound_ms(name, nrows, npad):
    """Least time on the card: the larger of FP32 flops (the CostEstimate
    per pair) over the FP32 peak and the operand bytes (each input read
    once, each output written once) over the HBM rate."""
    flops = KERNELS[name][1] * nrows * npad
    ins = {"eind_panel": (4, 7), "pair_wolf_panel": (6 + 8, 7),
           "dipole_panel": (9, 10)}[name]
    outs = {"eind_panel": 3, "pair_wolf_panel": 6, "dipole_panel": 3}[name]
    nbytes = 4 * (ins[0] * nrows + ins[1] * npad + outs * nrows + 8)
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lidp_tpu_torch.kernels import build
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(build.report())

    # 3. kernel parity and timing
    sysd = polar_bench.synthetic_system()
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, "cuda")
    tabs = tabs_for(ff.pair)
    results = {}
    cases = {"main": make_case(10_125, 12_288, 60.0, seed=1),
             "ragged": make_case(1_000, 1_000, 28.0, seed=2, n_masked=50)}
    for cname, c in cases.items():
        npad = c["x"].shape[0]
        for name, (kern, plain) in kernel_calls(c, tabs, ff.pair,
                                                ff.polar).items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err, scale = compare(f"{name}[{cname}]", got, ref)
            line = (f"parity {name}[{cname}] ok: max abs err {err:.3e} "
                    f"of max |ref| {scale:.3e}")
            if cname == "main":
                ms = cuda_ms(kern, reps=20)
                pms = cuda_ms(plain, reps=3, warmup=1)
                bms, by = bound_ms(name, npad, npad)
                results[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                     bound_ms=bms, bound_by=by)
                line += (f", kernel {ms:.4f} ms, plain {pms:.3f} ms, "
                         f"bound {bms:.4f} ms ({by})")
            print(line)
    del cases
    torch.cuda.empty_cache()

    # 4. main path: every counter to 0 just before, read just after
    bench = polar_bench.build_synthetic()
    n = bench.natoms
    for name in KERNELS:
        getattr(panel, name).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f0, en0 = polar_bench.setup_forces(bench)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    f0 = f0.clone()
    t0 = time.perf_counter()
    f, per_step = polar_bench.run(bench, NSTEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {name: getattr(panel, name).launches for name in KERNELS}

    def row(tag, en):
        vals = [float(en[k]) for k in ("evdwl", "ecoul", "elong", "epol")]
        vir = en["virial"]
        if not all(math.isfinite(v) for v in vals) or \
                not bool(torch.isfinite(vir).all()):
            raise AssertionError(f"{tag}: non-finite energies {vals}")
        print(f"{tag}: evdwl {vals[0]:.6f} ecoul {vals[1]:.4f} "
              f"elong {vals[2]:.4f} epol {vals[3]:.6f} "
              f"scf_iters {en['scf_iters']}")

    print(f"main path: {n} atoms (npad {bench.npad}), float32, kernels")
    row("step 0 (init)", en0)
    for k, en in enumerate(per_step, 1):
        row(f"step {k}", en)
    for name in ("x", "v", "mu", "f"):
        if not bool(torch.isfinite(bench.arrays[name]).all()):
            raise AssertionError(f"non-finite {name} after {NSTEPS} steps")
    scf = [en0["scf_iters"]] + [en["scf_iters"] for en in per_step]
    want_eind = sum(it + 1 for it in scf)
    print(f"launches: {launches}, expected eind {want_eind}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    if launches["eind_panel"] != want_eind or \
            launches["pair_wolf_panel"] != NSTEPS + 1 or \
            launches["dipole_panel"] != NSTEPS + 1:
        raise AssertionError(f"launch counts {launches} do not match the "
                             f"path (eind {want_eind}, others {NSTEPS + 1})")
    steps_per_s = NSTEPS / t_run
    print(f"init {t_init * 1e3:.1f} ms; {NSTEPS} steps in {t_run:.3f} s = "
          f"{steps_per_s:.3f} steps/s; mean scf_iters "
          f"{statistics.mean(scf[1:]):.2f}")
    per_step_ms = {name: results[name]["ms"] * launches[name] / (NSTEPS + 1)
                   for name in KERNELS}
    print("kernel ms per step (kernel ms x launches / evaluations): " +
          ", ".join(f"{k} {v:.3f}" for k, v in per_step_ms.items()) +
          f"; step {1e3 / steps_per_s:.3f} ms")

    # step 0 against the float64 plain path on the card
    b64 = polar_bench.build_synthetic(dtype=torch.float64, panel="scan")
    f64, en64 = polar_bench.setup_forces(b64)
    torch.cuda.synchronize()
    for k in ("evdwl", "ecoul", "elong", "epol"):
        a, b = float(en0[k]), float(en64[k])
        tol = 2e-2 if k == "epol" else 1e-4 * abs(b)
        print(f"step 0 {k}: f32 kernels {a:.6f}, f64 plain {b:.6f}")
        if abs(a - b) > tol:
            raise AssertionError(f"step 0 {k}: {a} vs float64 {b}")
    ref = f64[:n]
    ferr = (f0[:n].double() - ref).abs()
    fmax = float(ref.abs().max())
    if bool((ferr > 5e-4 * ref.abs() + 5e-5 * fmax).any()):
        raise AssertionError(f"step 0 forces vs float64: max abs err "
                             f"{float(ferr.max()):.3e} (max |f| {fmax:.3e})")
    print(f"step 0 forces vs float64 plain: max abs err "
          f"{float(ferr.max()):.3e} of max |f| {fmax:.3e}")
    print(f"steps_per_s {steps_per_s:.4f}")

    # 5. results
    out = []
    for name, (replaces, _) in KERNELS.items():
        r = results[name]
        out.append(dict(name=name, route="cuda",
                        source=f"lidp_tpu_torch/csrc/{name}.cu",
                        replaces=replaces, launches=launches[name],
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": out}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
