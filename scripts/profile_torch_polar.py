#!/usr/bin/env python3
"""Where the time of the port's polarizable step goes, on one GPU.

    python scripts/profile_torch_polar.py [--steps 10] [--trace FILE]
    python scripts/profile_torch_polar.py --path host64 [--steps 5]
    python scripts/profile_torch_polar.py --path host32 [--steps 5]
    python scripts/profile_torch_polar.py --path rigid [--steps 10]
    python scripts/profile_torch_polar.py --path lj --steps 400 [--scale 4]
    python scripts/profile_torch_polar.py --path ljcells --steps 100
    python scripts/profile_torch_polar.py --path eind [--rounds 7]
    python scripts/profile_torch_polar.py --path dipole [--rounds 7]
    python scripts/profile_torch_polar.py --path pair [--rounds 7]
    python scripts/profile_torch_polar.py --path lj --variants --scale 4 \
        [--tree OTHER] [--rounds 7]
    python scripts/profile_torch_polar.py --path ab --tree OTHER --seq F \
        [--pairs 10]          # --seq B: path B and its wolf tick
    python scripts/profile_torch_polar.py --path cutoff [--tree OTHER]

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

--path rigid does the same for chip_smoke.py's path G: the fluid as 3,375
rigid molecules through FastPolarRunner (polar_bench.build_rigid, float32,
fused), a thermo row a step; the step's rest is then the CG's vector work,
the rigid integrator and the thermo rows.

--path host64 profiles the float64 / polar_precision 1e-11 host-phase
path instead (HostPolarForces with the mixed-precision solve through the
f64-grade kernels): after the initial forces and 2 warm-up steps, `--steps`
steps with HostPolarForces' own CUDA-event ticks (pair, Ewald k-blocks,
each outer float64 pass, each inner float32 CG, dipole), summed per step,
then the same torch.profiler window.  --path host32 does the same for
chip_smoke.py's path B, the float32 host phases with pure CG (ticks pair,
Ewald k-blocks, wolf, the CG, dipole).

--path lj profiles the LJ melt of lidp_tpu_torch.models.lj_melt through
SlotRunner (float32, `--scale 1` = 32,000 atoms), --path ljcells the same
melt through the generic Runner on cells: after setup and 100 warm-up
steps, `--steps` steps (a multiple of 20 holds whole rebuild periods) with
CUDA events around the force evaluation and the rebuild (re-binning and
re-slotting, amortised over the steps), the rest being the integrator's
elementwise work and the gaps between launches; then the same
torch.profiler window.

--path eind times design variants of the whole-panel eind kernel
(csrc/eind_panel.cuh), each the committed source with one choice changed,
built from a patched copy of csrc/ into
lidp_tpu_torch/_build/variants/eind_panel/ (see VARIANTS), on
chip_smoke.py's 12,288-row main case in float32 and float64: `--rounds`
rounds, each timing every variant in turn (the order
rotated from round to round) by 20 launches queued between two CUDA
events (the kernel and its sum, no wrapper), the median over rounds; each
variant is held to eind_panel_plain at chip_smoke.py's bars, with its
registers, spills, instruction mix of the damped kernel's SASS
(cuobjdump -sass), the share of warp votes that skipped the exponential
and whether its bits equal the committed kernel's.  The committed kernel
through its wrapper (`wrapper[...]`) is timed in the same rounds, after
2,000 warm-up launches.

--path dipole does the same for the whole-panel dipole kernel
(csrc/dipole_panel.cuh; see DIPOLE_VARIANTS: the tile of each dtype, the
rows per warp vote, the warp skips compiled out), built into
lidp_tpu_torch/_build/variants/dipole_panel/, each held to
dipole_panel_plain at chip_smoke.py's bars with its scalars' ratio to their
bar, its registers, spills, SASS mix, the shares of warp votes that skipped
the charge-dipole and the dipole-dipole block, and whether its bits equal
the committed kernel's; beside them the committed wrapper and its strip
form (the row form) at the same shape, after 500 warm-up launches.

--path pair does the same for the whole-panel pair kernel
(csrc/pair_panel.cuh; see PAIR_VARIANTS: the tile of each dtype, the rows
per warp vote, CTAs per SM, the warp skip and the tile-pair test compiled
out), the float32 form of pair_wolf_panel.cu and the float64 form of
pair_panel_df.cu with the field, built into
lidp_tpu_torch/_build/variants/pair_panel/, each held to
pair_wolf_panel_plain at chip_smoke.py's bars, with its registers, spills,
SASS mix, the shares of warp votes skipped and of tile pairs dropped, and
whether its bits equal the committed kernel's; beside them the committed
wrappers (pair_wolf_panel, pair_panel_df with mol) and their strip form.
With them the whole wolf_panel kernel's
variants (WOLF_VARIANTS: the same template with FORCE false, its tile,
rows per vote, CTAs per SM, the skips compiled out; labels `[wolf]`),
built from wolf_panel.cu into lidp_tpu_torch/_build/variants/wolf_panel/
and held to wolf_panel_plain, beside the wolf_panel wrapper and its strip
form (the parent's row kernel), in the same rounds.

--path lj --variants times design variants of the LJ cell kernel
(csrc/lj_cell.cuh) in the same way, each the committed source with one
choice changed (see LJ_VARIANTS: the reciprocal, the columns and z-cells
a CTA owns, rows per thread, CTAs per SM, threads per CTA and per row
group; and two timing probes), with `--tree`
also that checkout's slot_lj_forces.cu (e.g. the parent commit), on the
grid of SlotRunner's state after setup and 100 steps of the melt at
`--scale` (4: path E4's 2,048,000 atoms) and at scale 1 (path E's 32,000
atoms, labels `@scale1`): each variant held to
slot_lj_forces_plain at chip_smoke.py's bars with need_ev off and on, its
registers, spills and the SASS mix of the kernel without energy and
virial, timed by 20 launches queued between two CUDA events over
`--rounds` rounds (order rotated), beside the committed wrapper.

--path seq drives the paths of `--seq` (A, B, C, E, F, E4,
comma-separated, in order) in one process as chip_smoke.py times them,
through the lidp_tpu_torch of `--tree` (default: this checkout), and
prints their steps/s: A 20 fused float32 steps, B 5 float32 host steps
(pure CG), C 5 float64/1e-11 mixed host steps, E 400 SlotRunner steps
after 100, F 100 Runner steps on cells, E4 100 SlotRunner steps at
2,048,000 atoms; after B's timed steps, 5 more with HostPolarForces'
CUDA-event ticks give the median of its `wolf` tick (the Wolf field
phase, ms a step).  SW, SP and SD time the pair kernels' strip form
(cols = all atoms, row0 = 0) on chip_smoke.py's 12,288-row main case:
pair_wolf_panel, pair_panel (float32) and pair_panel_df with the field
(float64), 20 calls queued between two CUDA events, 5 times, the median
given as calls/s; WW, WP and WD the same kernels' whole form; SM and SN
the dipole kernels' strip form (dipole_panel float32, dipole_panel_df
float64), WM and WN their whole form.  --path ab
runs `--path seq` `--pairs` times for this checkout and for `--tree`
(another checkout, e.g. the parent commit from `git archive`), one
process each, alternated (this, other; then other, this) after one
untimed warm-up process each, and prints each path's values (and B's
wolf tick), median and quartiles per checkout.

--path cutoff runs the pair kernels of `--tree`'s lidp_tpu_torch (default
this checkout) on this checkout's chip_smoke.cutoff_pairs_case, a pair at
exactly the outer cutoff and one one ulp inside it that a contracted rsq
puts on the other side, and the dipole kernels on its
dipole_cutoff_case (one polar atom), in their strip form (cols = all
atoms, row0 = 0) and whole: the rows that take a force and their largest
|f|, beside the plain version's (a parent's kernels against this
one's).

Prints the card (nvidia-smi name, power limit) first.
"""

from __future__ import annotations

import argparse
import json
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


def lj_events(path, scale, steps):
    """Build the melt, warm it up, time `steps` steps with CUDA events
    around the force evaluations and the rebuilds; returns run_steps for
    the profiler window."""
    import torch

    from lidp_tpu_torch.integrate import driver
    from lidp_tpu_torch.models import lj_melt

    slots = path == "lj"
    melt = lj_melt.build(scale=scale, dtype=torch.float32,
                         neighbor="slots" if slots else "cells")
    runner = melt.runner
    cfg = runner.neighbor_cfg
    print(f"{melt.natoms} atoms, float32, "
          f"{'SlotRunner' if slots else 'Runner on cells'}, grid "
          f"{cfg.nbins} x cap {cfg.cap}")
    state = list(runner.setup(melt.system))

    def run_steps(k):
        state[:] = runner.run(*state, k)

    run_steps(100)
    torch.cuda.synchronize()
    timer = PhaseTimer()
    if slots:
        owner, names = runner, {"_force": "force (slot_lj_forces + stack)",
                                "_slotify": "rebuild (re-bin, re-slot)"}
    else:
        owner, names = driver, {
            "compute_forces": "force (compute_forces, cell_pair_forces_lj)",
            "_rebuild": "rebuild (wrap, build_cells)"}
    saved = {attr: getattr(owner, attr) for attr in names}
    for attr, name in names.items():
        setattr(owner, attr, timer.wrap(name, saved[attr]))
    t0 = time.perf_counter()
    run_steps(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for attr, fn in saved.items():
        if slots:
            delattr(owner, attr)       # back to the class's own method
        else:
            setattr(owner, attr, fn)
    if bool(state[2].overflow):
        raise AssertionError("a cell overflowed its capacity")
    step_ms = 1e3 * wall / steps
    print(f"events window: {steps} steps, {steps / wall:.2f} steps/s, "
          f"{step_ms:.4f} ms/step")
    phase_sum = 0.0
    for name, (ms, calls) in timer.totals().items():
        per = ms / steps
        phase_sum += per
        print(f"  {name:45s} {per:8.4f} ms/step  {calls / steps:5.2f} "
              f"calls/step  {100 * per / step_ms:5.1f}%")
    rest = step_ms - phase_sum
    print(f"  {'rest (integrator elementwise, launch gaps)':45s} "
          f"{rest:8.4f} ms/step  {100 * rest / step_ms:5.1f}%")
    return run_steps


# --path eind: (what changes, [(file in csrc/, text, replacement)])
_ROT = """  T cx = T(0), cy = T(0), cz = T(0);  // the sum of column c0 + (lane+t)&31
#pragma unroll 2
  for (int t = 0; t < 32; ++t) {
    const int c = (lane + t) & 31;
    const Col<T> cj = get_col(scol[w], c);"""
_BCAST = """  T cx = T(0), cy = T(0), cz = T(0);  // the sum of column c0 + lane
#pragma unroll 2
  for (int t = 0; t < 32; ++t) {
    const int c = t;
    const Col<T> cj = get_col(scol[w], c);"""
_ROT_SUM = """      const T si = c1[r] * (mxi[r] * dx[r] + myi[r] * dy[r] + mzi[r] * dz[r]);
      cx += si * dx[r];
      cx += c2[r] * mxi[r];
      cy += si * dy[r];
      cy += c2[r] * myi[r];
      cz += si * dz[r];
      cz += c2[r] * mzi[r];
    }
    // column c's sum goes to the lane that meets it at step t + 1
    const int src = (lane + 1) & 31;
    cx = __shfl_sync(FULL, cx, src);
    cy = __shfl_sync(FULL, cy, src);
    cz = __shfl_sync(FULL, cz, src);
  }"""
_BCAST_SUM = """      const T si = c1[r] * (mxi[r] * dx[r] + myi[r] * dy[r] + mzi[r] * dz[r]);
      sx += si * dx[r];
      sx += c2[r] * mxi[r];
      sy += si * dy[r];
      sy += c2[r] * myi[r];
      sz += si * dz[r];
      sz += c2[r] * mzi[r];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx += __shfl_xor_sync(FULL, sx, off);
      sy += __shfl_xor_sync(FULL, sy, off);
      sz += __shfl_xor_sync(FULL, sz, off);
    }
    if (lane == t) cx = sx, cy = sy, cz = sz;
  }"""
VARIANTS = {
    "kept": ("the committed source", []),
    "vote1": ("the warp vote over 1 row x 32 columns (G = 1)",
              [("eind_panel.cuh", "constexpr int G = 2;",
                "constexpr int G = 1;")]),
    "vote4": ("the warp vote over 4 rows x 32 columns (G = 4)",
              [("eind_panel.cuh", "constexpr int G = 2;",
                "constexpr int G = 4;")]),
    "rint2add": ("the minimum image's rint as (v + 1.5*2^23) - 1.5*2^23 "
                 "(2^52 in double) in place of FRND",
                 [("panel_common.cuh", "{ return rintf(v); }",
                   "{ return __fadd_rn(__fadd_rn(v, 12582912.f), "
                   "-12582912.f); }"),
                  ("panel_common.cuh", "{ return rint(v); }",
                   "{ return __dadd_rn(__dadd_rn(v, 6755399441055744.0), "
                   "-6755399441055744.0); }")]),
    "broadcast": ("all 32 lanes on one column per step, its sum reduced "
                  "by a 5-level xor-shuffle tree, in place of the "
                  "rotating column sums",
                  [("eind_panel.cuh", _ROT, _BCAST),
                   ("eind_panel.cuh", "    T dx[RW], dy[RW], dz[RW], "
                    "rsq[RW], c1[RW], c2[RW];\n",
                    "    T dx[RW], dy[RW], dz[RW], rsq[RW], c1[RW], "
                    "c2[RW];\n    T sx = T(0), sy = T(0), sz = T(0);\n"),
                   ("eind_panel.cuh", _ROT_SUM, _BCAST_SUM)]),
    "rsqrtf": ("float32 rsqrt by rsqrtf (its rescaling of subnormal "
               "inputs included) in place of rsqrt.approx.ftz.f32",
               [("panel_common.cuh", 'asm("rsqrt.approx.ftz.f32 %0, %1;" '
                 ': "=f"(y) : "f"(v));', "y = rsqrtf(v);")]),
    "onesum": ("each component accumulated as e += s*d + c2*mu, one "
               "statement, in place of two +=",
               [("eind_panel.cuh", f"      {a}[r] += sj * d{d}[r];\n"
                 f"      {a}[r] += c2[r] * cj.m{d};\n",
                 f"      {a}[r] += sj * d{d}[r] + c2[r] * cj.m{d};\n")
                for a, d in (("ex", "x"), ("ey", "y"), ("ez", "z"))]
               + [("eind_panel.cuh", f"      c{d} += si * d{d}[r];\n"
                   f"      c{d} += c2[r] * m{d}i[r];\n",
                   f"      c{d} += si * d{d}[r] + c2[r] * m{d}i[r];\n")
                  for d in "xyz"]),
    "ctas4": ("__launch_bounds__(128, 4): 4 CTAs per SM, at most 128 "
              "registers",
              [("eind_panel.cuh", "__launch_bounds__(32 * WT)\n"
                "eind_whole_kernel", "__launch_bounds__(32 * WT, 4)\n"
                "eind_whole_kernel")]),
}


def _sass_mix(lib, prefix):
    """Instruction count of the kernel whose mangled name the regular
    expression `prefix` matches at its start in lib's SASS (cuobjdump
    -sass): total and by opcode."""
    import re

    from lidp_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    body = re.split(r"\n\s*Function : ", sass)
    fn = [b for b in body if re.match(prefix, b)]
    ops = {}
    for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9]*)", fn[0] if fn else ""):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return sum(ops.values()), ops


def _build_variants(table, stem, kernel, argtypes, sources=None,
                    inst="Li1E"):
    """Compile csrc/<stem>.cu and <stem>_df.cu (or the two `sources`, the
    float32 one first) of every variant in `table`, all nvcc processes at
    once; returns {variant: {dtype: its C entry of the whole panel
    (argtypes(scalar ctype)), registers, spill bytes and SASS mix of
    `kernel`'s instantiation whose mangled template arguments after the
    dtype are `inst` (Li1E: the damped one), and the whole panel's tile
    where the launcher exports it}}."""
    import ctypes
    import re
    import shutil

    import torch

    from lidp_tpu_torch.kernels import build

    procs = {}
    for name, (_, patches) in table.items():
        out = build.BUILD / "variants" / stem / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out / "csrc")
        for fname, old, new in patches:
            f = out / "csrc" / fname
            text = f.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {fname} does not hold "
                                   f"the text it patches once")
            f.write_text(text.replace(old, new))
        for src in sources or (stem, stem + "_df"):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
                   str(out / f"lib{src}.so"), str(out / "csrc" / f"{src}.cu")]
            procs[name, src] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {src}.cu\n"
                               f"{log}")
        # the damped whole kernel's registers and spill stores
        m = re.search(kernel + r"I[fd]" + inst
                      + r".*?\n(.*?)Used (\d+) registers", log, re.S)
        spill = re.findall(r"(\d+) bytes spill stores", m.group(1)) if m \
            else []
        out = build.BUILD / "variants" / stem / name
        dll = ctypes.CDLL(str(out / f"lib{src}.so"))
        fn = getattr(dll, f"lidp_{src}_whole")
        # the whole panel's tile, where the launcher exports it
        tile = getattr(dll, f"lidp_{src}_whole_tile", None)
        f64 = src.endswith("_df")
        fn.argtypes = argtypes(ctypes.c_double if f64 else ctypes.c_float)
        fn.restype = ctypes.c_int
        total, ops = _sass_mix(out / f"lib{src}.so",
                               f"_ZN4lidp{len(kernel)}{kernel}"
                               f"I{'d' if f64 else 'f'}{inst}")
        libs.setdefault(name, {})[torch.float64 if f64 else torch.float32] = \
            dict(fn=fn, registers=int(m.group(2)) if m else None,
                 spill_bytes=int(spill[-1]) if spill else None,
                 sass_total=total, sass_ops=ops,
                 tile=tile() if tile is not None else None)
    return libs


def _eind_argtypes(real):
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return [p, p, p, i, p, real, i, real, i, p, p, p, p]


def eind_variants(rounds):
    """--path eind; returns the JSON-able results."""
    import torch

    import chip_smoke
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    t0 = time.perf_counter()
    libs = _build_variants(VARIANTS, "eind_panel", "eind_whole_kernel",
                           _eind_argtypes)
    print(f"built {len(VARIANTS)} variants x 2 in "
          f"{time.perf_counter() - t0:.1f} s")
    ff = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(),
                                          torch.float32, "cuda")
    pd = ff.polar.polar_damp
    c32 = chip_smoke.make_case(10_125, 12_288, 60.0, seed=1)
    cases = {torch.float32: c32, torch.float64: chip_smoke.to_f64(c32)}
    calls, res = {}, {}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn, c, dtype, part, out):
        """One launch of a variant's whole kernel and sum on case c."""
        args = (c["x"].data_ptr(), c["alpha"].data_ptr(), c["mu"].data_ptr(),
                c["x"].shape[0], c["L"].data_ptr(), pd, panel.DAMP_EXP,
                panel.EIND_SKIP_U[dtype], part.shape[0], part.data_ptr(),
                out.data_ptr())

        def call(stats=None):
            err = fn(*args, stats, stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        return call

    for dtype, c in cases.items():
        n = c["x"].shape[0]
        nT = -(-n // panel.EIND_TILE)
        part = torch.empty((nT, nT + 1, 3, panel.EIND_TILE), dtype=dtype,
                           device="cuda")
        ref = panel.eind_panel_plain(c["x"], c["alpha"], c["mu"], c["L"], pd)
        dt = str(dtype)[6:]
        for name in VARIANTS:
            lib = libs[name][dtype]
            out = torch.empty((n, 3), dtype=dtype, device="cuda")
            stats = torch.zeros(2, dtype=torch.int64, device="cuda")
            call = launcher(lib["fn"], c, dtype, part, out)
            call(stats.data_ptr())
            torch.cuda.synchronize()
            label = f"{name}[{dt}]"
            err, _ = chip_smoke.compare(label, out, ref,
                                        dtype == torch.float64)
            votes, skipped = stats.tolist()
            res[label] = dict(
                registers=lib["registers"], spill_bytes=lib["spill_bytes"],
                sass_total=lib["sass_total"], sass_ops=lib["sass_ops"],
                max_abs_err=err, skip_share=skipped / votes, ms=[],
                same_bits_as_kept=bool(torch.equal(
                    out, res[f"kept[{dt}]"]["out"]))
                if name != "kept" else True, out=out.clone())
            calls[label] = call
        # the committed kernel through its wrapper, as chip_smoke.py times
        # it (the wrapper's checks and allocations included)
        wrapper = panel.eind_panel_df if dtype == torch.float64 \
            else panel.eind_panel
        label = f"wrapper[{dt}]"
        calls[label] = lambda w=wrapper, c=c: w(c["x"], c["alpha"], c["mu"],
                                                c["L"], pd)
        res[label] = dict(ms=[])
    for r in res.values():
        r.pop("out", None)
    labels = list(calls)
    for _ in range(2000):            # the card at its working clocks
        calls[labels[0]]()
    torch.cuda.synchronize()
    clocks = "--query-gpu=clocks.sm,clocks.max.sm,power.draw"
    for rd in range(rounds):
        k = rd % len(labels)
        for label in labels[k:] + labels[:k]:
            res[label]["ms"].append(chip_smoke.cuda_ms_queued(calls[label],
                                                              20))
        if rd in (0, rounds - 1):
            print(f"after round {rd}: sm clock, max, power: " + subprocess.run(
                ["nvidia-smi", clocks, "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
    for r in res.values():
        r["median_ms"] = statistics.median(r["ms"])
    for label, r in res.items():
        kept = res["kept" + label[label.index("["):]]["median_ms"]
        line = (f"{label:20s} {r['median_ms']:.4f} ms (min {min(r['ms']):.4f}"
                f", max {max(r['ms']):.4f}; {r['median_ms'] / kept:.3f} x "
                f"kept)")
        if "registers" in r:
            mix = " ".join(f"{k}={r['sass_ops'].get(k, 0)}" for k in
                           ("FRND", "MUFU", "SHFL", "LDS", "FFMA", "FADD",
                            "FMUL", "DFMA", "DADD", "DMUL", "BRA"))
            line += (f", SASS {r['sass_total']} ({mix})")
            line += (f", registers {r['registers']}, spill "
                     f"{r['spill_bytes']} B, skip share "
                     f"{r['skip_share']:.4f}, same bits as kept "
                     f"{r['same_bits_as_kept']}, max abs err "
                     f"{r['max_abs_err']:.3e}")
        print(line)
    return {"variants": {k: v[0] for k, v in VARIANTS.items()},
            "results": res}


# --path dipole: (what changes, [(file in csrc/, text, replacement)])
DIPOLE_VARIANTS = {
    "kept": ("the committed source", []),
    "f32tile64": ("float32 tiles of 64 atoms (2 warps, 2 rows per lane)",
                  [("dipole_panel.cuh", "static constexpr int BT = 128, ",
                    "static constexpr int BT = 64, ")]),
    "f64tile128": ("float64 tiles of 128 atoms (4 warps, 4 rows per lane), "
                   "4 CTAs per SM (at most 128 registers, as the kept 8 of "
                   "64)",
                   [("dipole_panel.cuh", "static constexpr int BT = 64, "
                     "MIN_CTAS = 8;", "static constexpr int BT = 128, "
                     "MIN_CTAS = 4;")]),
    "vote1": ("the warp votes over 1 row x 32 columns (DG = 1)",
              [("dipole_panel.cuh", "constexpr int DG = 2;",
                "constexpr int DG = 1;")]),
    "occupancy": ("float32 bounded to 4 CTAs per SM (at most 128 "
                  "registers) where the kept source bounds it to 5 (102); "
                  "float64 unbounded, where the kept source bounds it to "
                  "8 (128)",
                  [("dipole_panel.cuh", "static constexpr int BT = 128, "
                    "MIN_CTAS = 5;", "static constexpr int BT = 128, "
                    "MIN_CTAS = 4;"),
                   ("dipole_panel.cuh", "static constexpr int BT = 64, "
                    "MIN_CTAS = 8;", "static constexpr int BT = 64, "
                    "MIN_CTAS = 1;")]),
    "noskip": ("the warp skips compiled out (skip = 0 in the launcher)",
               [("dipole_panel.cuh", "        x, q, mol, a, mu, m, n, L, pd, "
                 "cut_coulsq, sqrt_q, skip, nT, part,\n        partials, "
                 "stats);\n  else", "        x, q, mol, a, mu, m, n, L, pd, "
                 "cut_coulsq, sqrt_q, 0, nT, part,\n        partials, "
                 "stats);\n  else")]),
}


def _dipole_argtypes(real):
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 6 + [i, p, real, real, real, i, i, i] + [p] * 6


def dipole_variants(rounds):
    """--path dipole; returns the JSON-able results."""
    import math

    import torch

    import chip_smoke
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    t0 = time.perf_counter()
    libs = _build_variants(DIPOLE_VARIANTS, "dipole_panel",
                           "dipole_whole_kernel", _dipole_argtypes)
    print(f"built {len(DIPOLE_VARIANTS)} variants x 2 in "
          f"{time.perf_counter() - t0:.1f} s")
    ff = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(),
                                          torch.float32, "cuda")
    pd, pair = ff.polar.polar_damp, ff.pair
    c32 = chip_smoke.make_case(10_125, 12_288, 60.0, seed=1)
    cases = {torch.float32: c32, torch.float64: chip_smoke.to_f64(c32)}
    calls, res = {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, c in cases.items():
        n = c["x"].shape[0]
        args = (c["x"], c["q"], c["mol"], c["alpha"], c["mu"], c["mask"],
                c["L"], pd, pair.cut_coulsq, pair.qqrd2e)
        ref = panel.dipole_panel_plain(*args)
        dt = str(dtype)[6:]
        for name in DIPOLE_VARIANTS:
            lib = libs[name][dtype]
            bt = lib["tile"]
            nT = -(-n // bt)
            part = torch.empty((nT, nT + 1, 3, bt), dtype=dtype,
                               device="cuda")
            partials = torch.empty((nT * (nT + 1) // 2, 8), dtype=dtype,
                                   device="cuda")
            f = torch.empty((n, 3), dtype=dtype, device="cuda")
            acc = torch.empty(8, dtype=dtype, device="cuda")
            stats = torch.zeros(3, dtype=torch.int64, device="cuda")

            def call(st=None, fn=lib["fn"], c=c, nT=nT, part=part,
                     partials=partials, f=f, acc=acc):
                err = fn(c["x"].data_ptr(), c["q"].data_ptr(),
                         c["mol"].data_ptr(), c["alpha"].data_ptr(),
                         c["mu"].data_ptr(), c["mask"].data_ptr(), n,
                         c["L"].data_ptr(), pd, pair.cut_coulsq,
                         math.sqrt(pair.qqrd2e), panel.DAMP_EXP, 1, nT,
                         part.data_ptr(), partials.data_ptr(),
                         f.data_ptr(), acc.data_ptr(), st, stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            call(stats.data_ptr())
            torch.cuda.synchronize()
            label = f"{name}[{dt}]"
            got = (f.clone(), acc[0].clone(), acc[1].clone(),
                   acc[2:8].clone())
            err, _ = chip_smoke.compare(label, got, ref,
                                        dtype == torch.float64)
            votes, cd, dd = stats.tolist()
            res[label] = dict(
                tile=bt, registers=lib["registers"],
                spill_bytes=lib["spill_bytes"], sass_total=lib["sass_total"],
                sass_ops=lib["sass_ops"], max_abs_err=err,
                scalar_margin=chip_smoke.scalar_margin(
                    got, ref, dtype == torch.float64),
                cd_skip_share=cd / votes if votes else None,
                dd_skip_share=dd / votes if votes else None, ms=[],
                same_bits_as_kept=chip_smoke.same_bits(
                    got, res[f"kept[{dt}]"]["out"])
                if name != "kept" else True, out=got)
            calls[label] = call
        # the committed kernel through its wrapper, as chip_smoke.py times
        # it, and the strip kernel (the row form) at the same shape
        wrapper = panel.dipole_panel_df if dtype == torch.float64 \
            else panel.dipole_panel
        calls[f"wrapper[{dt}]"] = lambda w=wrapper, a=args: w(*a)
        calls[f"strip form[{dt}]"] = lambda w=wrapper, a=args: w(
            *a, cols=a[:6], row0=0)
        res[f"wrapper[{dt}]"] = dict(ms=[])
        res[f"strip form[{dt}]"] = dict(ms=[])
    for r in res.values():
        r.pop("out", None)
    labels = list(calls)
    for _ in range(500):             # the card at its working clocks
        calls[labels[0]]()
    torch.cuda.synchronize()
    clocks = "--query-gpu=clocks.sm,clocks.max.sm,power.draw"
    for rd in range(rounds):
        k = rd % len(labels)
        for label in labels[k:] + labels[:k]:
            res[label]["ms"].append(chip_smoke.cuda_ms_queued(calls[label],
                                                              20))
        if rd in (0, rounds - 1):
            print(f"after round {rd}: sm clock, max, power: " + subprocess.run(
                ["nvidia-smi", clocks, "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
    for r in res.values():
        r["median_ms"] = statistics.median(r["ms"])
    for label, r in res.items():
        kept = res["kept" + label[label.index("["):]]["median_ms"]
        line = (f"{label:22s} {r['median_ms']:.4f} ms (min {min(r['ms']):.4f}"
                f", max {max(r['ms']):.4f}; {r['median_ms'] / kept:.3f} x "
                f"kept)")
        if "registers" in r:
            mix = " ".join(f"{k}={r['sass_ops'].get(k, 0)}" for k in
                           ("MUFU", "SHFL", "LDS", "VOTE", "FFMA", "FMUL",
                            "DFMA", "DMUL", "DADD", "BRA"))
            shares = ("none counted" if r["cd_skip_share"] is None else
                      f"cd {r['cd_skip_share']:.4f} dd "
                      f"{r['dd_skip_share']:.4f}")
            line += (f", tile {r['tile']}, SASS {r['sass_total']} ({mix}), "
                     f"registers {r['registers']}, spill {r['spill_bytes']} "
                     f"B, skip shares {shares}, same bits as kept "
                     f"{r['same_bits_as_kept']}, max abs err "
                     f"{r['max_abs_err']:.3e}, scalars at "
                     f"{r['scalar_margin']:.3g} of the bar")
        print(line)
    return {"variants": {k: v[0] for k, v in DIPOLE_VARIANTS.items()},
            "results": res}


# --path pair: (what changes, [(file in csrc/, text, replacement)])
_PAIR_CULL = "      cull ? boxes : nullptr, tabs, t1, L, WOLF ? cut_coulsq"
_PAIR_SKIP = "g_ewald, skip, list, nT, part, partials, stats);"
_PAIR_BOXES = "  if (cull) {\n    tile_box_kernel"
_F32_TILE = "static constexpr int BT = 128, MIN_CTAS = 4, PG = 2;"
_RSQRT_DOUBLE = ("__device__ __forceinline__ double rsqrt_(double v) { "
                 "return rsqrt(v); }\n")
_RCP_RN = ("__device__ __forceinline__ float rcp_rn(float v) { "
           "return __frcp_rn(v); }\n"
           "__device__ __forceinline__ double rcp_rn(double v) { "
           "return __drcp_rn(v); }\n")
_F64_TILE = "static constexpr int BT = 64, MIN_CTAS = 8, PG = 1;"
PAIR_VARIANTS = {
    "kept": ("the committed source", []),
    "votes": ("the warp votes over 1 row x 32 columns in float32 (PG = 1) "
              "and over 2 rows in float64 (PG = 2), the other way round",
              [("pair_panel.cuh", _F32_TILE, _F32_TILE.replace("PG = 2",
                                                               "PG = 1")),
               ("pair_panel.cuh", _F64_TILE, _F64_TILE.replace("PG = 1",
                                                               "PG = 2"))]),
    "vote4": ("the warp votes over 4 rows x 32 columns in float32 (PG = "
              "4, all the rows of a lane)",
              [("pair_panel.cuh", _F32_TILE, _F32_TILE.replace("PG = 2",
                                                               "PG = 4"))]),
    "f32tile64": ("float32 tiles of 64 atoms (2 warps, 2 rows per lane), 8 "
                  "CTAs per SM",
                  [("pair_panel.cuh", _F32_TILE, _F32_TILE.replace(
                      "BT = 128, MIN_CTAS = 4", "BT = 64, MIN_CTAS = 8"))]),
    "f64tile128": ("float64 tiles of 128 atoms (4 warps, 4 rows per lane), "
                   "4 CTAs per SM",
                   [("pair_panel.cuh", _F64_TILE, _F64_TILE.replace(
                       "BT = 64, MIN_CTAS = 8", "BT = 128, MIN_CTAS = 4"))]),
    "f64tile128x2": ("float64 tiles of 128 atoms, 2 CTAs per SM (no "
                     "spill)",
                     [("pair_panel.cuh", _F64_TILE, _F64_TILE.replace(
                         "BT = 64, MIN_CTAS = 8", "BT = 128, MIN_CTAS = 2"))]),
    "rcp": ("the two reciprocals by __frcp_rn / __drcp_rn (correctly "
            "rounded: the same bits as the division) in place of T(1) / v",
            [("panel_common.cuh", _RSQRT_DOUBLE, _RSQRT_DOUBLE + _RCP_RN),
             ("pair_panel.cuh", "const T r2inv = FORCE ? T(1) / rsq[h]",
              "const T r2inv = FORCE ? rcp_rn(rsq[h])"),
             ("pair_panel.cuh", "                const T tt = T(1) / (T(1) "
              "+ EWALD_P * grij);", "                const T tt = rcp_rn(T(1) "
              "+ EWALD_P * grij);")]),
    "ctas5": ("float32 bounded to 5 CTAs per SM (at most 102 registers)",
              [("pair_panel.cuh", _F32_TILE, _F32_TILE.replace(
                  "MIN_CTAS = 4", "MIN_CTAS = 5"))]),
    "ctas6": ("float32 bounded to 6 CTAs per SM (at most 85 registers)",
              [("pair_panel.cuh", _F32_TILE, _F32_TILE.replace(
                  "MIN_CTAS = 4", "MIN_CTAS = 6"))]),
    "occupancy": ("float32 bounded to 2 CTAs per SM, float64 to 4 (more "
                  "registers, fewer warps)",
                  [("pair_panel.cuh", _F32_TILE, _F32_TILE.replace(
                      "MIN_CTAS = 4", "MIN_CTAS = 2")),
                   ("pair_panel.cuh", _F64_TILE, _F64_TILE.replace(
                       "MIN_CTAS = 8", "MIN_CTAS = 4"))]),
    "noskip": ("the warp skip compiled out (skip = 0 in the launcher)",
               [("pair_panel.cuh", _PAIR_SKIP,
                 _PAIR_SKIP.replace("skip, list", "0, list"))]),
    "nocull": ("the tile-pair test compiled out (no box pass, every tile "
               "pair kept)",
               [("pair_panel.cuh", _PAIR_CULL,
                 _PAIR_CULL.replace("cull ? boxes : nullptr", "nullptr")),
                ("pair_panel.cuh", _PAIR_BOXES,
                 _PAIR_BOXES.replace("(cull)", "(false)"))]),
    "neither": ("both skips compiled out",
                [("pair_panel.cuh", _PAIR_SKIP,
                  _PAIR_SKIP.replace("skip, list", "0, list")),
                 ("pair_panel.cuh", _PAIR_CULL,
                  _PAIR_CULL.replace("cull ? boxes : nullptr", "nullptr")),
                 ("pair_panel.cuh", _PAIR_BOXES,
                  _PAIR_BOXES.replace("(cull)", "(false)"))]),
}
# the whole wolf_panel kernel: the pair template with FORCE false, its tile
# (WholeTile<float, false>), rows per vote and CTAs per SM; the skips are
# the launcher's, which it shares with the pair kernels
_WOLF_TILE = ("struct WholeTile<float, false> {\n"
              "  static constexpr int BT = 128, MIN_CTAS = 6, PG = 2;")


def _wolf_tile(bt, ctas, pg):
    return [("pair_panel.cuh", _WOLF_TILE, _WOLF_TILE.replace(
        "BT = 128, MIN_CTAS = 6, PG = 2",
        f"BT = {bt}, MIN_CTAS = {ctas}, PG = {pg}"))]


WOLF_VARIANTS = {
    "kept": ("the committed source", []),
    "tile64": ("tiles of 64 atoms (2 warps, 2 rows per lane), 12 CTAs per "
               "SM (as many threads)", _wolf_tile(64, 12, 2)),
    "vote1": ("the warp votes over 1 row x 32 columns (PG = 1)",
              _wolf_tile(128, 6, 1)),
    "vote4": ("the warp votes over 4 rows x 32 columns (PG = 4, all the "
              "rows of a lane)", _wolf_tile(128, 6, 4)),
    "ctas4": ("bounded to 4 CTAs per SM (at most 128 registers)",
              _wolf_tile(128, 4, 2)),
    "ctas8": ("bounded to 8 CTAs per SM (at most 64 registers)",
              _wolf_tile(128, 8, 2)),
    "noskip": PAIR_VARIANTS["noskip"],
    "nocull": PAIR_VARIANTS["nocull"],
}


def _pair_argtypes(real):
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return ([p] * 6 + [i, i, p, i, p, real, real, real, i, i, i, i]
            + [p] * 10)


def _wolf_argtypes(real):
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return [p] * 4 + [i, p, real, i, i, i] + [p] * 7


def _wolf_variant_calls(libs, c, pair, calls, res, stream):
    """Each WOLF_VARIANTS kernel (and the committed wrapper and its strip
    form) on case c, held to wolf_panel_plain: calls[label] launches it,
    res[label] holds its checks.  Labels `<variant>[wolf]`."""
    import torch

    import chip_smoke
    from lidp_tpu_torch.ops import panel

    n = c["x"].shape[0]
    args = (c["x"], c["q"], c["mol"], c["mask"], c["L"], pair.cut_coulsq)
    ref = panel.wolf_panel_plain(*args)
    for name in WOLF_VARIANTS:
        lib = libs[name][torch.float32]
        bt = lib["tile"]
        nT = -(-n // bt)
        npairs = nT * (nT + 1) // 2
        boxes = torch.empty((nT, 8), device="cuda")
        part = torch.empty((nT, nT + 1, 3, bt), device="cuda")
        kept = torch.empty((npairs,), dtype=torch.uint8, device="cuda")
        tlist = torch.empty((npairs + 2,), dtype=torch.int32, device="cuda")
        e0 = torch.empty((n, 3), device="cuda")
        stats = torch.zeros(3, dtype=torch.int64, device="cuda")

        def call(st=None, fn=lib["fn"], nT=nT, boxes=boxes, part=part,
                 kept=kept, tlist=tlist, e0=e0):
            err = fn(c["x"].data_ptr(), c["q"].data_ptr(),
                     c["mol"].data_ptr(), c["mask"].data_ptr(), n,
                     c["L"].data_ptr(), pair.cut_coulsq, 1, 1, nT,
                     boxes.data_ptr(), part.data_ptr(), kept.data_ptr(),
                     tlist.data_ptr(), e0.data_ptr(), st, stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        call(stats.data_ptr())
        torch.cuda.synchronize()
        label = f"{name}[wolf]"
        got = e0.clone()
        err, _ = chip_smoke.compare(label, got, ref)
        votes, skipped, dropped = stats.tolist()
        res[label] = dict(
            tile=bt, registers=lib["registers"],
            spill_bytes=lib["spill_bytes"], sass_total=lib["sass_total"],
            sass_ops=lib["sass_ops"], max_abs_err=err, scalar_margin=0.0,
            skip_share=skipped / votes if votes else None,
            drop_share=dropped / npairs, ms=[],
            same_bits_as_kept=chip_smoke.same_bits(got, res["kept[wolf]"]
                                                   ["out"])
            if name != "kept" else True, out=got)
        calls[label] = call
    calls["wrapper[wolf]"] = lambda: panel.wolf_panel(*args)
    calls["strip form[wolf]"] = lambda: panel.wolf_panel(
        *args, cols=args[:4], row0=0)
    res["wrapper[wolf]"] = dict(ms=[])
    res["strip form[wolf]"] = dict(ms=[])
    chip_smoke.compare("strip form[wolf]", calls["strip form[wolf]"](), ref)


def pair_variants(rounds):
    """--path pair: the pair kernel's variants and wolf_panel's; returns
    the JSON-able results."""
    import torch

    import chip_smoke
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    t0 = time.perf_counter()
    libs = _build_variants(PAIR_VARIANTS, "pair_panel", "pair_whole_kernel",
                           _pair_argtypes,
                           sources=("pair_wolf_panel", "pair_panel_df"),
                           inst="Lb1ELb1ELb1EE")
    wlibs = _build_variants(WOLF_VARIANTS, "wolf_panel", "pair_whole_kernel",
                            _wolf_argtypes, sources=("wolf_panel",),
                            inst="Lb0ELb1ELb0EE")
    print(f"built {len(PAIR_VARIANTS)} pair variants x 2 and "
          f"{len(WOLF_VARIANTS)} wolf variants in "
          f"{time.perf_counter() - t0:.1f} s")
    ff = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(),
                                          torch.float32, "cuda")
    pair = ff.pair
    c32 = chip_smoke.make_case(10_125, 12_288, 60.0, seed=1)
    cases = {torch.float32: c32, torch.float64: chip_smoke.to_f64(c32)}
    calls, res = {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    _wolf_variant_calls(wlibs, c32, pair, calls, res, stream)
    for dtype, c in cases.items():
        n = c["x"].shape[0]
        tabs = chip_smoke.tabs_for(pair, dtype)
        sp = c["sp"]
        args = (c["x"], c["q"], c["type"], c["mol"], c["mask"], tabs,
                c["L"], pair.cut_coulsq, pair.qqrd2e, pair.g_ewald)
        ref = panel.pair_wolf_panel_plain(*args, sp=sp)
        dt = str(dtype)[6:]
        for name in PAIR_VARIANTS:
            lib = libs[name][dtype]
            bt = lib["tile"]
            nT = -(-n // bt)
            boxes = torch.empty((nT, 8), dtype=dtype, device="cuda")
            part = torch.empty((nT, nT + 1, 6, bt), dtype=dtype,
                               device="cuda")
            partials = torch.empty((nT * (nT + 1) // 2, 8), dtype=dtype,
                                   device="cuda")
            kept = torch.empty((nT * (nT + 1) // 2,), dtype=torch.uint8,
                               device="cuda")
            tlist = torch.empty((nT * (nT + 1) // 2 + 2,),
                                dtype=torch.int32, device="cuda")
            f = torch.empty((n, 3), dtype=dtype, device="cuda")
            e0 = torch.empty((n, 3), dtype=dtype, device="cuda")
            acc = torch.empty(8, dtype=dtype, device="cuda")
            stats = torch.zeros(3, dtype=torch.int64, device="cuda")

            def call(st=None, fn=lib["fn"], c=c, tabs=tabs, nT=nT,
                     boxes=boxes, part=part, partials=partials, kept=kept,
                     tlist=tlist, f=f, e0=e0, acc=acc):
                err = fn(c["x"].data_ptr(), c["q"].data_ptr(),
                         c["type"].data_ptr(), c["mol"].data_ptr(),
                         c["mask"].data_ptr(), c["sp"].data_ptr(),
                         c["sp"].shape[1], n, tabs.data_ptr(),
                         tabs.shape[1], c["L"].data_ptr(), pair.cut_coulsq,
                         pair.qqrd2e, pair.g_ewald, 1, 1, 1, nT,
                         boxes.data_ptr(), part.data_ptr(),
                         partials.data_ptr(), kept.data_ptr(),
                         tlist.data_ptr(), f.data_ptr(), e0.data_ptr(),
                         acc.data_ptr(), st, stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            call(stats.data_ptr())
            torch.cuda.synchronize()
            label = f"{name}[{dt}]"
            got = (f.clone(), acc[0].clone(), acc[1].clone(),
                   acc[2:8].clone(), e0.clone())
            err, _ = chip_smoke.compare(label, got, ref,
                                        dtype == torch.float64)
            votes, skipped, dropped = stats.tolist()
            res[label] = dict(
                tile=bt, registers=lib["registers"],
                spill_bytes=lib["spill_bytes"], sass_total=lib["sass_total"],
                sass_ops=lib["sass_ops"], max_abs_err=err,
                scalar_margin=chip_smoke.scalar_margin(
                    got, ref, dtype == torch.float64),
                skip_share=skipped / votes if votes else None,
                drop_share=dropped / (nT * (nT + 1) // 2), ms=[],
                same_bits_as_kept=chip_smoke.same_bits(
                    got, res[f"kept[{dt}]"]["out"])
                if name != "kept" else True, out=got)
            calls[label] = call
        # the committed kernel through its wrapper, as chip_smoke.py times
        # it, and the strip kernel (the parent's row kernel) at the same
        # shape
        if dtype == torch.float64:
            def wrapper(*a, **k):
                x, q, t, mol, m, *rest = a
                cols = k.pop("cols", None)
                return panel.pair_panel_df(
                    x, q, t, m, *rest, mol=mol, row0=k.pop("row0", 0),
                    cols=None if cols is None else (*cols[:3], cols[4],
                                                    cols[3]), **k)
        else:
            wrapper = panel.pair_wolf_panel
        calls[f"wrapper[{dt}]"] = lambda w=wrapper, a=args: w(*a, sp=sp)
        calls[f"strip form[{dt}]"] = lambda w=wrapper, a=args: w(
            *a, sp=sp, cols=a[:5], row0=0)
        res[f"wrapper[{dt}]"] = dict(ms=[])
        res[f"strip form[{dt}]"] = dict(ms=[])
        got = calls[f"strip form[{dt}]"]()
        chip_smoke.compare(f"strip form[{dt}]", got, ref,
                           dtype == torch.float64)
    for r in res.values():
        r.pop("out", None)
    labels = list(calls)
    for _ in range(500):             # the card at its working clocks
        calls[labels[0]]()
    torch.cuda.synchronize()
    clocks = "--query-gpu=clocks.sm,clocks.max.sm,power.draw"
    for rd in range(rounds):
        k = rd % len(labels)
        for label in labels[k:] + labels[:k]:
            res[label]["ms"].append(chip_smoke.cuda_ms_queued(calls[label],
                                                              20))
        if rd in (0, rounds - 1):
            print(f"after round {rd}: sm clock, max, power: " + subprocess.run(
                ["nvidia-smi", clocks, "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
    for r in res.values():
        r["median_ms"] = statistics.median(r["ms"])
    for label, r in res.items():
        kept = res["kept" + label[label.index("["):]]["median_ms"]
        line = (f"{label:22s} {r['median_ms']:.4f} ms (min {min(r['ms']):.4f}"
                f", max {max(r['ms']):.4f}; {r['median_ms'] / kept:.3f} x "
                f"kept)")
        if "registers" in r:
            mix = " ".join(f"{k}={r['sass_ops'].get(k, 0)}" for k in
                           ("MUFU", "SHFL", "LDS", "VOTE", "FFMA", "FMUL",
                            "FADD", "FRND", "DFMA", "DMUL", "DADD", "BRA"))
            shares = ("none counted" if r["skip_share"] is None else
                      f"{r['skip_share']:.4f}")
            line += (f", tile {r['tile']}, SASS {r['sass_total']} ({mix}), "
                     f"registers {r['registers']}, spill {r['spill_bytes']} "
                     f"B, votes skipped {shares}, tile pairs dropped "
                     f"{r['drop_share']:.4f}, same bits as kept "
                     f"{r['same_bits_as_kept']}, max abs err "
                     f"{r['max_abs_err']:.3e}, scalars at "
                     f"{r['scalar_margin']:.3g} of the bar")
        print(line)
    # where the committed wrappers' time goes: device time by kernel
    breakdown = {}
    for dt in ("float32", "float64", "wolf"):
        for form in ("wrapper", "strip form"):
            label = f"{form}[{dt}]"
            breakdown[label] = _device_times(calls[label], 20)
            print(f"{label}: device time per call by kernel: " + "; ".join(
                f"{key[:48]} {ms:.4f} ms x {cnt:g}"
                for ms, cnt, key in breakdown[label]))
    return {"variants": {k: v[0] for k, v in PAIR_VARIANTS.items()},
            "wolf_variants": {k: v[0] for k, v in WOLF_VARIANTS.items()},
            "results": res, "device_ms_by_kernel": breakdown}


def _device_times(fn, reps):
    """[(device ms per call, launches per call, kernel name)] of `reps`
    calls of fn under torch.profiler, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev / 1e3 / reps, ev.count / reps, ev.key))
    return sorted(rows, reverse=True)


# --path lj --variants: (what changes, [(file in csrc/, text, replacement)])
def _lj_const(name, old, new):
    return [("lj_cell.cuh", f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")]


_RCP = ('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));')
_T128 = (_lj_const("LJ_THREADS", 256, 128) + _lj_const("LJ_MINB", 3, 6))
_R2 = _lj_const("LJ_R", 4, 2)
_ZC2 = _lj_const("ZC", 4, 2)


def _tile(tx, ty):
    return [("lj_cell.cuh", "constexpr int LJ_TX = 2, LJ_TY = 2;",
             f"constexpr int LJ_TX = {tx}, LJ_TY = {ty};")]


LJ_VARIANTS = {
    "kept": ("the committed source", []),
    "div": ("the reciprocal as the IEEE division 1.f / rsq",
            [("lj_cell.cuh", _RCP, "y = 1.f / v;")]),
    "frcp_rn": ("the reciprocal as __frcp_rn (correctly rounded)",
                [("lj_cell.cuh", _RCP, "y = __frcp_rn(v);")]),
    "tile1x1": ("one column per CTA", _tile(1, 1)),
    "tile2x1": ("2 x 1 columns per CTA", _tile(2, 1)),
    "tile3x3_ZC2": ("3 x 3 columns per CTA, 2 own z-cells",
                    _tile(3, 3) + _ZC2),
    "tile3x3_ZC3": ("3 x 3 columns per CTA, 3 own z-cells",
                    _tile(3, 3) + _lj_const("ZC", 4, 3)),
    "tile4x4_ZC1": ("4 x 4 columns per CTA, 1 own z-cell",
                    _tile(4, 4) + _lj_const("ZC", 4, 1)),
    "tile3x2_ZC3": ("3 x 2 columns per CTA, 3 own z-cells",
                    _tile(3, 2) + _lj_const("ZC", 4, 3)),
    "R2": ("2 rows per thread", _R2),
    "minb2": ("2 CTAs per SM at least (registers not capped at 80)",
              _lj_const("LJ_MINB", 3, 2)),
    "minb4": ("4 CTAs per SM at least (64 registers)",
              _lj_const("LJ_MINB", 3, 4)),
    "ZC2": ("2 own z-cells per column", _ZC2),
    "ZC3": ("3 own z-cells per column", _lj_const("ZC", 4, 3)),
    "ZC1": ("1 own z-cell per column", _lj_const("ZC", 4, 1)),
    "T128_ZC2": ("128 threads per CTA, 2 own z-cells", _T128 + _ZC2),
    "T512": ("512 threads per CTA, 1 CTA per SM at least",
             _lj_const("LJ_THREADS", 256, 512)
             + _lj_const("LJ_MINB", 3, 1)),
    "lanes4": ("4 threads per row group", _lj_const("LJ_LANES", 8, 4)),
    "lanes16": ("16 threads per row group", _lj_const("LJ_LANES", 8, 16)),
    # timing probes, not candidates (their forces are wrong): the staging
    # alone, and the pair loop with the cutoff test but no force
    "probe_stage_only": ("no pair work: staging, the clears and the "
                         "launch",
                         [("lj_cell.cuh", "const int ngroups = "
                           "sgrp[NOWN];", "const int ngroups = 0;")]),
    "probe_test_only": ("the cutoff test without the force (fpair = 1 "
                        "where it passes)",
                        [("lj_cell.cuh", "const float fpair = ok ? r6inv * "
                          "(c.lj1 * r6inv - c.lj2) * r2inv : 0.f;",
                          "const float fpair = ok ? 1.f : 0.f;")]),
}


def _build_lj_variants(other):
    """Compile slot_lj_forces.cu of every LJ variant (and, with `other`,
    that checkout's own), all nvcc processes at once; returns {variant: its
    C entry, registers, spill bytes and the SASS mix of the kernel without
    energy and virial}."""
    import ctypes
    import re
    import shutil

    from lidp_tpu_torch.kernels import build

    srcs = {}
    for name, (_, patches) in LJ_VARIANTS.items():
        out = build.BUILD / "ljvariants" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out / "csrc")
        for fname, old, new in patches:
            f = out / "csrc" / fname
            text = f.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {fname} does not hold "
                                   f"the text it patches once")
            f.write_text(text.replace(old, new))
        srcs[name] = out
    if other:
        out = build.BUILD / "ljvariants" / "other"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(os.path.join(os.path.abspath(other),
                                     "lidp_tpu_torch", "csrc"), out / "csrc")
        srcs["other"] = out
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o",
         str(out / "libslot_lj_forces.so"),
         str(out / "csrc" / "slot_lj_forces.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, out in srcs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        # the kernel without energy and virial in slot order, of the wide
        # tile (the one the E and E4 grids take) where the source has tiles
        text = (srcs[name] / "csrc" / "lj_cell.cuh").read_text()
        prefix = "_ZN4lidp14lj_cell_kernelILb0ENS_9SlotOrderE"
        if "struct LJTile" in text:
            tx, ty = re.search(r"constexpr int LJ_TX = (\d+), LJ_TY = "
                               r"(\d+);", text).groups()
            zc = re.search(r"constexpr int ZC = (\d+);", text).group(1)
            prefix += rf"\w*?LJTileILi{tx}ELi{ty}ELi{zc}E"
        m = re.search(prefix[3:] + r"\w*.*?\n(.*?)Used (\d+) registers", log,
                      re.S)
        spill = re.findall(r"(\d+) bytes spill stores", m.group(1)) if m \
            else []
        lib = srcs[name] / "libslot_lj_forces.so"
        fn = ctypes.CDLL(str(lib)).lidp_slot_lj_forces
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        total, ops = _sass_mix(lib, prefix)
        libs[name] = dict(fn=fn, registers=int(m.group(2)) if m else None,
                          spill_bytes=int(spill[-1]) if spill else None,
                          sass_total=total, sass_ops=ops)
    return libs


def _melt_slots(scale):
    """SlotRunner's state of the melt at `scale` after setup and 100 steps,
    as chip_smoke.py holds it: (grids, box, pair, par)."""
    import torch

    from lidp_tpu_torch.models import lj_melt
    from lidp_tpu_torch.ops import cell_kernels as ck

    melt = lj_melt.build(scale=scale, dtype=torch.float32, neighbor="slots")
    runner = melt.runner
    state = runner.run(*runner.setup(melt.system), 100)
    carry, box, pair = state[3], melt.system.box, runner.ff.pair
    if bool(carry.overflow):
        raise AssertionError("a cell overflowed its capacity")
    grids = [carry.x[..., d] for d in range(3)]
    print(f"scale {scale}: {melt.natoms} atoms, grid "
          f"{tuple(grids[0].shape)}, {int((carry.aid < melt.natoms).sum())}"
          f" live slots")
    return grids, box, pair, ck.lj_par(box, pair,
                                       ck.sentinel_scalars(box, pair)[0])


def lj_variants(rounds, scale, other):
    """--path lj --variants; returns the JSON-able results."""
    import torch

    import chip_smoke
    from lidp_tpu_torch.ops import cell_kernels as ck

    t0 = time.perf_counter()
    libs = _build_lj_variants(other)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    stream = torch.cuda.current_stream().cuda_stream
    # the grid of --scale, and that of path E (scale 1) beside it
    scales = [scale] + ([1] if scale != 1 else [])
    calls, res, kept = {}, {}, {}
    for sc in scales:
        grids, box, pair, par = _melt_slots(sc)
        nbx, nby, nbz, cap = grids[0].shape
        fout = torch.empty((nbx, nby, nbz, cap, 3), dtype=torch.float32,
                           device="cuda")
        acc = torch.zeros(8, dtype=torch.float32, device="cuda")
        partials = torch.empty((nbx * nby * nbz, 8), dtype=torch.float32,
                               device="cuda")

        def launcher(fn, need_ev, grids=grids, par=par, fout=fout, acc=acc,
                     partials=partials, shape=(nbx, nby, nbz, cap)):
            args = (grids[0].data_ptr(), grids[1].data_ptr(),
                    grids[2].data_ptr(), grids[0].stride(-1), *shape,
                    par.data_ptr(), int(need_ev), fout.data_ptr(),
                    partials.data_ptr(), acc.data_ptr(), stream)

            def call():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            return call

        tag = "" if sc == scale else f"@scale{sc:g}"
        for ev in (False, True):
            ref = ck.slot_lj_forces_plain(grids, box, pair, need_ev=ev)
            ref = (torch.stack(ref[0], -1), ref[1], ref[2])
            for name, lib in libs.items():
                label = f"{name}{tag}" + ("[need_ev]" if ev else "")
                call = launcher(lib["fn"], ev)
                call()
                torch.cuda.synchronize()
                got = (fout.clone(), acc[0].clone(), acc[1:7].clone()) if ev \
                    else (fout.clone(), torch.zeros_like(acc[0]),
                          torch.zeros_like(acc[1:7]))
                err = float("nan")
                if not name.startswith("probe_"):
                    err, _ = chip_smoke.lj_compare(label, got, ref, ev)
                if name == "kept":
                    kept[ev, sc] = got
                res[label] = dict(
                    registers=lib["registers"],
                    spill_bytes=lib["spill_bytes"],
                    sass_total=lib["sass_total"], sass_ops=lib["sass_ops"],
                    max_abs_err=err, ms=[], same_bits_as_kept=all(
                        torch.equal(a, b)
                        for a, b in zip(got, kept[ev, sc])))
                calls[label] = call
            label = f"wrapper{tag}" + ("[need_ev]" if ev else "")
            calls[label] = lambda ev=ev, g=grids, b=box, p=pair, q=par: \
                ck.slot_lj_forces(g, b, p, need_ev=ev, par=q)
            res[label] = dict(ms=[])
            del ref
    labels = list(calls)
    for _ in range(200):             # the card at its working clocks
        calls["kept"]()
    torch.cuda.synchronize()
    clocks = "--query-gpu=clocks.sm,clocks.max.sm,power.draw"
    for rd in range(rounds):
        k = rd % len(labels)
        for label in labels[k:] + labels[:k]:
            res[label]["ms"].append(chip_smoke.cuda_ms_queued(calls[label],
                                                              20))
        if rd in (0, rounds - 1):
            print(f"after round {rd}: sm clock, max, power: " + subprocess.run(
                ["nvidia-smi", clocks, "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
    for r in res.values():
        r["median_ms"] = statistics.median(r["ms"])
    for label, r in res.items():
        name = label.split("[")[0].split("@")[0]
        base = res["kept" + label[len(name):]]["median_ms"]
        line = (f"{label:24s} {r['median_ms']:.4f} ms (min "
                f"{min(r['ms']):.4f}, max {max(r['ms']):.4f}; "
                f"{r['median_ms'] / base:.3f} x kept)")
        if "registers" in r:
            mix = " ".join(f"{k}={r['sass_ops'].get(k, 0)}" for k in
                           ("MUFU", "LDS", "SHFL", "FFMA", "FADD", "FMUL",
                            "FSETP", "FSEL", "ISETP", "BRA"))
            line += (f", registers {r['registers']}, spill "
                     f"{r['spill_bytes']} B, same bits as kept "
                     f"{r['same_bits_as_kept']}, max abs err "
                     f"{r['max_abs_err']:.3e}, SASS {r['sass_total']} "
                     f"({mix})")
        print(line)
    desc = {k: v[0] for k, v in LJ_VARIANTS.items()}
    if other:
        desc["other"] = f"slot_lj_forces.cu of {os.path.abspath(other)}"
    return {"variants": desc, "results": res}


def drive_paths(seq):
    """--path seq: each path of `seq` in order as chip_smoke.py times it;
    returns ([steps/s], [B's median wolf tick in ms, None for the other
    paths])."""
    import torch

    from lidp_tpu_torch.kernels import build
    from lidp_tpu_torch.models import lj_melt, polar_bench

    build.library("eind_panel")      # build and load every kernel first
    rates, ticks = [], []
    for path in seq:
        sync = torch.cuda.synchronize
        if path == "A":
            bench = polar_bench.build_synthetic()
            polar_bench.setup_forces(bench)
            sync()
            t0 = time.perf_counter()
            polar_bench.run(bench, 20)
            steps = 20
        elif path == "B":
            bench = polar_bench.build_synthetic()
            polar_bench.host_setup_forces(bench)
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                polar_bench.host_cg_step(bench)
            steps = 5
        elif path == "C":
            bench = polar_bench.build_synthetic(dtype=torch.float64,
                                                precision=1e-11)
            polar_bench.host_setup_forces(bench, mixed=True)
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                polar_bench.host_cg_step(bench, mixed=True)
            steps = 5
        elif path in ("SW", "SP", "SD", "WW", "WP", "WD"):
            rates.append(1e3 / pair_form_ms(path))
            ticks.append(None)
            continue
        elif path in ("SM", "SN", "WM", "WN"):
            rates.append(1e3 / dipole_form_ms(path))
            ticks.append(None)
            continue
        elif path in ("E", "F", "E4"):
            bench = lj_melt.build(scale=4 if path == "E4" else 1,
                                  dtype=torch.float32,
                                  neighbor="cells" if path == "F"
                                  else "slots")
            state = bench.runner.setup(bench.system)
            if path == "E":
                state = bench.runner.run(*state, 100)
            sync()
            t0 = time.perf_counter()
            steps = 400 if path == "E" else 100
            state = bench.runner.run(*state, steps)
            del state
        else:
            raise ValueError(f"unknown path {path!r}")
        sync()
        rates.append(steps / (time.perf_counter() - t0))
        tick = None
        if path == "B":
            bench.hpf.timing = True
            per = []
            for _ in range(5):
                polar_bench.host_cg_step(bench)
                per.append(bench.hpf.last_timing["wolf"])
            tick = statistics.median(per)
        ticks.append(tick)
        del bench
        torch.cuda.empty_cache()
    return rates, ticks


def pair_form_ms(path):
    """--path seq SW, SP, SD (WW, WP, WD): the median of 5 queued timings
    (20 calls each) of a pair kernel's strip form (whole form) on
    chip_smoke.py's main case."""
    import torch

    import chip_smoke
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    c = chip_smoke.make_case(10_125, 12_288, 60.0, seed=1)
    dtype = torch.float64 if path[1] == "D" else torch.float32
    strip = path[0] == "S"
    if dtype == torch.float64:
        c = chip_smoke.to_f64(c)
    ff = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(2),
                                          torch.float32, "cuda")
    p = ff.pair
    tabs = chip_smoke.tabs_for(p, dtype)
    scal = (p.cut_coulsq, p.qqrd2e, p.g_ewald)
    head = (c["x"], c["q"], c["type"])
    if path[1] == "W":
        args = (*head, c["mol"], c["mask"], tabs, c["L"], *scal)
        kw = dict(cols=args[:5], row0=0) if strip else {}
        fn = lambda: panel.pair_wolf_panel(*args, sp=c["sp"], **kw)  # noqa
    elif path[1] == "P":
        args = (*head, c["mask"], tabs, c["L"], *scal)
        kw = dict(cols=args[:4], row0=0) if strip else {}
        fn = lambda: panel.pair_panel(*args, sp=c["sp"], **kw)  # noqa
    else:
        args = (*head, c["mask"], tabs, c["L"], *scal)
        kw = dict(cols=(*args[:4], c["mol"]), row0=0) if strip else {}
        fn = lambda: panel.pair_panel_df(  # noqa
            *args, sp=c["sp"], mol=c["mol"], **kw)
    for _ in range(50):
        fn()
    return statistics.median(chip_smoke.cuda_ms_queued(fn, 20)
                             for _ in range(5))


def dipole_form_ms(path):
    """--path seq SM, SN (WM, WN): the median of 5 queued timings (20 calls
    each) of dipole_panel (M, float32) or dipole_panel_df (N, float64) in
    the strip form (cols = all atoms, row0 = 0; the whole form) on
    chip_smoke.py's main case, the fluid's exponential damping."""
    import torch

    import chip_smoke
    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    c = chip_smoke.make_case(10_125, 12_288, 60.0, seed=1)
    if path[1] == "N":
        c = chip_smoke.to_f64(c)
    ff = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(2),
                                          torch.float32, "cuda")
    p, s = ff.pair, ff.polar
    args = (c["x"], c["q"], c["mol"], c["alpha"], c["mu"], c["mask"],
            c["L"], s.polar_damp, p.cut_coulsq, p.qqrd2e)
    kw = dict(damping_type=s.damping_type)
    if path[0] == "S":
        kw.update(cols=args[:6], row0=0)
    wrapper = panel.dipole_panel_df if path[1] == "N" else panel.dipole_panel
    fn = lambda: wrapper(*args, **kw)  # noqa
    for _ in range(50):
        fn()
    return statistics.median(chip_smoke.cuda_ms_queued(fn, 20)
                             for _ in range(5))


def cutoff_rows():
    """--path cutoff; returns {label: [rows with a force, max |f|]}."""
    import importlib.util

    import torch

    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.ops import panel

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    p = polar_bench.synthetic_forcefield(polar_bench.synthetic_system(2),
                                         torch.float32, "cuda").pair
    out = {}
    for dtype in (torch.float32, torch.float64):
        c = cs.cutoff_pairs_case(dtype)
        tabs = cs.tabs_for(p, dtype)
        args = (c["x"], c["q"], c["type"], c["mask"], tabs, c["L"],
                p.cut_coulsq, p.qqrd2e, p.g_ewald)
        if dtype == torch.float32:
            calls = {"pair_panel": (panel.pair_panel,
                                    panel.pair_panel_plain, {},
                                    args[:4])}
        else:
            calls = {"pair_panel_df": (panel.pair_panel_df,
                                       panel.pair_panel_df_plain,
                                       dict(mol=c["mol"]),
                                       (*args[:4], c["mol"]))}
        s = polar_bench.synthetic_forcefield(
            polar_bench.synthetic_system(2), torch.float32, "cuda").polar
        d = cs.dipole_cutoff_case(dtype, polar="one")
        dargs = (d["x"], d["q"], d["mol"], d["alpha"], d["mu"], d["mask"],
                 d["L"], s.polar_damp, p.cut_coulsq, p.qqrd2e)
        dkw = dict(damping_type=s.damping_type)
        name = "dipole_panel" if dtype == torch.float32 else \
            "dipole_panel_df"
        calls[name + "[one polar]"] = (
            panel.WRAPPERS[name], getattr(panel, name + "_plain"), dkw,
            dargs[:6], dargs)
        for name, call in calls.items():
            kern, plain, kw, cols = call[:4]
            a = call[4] if len(call) > 4 else args
            for form, f in (
                    ("strip form", kern(*a, cols=cols, row0=0, **kw)[0]),
                    ("whole", kern(*a, **kw)[0]),
                    ("plain", plain(*a, **kw)[0])):
                rows = torch.nonzero((f != 0).any(1)).flatten().tolist()
                out[f"{name}[{form}]"] = [rows, float(f.abs().max())]
                print(f"{name}[{form}]: rows with a force {rows}, max |f| "
                      f"{float(f.abs().max()):.6e}")
    return out


def ab_trees(other, pairs, seq):
    """--path ab; returns the JSON-able results."""
    trees = {"this": ROOT, "other": os.path.abspath(other)}

    def child(tree):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--path", "seq",
             "--seq", ",".join(seq), "--tree", tree], capture_output=True,
            text=True, check=True).stdout
        got = json.loads(out.strip().splitlines()[-1])
        return got["steps_per_s"], got["wolf_tick_ms"]

    for name, tree in trees.items():
        print(f"{name}: {tree} (warm-up: {child(tree)})")
    vals = {name: [[] for _ in seq] for name in trees}
    wolf = {name: [[] for _ in seq] for name in trees}
    for p in range(pairs):
        order = ["this", "other"] if p % 2 == 0 else ["other", "this"]
        for name in order:
            rates, ticks = child(trees[name])
            for i, (v, t) in enumerate(zip(rates, ticks)):
                vals[name][i].append(v)
                if t is not None:
                    wolf[name][i].append(t)
    res = {}
    for name in trees:
        for i, path in enumerate(seq):
            unit_ = "calls/s" if path[0] in "SW" else "steps/s"
            for key, v, unit, fmt in (
                    (f"{name} {path}@{i}", vals[name][i], unit_, ".1f"),
                    (f"{name} {path}@{i} wolf", wolf[name][i], "ms",
                     ".4f")):
                if not v:
                    continue
                q1, q2, q3 = statistics.quantiles(v, n=4)
                res[key] = dict(values=v, median=statistics.median(v),
                                q1=q1, q3=q3)
                print(f"{key:17s} median {statistics.median(v):9.4f}, "
                      f"quartiles {q1:9.4f} {q3:9.4f} {unit}; values "
                      + " ".join(f"{x:{fmt}}" for x in v))
    return {"seq": seq, "pairs": pairs, "trees": trees, "results": res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    ap.add_argument("--path", choices=["fused32", "rigid", "host64",
                                       "host32", "lj", "ljcells", "cutoff",
                                       "eind", "dipole", "pair", "seq",
                                       "ab"],
                    default="fused32")
    ap.add_argument("--scale", type=float, default=1,
                    help="lj paths: box edge in units of 20 fcc cells")
    ap.add_argument("--rounds", type=int, default=7,
                    help="eind, dipole, pair, lj --variants: rounds over "
                    "the variants")
    ap.add_argument("--seq", default="F",
                    help="seq, ab: paths in order, e.g. F or F,A,C,F")
    ap.add_argument("--tree", help="seq: the checkout to drive (default "
                    "this one); ab: the other checkout")
    ap.add_argument("--pairs", type=int, default=10,
                    help="ab: processes per checkout")
    ap.add_argument("--out", help="eind, dipole, pair, ab, lj --variants: "
                    "also write the JSON here")
    ap.add_argument("--variants", action="store_true",
                    help="lj: time the LJ cell kernel's design variants "
                    "(LJ_VARIANTS) at --scale (4: the E4 grid), and with "
                    "--tree that checkout's kernel beside them")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_polar: no CUDA device", file=sys.stderr)
        return 1
    seq = args.seq.split(",")
    if args.path == "seq":
        sys.path.insert(0, os.path.abspath(args.tree or ROOT))
        rates, ticks = drive_paths(seq)
        print(json.dumps({"steps_per_s": rates, "wolf_tick_ms": ticks}))
        return 0
    if args.path == "cutoff":
        sys.path.insert(0, os.path.abspath(args.tree or ROOT))
        print(json.dumps(cutoff_rows()))
        return 0
    sys.path.insert(0, ROOT)
    from lidp_tpu_torch.models import polar_bench

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    lj_var = args.path == "lj" and args.variants
    if args.path in ("eind", "dipole", "pair", "ab") or lj_var:
        if lj_var:
            out = lj_variants(args.rounds, args.scale, args.tree)
        elif args.path == "eind":
            out = eind_variants(args.rounds)
        elif args.path == "dipole":
            out = dipole_variants(args.rounds)
        elif args.path == "pair":
            out = pair_variants(args.rounds)
        else:
            out = ab_trees(args.tree, args.pairs, seq)
        print(json.dumps(out))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(out, f)
        return 0
    if args.path in ("lj", "ljcells"):
        run_steps = lj_events(args.path, args.scale, args.steps)
    elif args.path in ("host64", "host32"):
        mixed = args.path == "host64"
        bench = (polar_bench.build_synthetic(dtype=torch.float64,
                                             precision=1e-11) if mixed
                 else polar_bench.build_synthetic())
        polar_bench.host_setup_forces(bench, mixed=mixed)
        for _ in range(2):
            polar_bench.host_cg_step(bench, mixed=mixed)
        torch.cuda.synchronize()

        def run_steps(k):
            return [polar_bench.host_cg_step(bench, mixed=mixed)[1]
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
        print(f"events window ({args.path}, each step synchronised for its "
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
    elif args.path == "rigid":
        rigid = polar_bench.build_rigid()
        polar_bench.run_rigid(rigid, 3)
        torch.cuda.synchronize()

        def run_steps(k):
            return polar_bench.run_rigid(rigid, k)

        # fused32_events wraps the phases of the runner's PolarStep
        fused32_events(argparse.Namespace(step=rigid.runner.step),
                       run_steps, args.steps)
        # the special correction with the System's atom types (int32, as
        # make_system gives them) and as int64 (build_synthetic's), and
        # the rigid integrator's two halves, by CUDA events around a call
        import chip_smoke

        sys_, res_, st_ = rigid.state
        step_, integ = rigid.runner.step, rigid.runner.integ
        x_ = sys_.x - rigid.runner._lo
        for dt in (torch.int32, torch.int64):
            t_ = sys_.type.to(dt)
            ms = chip_smoke.cuda_ms(lambda: step_._special_correction(
                x_, sys_.q, t_), reps=20)
            print(f"special correction, types {dt}: {ms:.3f} ms a call")
        for name, fn in (
                ("initial", lambda: integ.initial(sys_, res_, integ.params,
                                                  st_)),
                ("final", lambda: integ.final(sys_, res_, integ.params,
                                              st_))):
            print(f"rigid integrator {name} half: "
                  f"{chip_smoke.cuda_ms(fn, reps=20):.3f} ms a call, "
                  f"{chip_smoke.cuda_ms_queued(fn, 20):.3f} queued")
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
