#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lidp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from lidp_tpu_torch/csrc (nvcc, in parallel);
  3. kernel parity: each of the eight panel kernels against its plain
     PyTorch version on the card, on a random case at the main paths' shape
     (12,288 x 12,288) and on a ragged one (1,000 rows with masked atoms,
     alpha=0 atoms and special lists); pair_panel with and without coulomb,
     pair_panel_df with and without the fused Wolf field.  float32 kernels:
     per-row rtol 1e-4, atol 1e-5*max|ref|, scalars rel 1e-4 (float32 sums
     over ~1e8 pairs in another order).  float64 (`*_df`) kernels: per-row
     rtol 1e-9, atol 1e-11*max|ref|, scalars rel 1e-10 (double sums in
     another order; a kernel at float32 grade anywhere misses this by four
     orders).  Median kernel and plain times (CUDA events) and the bound;
  4. the main paths on the 10,125-atom synthetic fluid, every launch
     counter set to 0 just before each and read just after:
     A. float32 fused step through the kernels: initial forces + 20 steps;
     B. float32 host phases (make_host_phases + HostPolarForces, pure CG):
        initial forces + 5 steps; step 0 against path A's step 0 (energies
        rel 1e-5, forces rtol 5e-4, atol 5e-5*max);
     C. float64 at polar_precision 1e-11, host phases with the
        mixed-precision solve: initial forces + 5 steps, converged at
        every step;
     D. float64 fused step, initial forces only: the pure float64 CG
        through eind_panel_df;
     then step 0 of each against the float64 plain path (panel="scan",
     pure CG at 1e-11) on the card: A energies rel 1e-4, epol abs 2e-2,
     forces rtol 5e-4, atol 5e-5*max; C and D evdwl/ecoul/elong rel 1e-10,
     epol rel 1e-8, forces and dipoles atol 1e-8*max; D's iteration count
     within 1 of the plain path's;
  5. the LJ melt of bench/in.lj on the cell engine (lj_melt.build), float32:
     kernel parity of slot_lj_forces and cell_pair_forces_lj against their
     plain versions at the melt's (11,11,11,40) grid (the melt after path
     E's 500 steps: on the lattice of step 0 the forces cancel to rounding)
     and on a ragged (3,4,5) grid with masked atoms, an empty cell and a
     full one, need_ev on and off: forces 5e-6 of max |f|, evdwl and virial
     rel 1e-5 (float32 sums in another order, and a pair across the periodic
     face sees x_j + L from one side and x_i - L from the other, each
     rounded at twice the box length; the bar of the JAX package's own
     slot-runner test); with
     E. 32,000 atoms through SlotRunner: setup, 100 steps, a timed window
        of 400 more; step 0 against the reference log's temp 1.44, pe
        -6.7733681, etotal -4.6134356, press -5.0197073 (rel 1e-6, 1e-5,
        1e-5, 1e-4), step 100 etotal against -4.6223613 (rel 2e-4: float32
        on stale cells);
     F. the same melt through the generic Runner on cells, setup + 100
        steps: step 0 equal to E's (energies rel 1e-5, forces 5e-6), step
        100 etotal rel 1e-4, temp and pe 2e-3 of E's;
     step 0 of E against the float64 plain route (ops/cells.cell_pair_forces
     on the card): forces 1e-5, evdwl rel 1e-6; and
     E4. SlotRunner at scale 4 (2,048,000 atoms, grid 47^3 x 40): setup +
        100 steps, no overflow, finite; step 0 pe against the log's (rel
        1e-5: the lattice energy per atom does not depend on the size);
        step 100 etotal within rel 1e-3 of the log's -4.6223613 and within
        3e-3 of step 0 (the log itself moves 1.9e-3 over these 100 steps:
        the lattice melts under an unshifted cutoff); then slot_lj_forces
        against its plain version at this grid on the run's last state,
        need_ev off and on, at the bars above, repeats bit-identical.
     On the fcc lattice of step 0 the forces cancel to rounding, so force
     bars there are taken of max(max |f|, 1), the nearest-neighbour pair
     force being 2;
  6. one JSON line {"kernels": [...]} with each of the ten kernels'
     launches (summed and by path), times and bound, then the nvidia-smi
     line, then the device line last.

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
NSTEPS = 20              # path A
HOST_STEPS = 5           # paths B and C
FP32_PEAK = 67e12        # H100 SXM FP32 CUDA-core FLOP/s (data sheet, 700 W)
FP64_PEAK = 34e12        # H100 SXM FP64 CUDA-core FLOP/s (data sheet)
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s
# wrapper -> (TPU kernel it replaces, flops per pair: the Pallas
# CostEstimate of the f32 kernel, and for a *_df kernel that of its f32
# twin, float64?, values per row, values per column, values out per row)
KERNELS = {
    "eind_panel": ("lidp_tpu/ops/pallas_panel.py:194", 45, False, 4, 7, 3),
    "pair_wolf_panel": ("lidp_tpu/ops/pallas_panel.py:1386", 100, False,
                        6, 7, 6),
    "dipole_panel": ("lidp_tpu/ops/pallas_panel.py:1140", 140, False,
                     9, 10, 3),
    "pair_panel": ("lidp_tpu/ops/pallas_panel.py:1458", 70, False, 5, 6, 3),
    "wolf_panel": ("lidp_tpu/ops/pallas_panel.py:993", 30, False, 4, 6, 3),
    "eind_panel_df": ("lidp_tpu/ops/pallas_panel.py:359", 45, True, 4, 7, 3),
    "pair_panel_df": ("lidp_tpu/ops/pallas_panel.py:640", 100, True,
                      6, 7, 6),
    "dipole_panel_df": ("lidp_tpu/ops/pallas_panel.py:892", 140, True,
                        9, 10, 3),
}
PAIR_KERNELS = ("pair_wolf_panel", "pair_panel", "pair_panel_df")
# the LJ cell kernels: wrapper -> TPU kernel it replaces
CELL_KERNELS = {
    "slot_lj_forces": "lidp_tpu/ops/pallas_pair.py:314",
    "cell_pair_forces_lj": "lidp_tpu/ops/pallas_pair.py:433",
}
ALL_KERNELS = (*KERNELS, *CELL_KERNELS)
LJ_FLOPS_PER_PAIR = 25   # pallas_pair.py:321, per candidate pair
MELT_STEPS = 100         # paths E, F, E4
MELT_WINDOW = 400        # path E's timed window
# step 0 and step 100 of the reference log of bench/in.lj (32,000 atoms)
LJ_LOG0 = dict(temp=(1.44, 1e-6), pe=(-6.7733681, 1e-5),
               etotal=(-4.6134356, 1e-5), press=(-5.0197073, 1e-4))
LJ_LOG100_ETOTAL = (-4.6223613, 2e-4)
SP_WIDTH = 8             # special-list slots of make_case and the fluid


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


def to_f64(c):
    """The same case in float64 (the float32 values exactly)."""
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in c.items()}


def tabs_for(ff_pair, dtype):
    import torch

    return torch.stack([ff_pair.lj3, ff_pair.lj4, ff_pair.offset,
                        ff_pair.cut_ljsq, ff_pair.cutsq]).to(dtype).contiguous()


def kernel_calls(c, c64, pair, s):
    """{label: (kernel name, wrapper call, plain call)} on case c (float32)
    and its float64 copy c64.  The label is the kernel's name for the form
    the main paths use, name[variant] for the other forms."""
    from lidp_tpu_torch.ops import panel

    pd, dmp = s.polar_damp, s.damping_type
    damp = dict(damping_type=dmp)
    scal = (pair.cut_coulsq, pair.qqrd2e, pair.g_ewald)
    out = {}

    def add(label, name, plain, args, **kw):
        wrapper = panel.WRAPPERS[name]
        out[label] = (name, lambda: wrapper(*args, **kw),
                      lambda: plain(*args, **kw))

    for d, suffix in ((c, ""), (c64, "_df")):
        tabs = tabs_for(pair, d["x"].dtype)
        add("eind_panel" + suffix, "eind_panel" + suffix,
            panel.eind_panel_plain, (d["x"], d["alpha"], d["mu"], d["L"], pd),
            **damp)
        add("dipole_panel" + suffix, "dipole_panel" + suffix,
            panel.dipole_panel_plain,
            (d["x"], d["q"], d["mol"], d["alpha"], d["mu"], d["mask"],
             d["L"], pd, pair.cut_coulsq, pair.qqrd2e), **damp)
        pargs = (d["x"], d["q"], d["type"], d["mask"], tabs, d["L"], *scal)
        if suffix:
            add("pair_panel_df", "pair_panel_df", panel.pair_panel_df_plain,
                pargs, sp=d["sp"], mol=d["mol"])
            add("pair_panel_df[no field]", "pair_panel_df",
                panel.pair_panel_df_plain, pargs, sp=d["sp"])
        else:
            add("pair_wolf_panel", "pair_wolf_panel",
                panel.pair_wolf_panel_plain,
                (d["x"], d["q"], d["type"], d["mol"], d["mask"], tabs,
                 d["L"], *scal), sp=d["sp"])
            add("pair_panel", "pair_panel", panel.pair_panel_plain, pargs,
                sp=d["sp"])
            add("pair_panel[lj only]", "pair_panel", panel.pair_panel_plain,
                pargs, sp=d["sp"], coul=False)
            add("wolf_panel", "wolf_panel", panel.wolf_panel_plain,
                (d["x"], d["q"], d["mol"], d["mask"], d["L"],
                 pair.cut_coulsq))
    return out


def compare(name, got, ref, f64=False):
    """float32: per-row outputs rtol 1e-4, atol 1e-5*max|ref|; scalars rel
    1e-4.  float64: rtol 1e-9, atol 1e-11*max|ref|; scalars rel 1e-10.
    Returns the largest per-row absolute difference and the largest |ref|
    of the per-row outputs."""
    import torch

    rtol, atol, srel = (1e-9, 1e-11, 1e-10) if f64 else (1e-4, 1e-5, 1e-4)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} outputs, plain {len(ref)}")
    worst = scale = 0.0
    for g, r in zip(got, ref):
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} vs "
                                 f"plain {r.dtype} {tuple(r.shape)}")
        g, r = g.double(), r.double()
        if g.dim() == 2:
            err = (g - r).abs()
            tol = rtol * r.abs() + atol * r.abs().max()
            bad = int((err > tol).sum())
            if bad or not torch.isfinite(g).all():
                raise AssertionError(f"{name}: {bad} per-row values off, max "
                                     f"abs err {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
            scale = max(scale, float(r.abs().max()))
        else:
            err = (g - r).abs()
            tol = srel * r.abs().reshape(-1).max().clamp(min=1e-30)
            if (err > tol).any() or not torch.isfinite(g).all():
                raise AssertionError(f"{name}: scalar {g.tolist()} vs "
                                     f"{r.tolist()}")
    return worst, scale


def bound_ms(name, nrows, npad, flops_per_pair=None):
    """Least time on the card: the larger of the flops (the CostEstimate
    per pair) over the FP32 or FP64 CUDA-core peak and the operand bytes
    (each input read once, each output written once) over the HBM rate."""
    _, fl, f64, rows, cols, outs = KERNELS[name]
    flops = (flops_per_pair or fl) * nrows * npad
    item = 8 if f64 else 4
    nbytes = item * (rows * nrows + cols * npad + outs * nrows + 8)
    if name in PAIR_KERNELS:
        nbytes += 4 * SP_WIDTH * nrows
    t_ops = flops / (FP64_PEAK if f64 else FP32_PEAK)
    t_bytes = nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def energy_row(tag, en):
    import torch

    vals = [float(en[k]) for k in ("evdwl", "ecoul", "elong", "epol")]
    if not all(math.isfinite(v) for v in vals) or \
            not bool(torch.isfinite(en["virial"]).all()):
        raise AssertionError(f"{tag}: non-finite energies {vals}")
    print(f"{tag}: evdwl {vals[0]:.6f} ecoul {vals[1]:.4f} "
          f"elong {vals[2]:.4f} epol {vals[3]:.6f} "
          f"scf_iters {en['scf_iters']}")


def check_counts(path, got, want):
    """The launch counters of one path: `want` for the kernels it runs, 0
    for every other."""
    want = {name: want.get(name, 0) for name in ALL_KERNELS}
    print(f"path {path} launches: {got}")
    if got != want:
        raise AssertionError(f"path {path}: launch counts {got} do not "
                             f"match the path ({want})")


def check_finite(path, bench):
    import torch

    for name in ("x", "v", "mu", "f"):
        if not bool(torch.isfinite(bench.arrays[name]).all()):
            raise AssertionError(f"path {path}: non-finite {name}")


def check_f64_step0(path, n, f, mu, en, ref_f, ref_mu, ref_en):
    """Step 0 of a float64 kernel path against the float64 plain path:
    evdwl/ecoul/elong rel 1e-10, epol rel 1e-8, f and mu atol 1e-8*max."""
    for k, rel in (("evdwl", 1e-10), ("ecoul", 1e-10), ("elong", 1e-10),
                   ("epol", 1e-8)):
        a, b = float(en[k]), float(ref_en[k])
        print(f"path {path} step 0 {k}: kernels {a:.12f}, plain {b:.12f}")
        if abs(a - b) > rel * abs(b):
            raise AssertionError(f"path {path} step 0 {k}: {a!r} vs {b!r}")
    for tag, a, b in (("forces", f, ref_f), ("dipoles", mu, ref_mu)):
        err = float((a[:n] - b[:n]).abs().max())
        big = float(b[:n].abs().max())
        print(f"path {path} step 0 {tag} vs float64 plain: max abs err "
              f"{err:.3e} of max {big:.3e}")
        if not err <= 1e-8 * big:
            raise AssertionError(f"path {path} step 0 {tag}: max abs err "
                                 f"{err:.3e} above 1e-8 of {big:.3e}")


def cell_bound_ms(name, shape, natoms):
    """Least time of an LJ cell kernel on the card: the TPU kernel's own
    count of the Newton half stencil, cells*cap*cap*14 candidate pairs at 25
    flops, over the FP32 peak, against the bytes it must move over the HBM
    rate (slot order: 3 grids in, 3 out; atom order: x, mask and
    atom_of_slot in, f out)."""
    nbx, nby, nbz, cap = shape
    slots = nbx * nby * nbz * cap
    flops = slots * cap * 14 * LJ_FLOPS_PER_PAIR
    if name == "slot_lj_forces":
        nbytes = 24 * slots + 4 * 8
    else:
        nbytes = 25 * natoms + 4 * slots + 4 * 8
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lj_compare(name, got, ref, need_ev, fscale=None):
    """(f, evdwl, virial) of an LJ cell kernel against its plain version:
    forces 5e-6 of max |f|, evdwl and virial rel 1e-5 of the largest entry
    (zeros when need_ev is off).  Returns (max abs force error, max |f|)."""
    import torch

    f, r = got[0].double(), ref[0].double()
    if f.shape != r.shape or got[0].dtype != ref[0].dtype:
        raise AssertionError(f"{name}: {got[0].dtype} {tuple(f.shape)} vs "
                             f"plain {ref[0].dtype} {tuple(r.shape)}")
    err, scale = float((f - r).abs().max()), float(r.abs().max())
    if not bool(torch.isfinite(f).all()) or \
            not err <= 5e-6 * (fscale or scale):
        raise AssertionError(f"{name}: forces max abs err {err:.3e} of max "
                             f"|f| {scale:.3e}")
    for tag, g, r in (("evdwl", got[1], ref[1]), ("virial", got[2], ref[2])):
        g, r = g.double().reshape(-1), r.double().reshape(-1)
        if need_ev:
            bad = bool(((g - r).abs() > 1e-5 * r.abs().max()).any())
        else:
            bad = bool(g.any())
        if bad or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {tag}: {g.tolist()} vs "
                                 f"{r.tolist()} (need_ev={need_ev})")
    return err, scale


def ragged_lj_case(device="cuda", seed=3):
    """A small float32 LJ input that stresses the cell kernels' edges: an
    uneven (3,4,5) grid of cap 16 in a box (8.8, 11.7, 14.6), one cell
    filled to cap, one cell empty (its atoms are masked out), 10% of the
    other atoms masked.  Returns dict(x, mask, box, pair, cfg, n), tensors
    on `device`; not a physical state."""
    import numpy as np
    import torch

    from lidp_tpu_torch import resolve_device
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.ops.cells import CellConfig
    from lidp_tpu_torch.ops.pair import make_pair_params

    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    L = np.array([8.8, 11.7, 14.6])
    nb = (3, 4, 5)
    h = L / np.array(nb)
    g = np.stack(np.meshgrid(np.arange(6), np.arange(8), np.arange(10),
                             indexing="ij"), -1).reshape(-1, 3)
    x = (g + 0.5 + rs.uniform(-0.12, 0.12, g.shape)) * (L / [6, 8, 10])
    cell = np.floor(x / h).astype(int)
    full = np.all(cell == (0, 0, 0), axis=1)
    empty = np.all(cell == (1, 2, 3), axis=1)
    x = x[~full]
    mask = ~empty[~full] & (rs.rand(x.shape[0]) > 0.1)
    # 16 atoms about 1.02 apart fill cell (0,0,0)
    m = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3)[:16]
    x = np.concatenate([x, 0.4 + 1.02 * m
                        + rs.uniform(-0.03, 0.03, m.shape)])
    mask = np.concatenate([mask, np.ones(16, bool)])
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    f32 = torch.float32
    return dict(
        x=torch.as_tensor(x, dtype=f32, device=device),
        mask=torch.as_tensor(mask, device=device),
        box=Box.create(np.zeros(3), L, dtype=f32, device=device),
        pair=make_pair_params(one, one, 2.5 * one, coul=False, dtype=f32,
                              device=device),
        cfg=CellConfig(nbins=nb, cap=16, cutneigh=2.8), n=x.shape[0])


def lj_kernel_calls(x, mask, box, pair, cfg, natoms):
    """{kernel name: (shape, call(need_ev) of the wrapper, of the plain
    version, timed(need_ev))}, each call returning (f, evdwl, virial6):
    slot_lj_forces on the slot state of (x, mask), cell_pair_forces_lj on
    their Cells.  `timed` is the call the runners make: SlotRunner passes
    the kernel's scalars it made at setup (`par=`), compute_forces lets the
    wrapper form them, a few scalar-sized torch launches, at every call."""
    import torch

    from lidp_tpu_torch.forcefield import ForceField
    from lidp_tpu_torch.integrate.slot_runner import SlotRunner
    from lidp_tpu_torch.ops import cell_kernels as ck
    from lidp_tpu_torch.ops.cells import build_cells

    cells = build_cells(x, mask, box, cfg)
    if bool(cells.overflow):
        raise AssertionError("the parity case overflows its cell grid")
    sr = SlotRunner(ff=ForceField(pair=pair), neighbor_cfg=cfg, dt=0.005,
                    ftm2v=1.0, n=natoms)
    n = x.shape[0]
    xs = sr._slotify(x, torch.zeros_like(x), torch.ones(n, device=x.device),
                     torch.arange(n, dtype=torch.int32, device=x.device),
                     mask, box)[0]
    grids = [xs[..., d] for d in range(3)]

    def slot(fn):
        def call(need_ev):
            fg, ev, vir = fn(grids, box, pair, need_ev=need_ev)
            return torch.stack(list(fg), dim=-1), ev, vir
        return call

    def atom(fn):
        def call(need_ev):
            f, ev, _, vir = fn(x, mask, cells, box, pair, need_ev=need_ev)
            return f, ev, vir
        return call

    shape = tuple(cells.atom_of_slot.shape)
    par_s = ck.lj_par(box, pair, ck.sentinel_scalars(box, pair)[0])
    return {
        "slot_lj_forces": (
            shape, slot(ck.slot_lj_forces), slot(ck.slot_lj_forces_plain),
            lambda ev: ck.slot_lj_forces(grids, box, pair, need_ev=ev,
                                         par=par_s)),
        "cell_pair_forces_lj": (
            shape, atom(ck.cell_pair_forces_lj),
            atom(ck.cell_pair_forces_lj_plain),
            lambda ev: ck.cell_pair_forces_lj(x, mask, cells, box, pair,
                                              need_ev=ev))}


def melt_row(tag, row):
    vals = [row[k] for k in ("temp", "pe", "etotal", "press")]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{tag}: non-finite thermo row {row}")
    print(f"{tag}: step {row['step']} temp {vals[0]:.7f} pe {vals[1]:.7f} "
          f"etotal {vals[2]:.7f} press {vals[3]:.7f}")


def check_rel(tag, got, want, rel):
    print(f"{tag}: {got:.9g} against {want:.9g} (rel "
          f"{abs(got - want) / abs(want):.2e}, bar {rel:g})")
    if not abs(got - want) <= rel * abs(want):
        raise AssertionError(f"{tag}: {got!r} is not within {rel:g} of "
                             f"{want!r}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lidp_tpu_torch.kernels import build
    from lidp_tpu_torch.models import lj_melt, polar_bench
    from lidp_tpu_torch.ops import cell_kernels, panel
    from lidp_tpu_torch.box import Box, wrap
    from lidp_tpu_torch.forcefield import pair_route
    from lidp_tpu_torch.ops.cells import build_cells, cell_pair_forces
    from lidp_tpu_torch.thermo import thermo_row

    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    wrappers = {**panel.WRAPPERS, **cell_kernels.WRAPPERS}
    if sorted(ALL_KERNELS) != sorted(wrappers):
        raise AssertionError("the kernel table does not list every wrapper")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(build.report())

    # 3. kernel parity and timing
    sysd = polar_bench.synthetic_system()
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, "cuda")
    results = {}
    cases = {"main": make_case(10_125, 12_288, 60.0, seed=1),
             "ragged": make_case(1_000, 1_000, 28.0, seed=2, n_masked=50)}
    for cname, c in cases.items():
        npad = c["x"].shape[0]
        calls = kernel_calls(c, to_f64(c), ff.pair, ff.polar)
        for label, (name, kern, plain) in calls.items():
            f64 = KERNELS[name][2]
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err, scale = compare(f"{label}[{cname}]", got, ref, f64)
            line = (f"parity {label}[{cname}] ok: max abs err {err:.3e} "
                    f"of max |ref| {scale:.3e}")
            del got, ref
            if cname == "main":
                ms = cuda_ms(kern, reps=20)
                pms = cuda_ms(plain, reps=3, warmup=1)
                flops = {"pair_panel_df[no field]": 70}.get(label)
                bms, by = bound_ms(name, npad, npad, flops)
                r = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by)
                if label == name:
                    results[name] = r
                else:
                    results[name].setdefault("variants", {})[label] = r
                line += (f", kernel {ms:.4f} ms, plain {pms:.3f} ms, "
                         f"bound {bms:.4f} ms ({by})")
            print(line)
        del calls
    del cases
    torch.cuda.empty_cache()

    # 4. the main paths: every counter to 0 just before, read just after
    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()

    def read_counts():
        torch.cuda.synchronize()
        return {name: wrappers[name].launches for name in ALL_KERNELS}

    launches = {}

    # path A: float32 fused step
    bench = polar_bench.build_synthetic()
    n = bench.natoms
    reset_counts()
    t0 = time.perf_counter()
    fA, enA = polar_bench.setup_forces(bench)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fA = fA.clone()
    t0 = time.perf_counter()
    _, per_step = polar_bench.run(bench, NSTEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["A"] = read_counts()
    print(f"path A: {n} atoms (npad {bench.npad}), float32, fused step")
    energy_row("A step 0 (init)", enA)
    for k, en in enumerate(per_step, 1):
        energy_row(f"A step {k}", en)
    check_finite("A", bench)
    scf = [enA["scf_iters"]] + [en["scf_iters"] for en in per_step]
    check_counts("A", launches["A"], dict(
        eind_panel=sum(it + 1 for it in scf), pair_wolf_panel=NSTEPS + 1,
        dipole_panel=NSTEPS + 1))
    steps_per_s = NSTEPS / t_run
    print(f"path A: init {t_init * 1e3:.1f} ms; {NSTEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s:.3f} steps/s; mean scf_iters "
          f"{statistics.mean(scf[1:]):.2f}")
    per_step_ms = {name: results[name]["ms"] * cnt / (NSTEPS + 1)
                   for name, cnt in launches["A"].items() if cnt}
    print("path A kernel ms per step (kernel ms x launches / evaluations): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_step_ms.items())
          + f"; step {1e3 / steps_per_s:.3f} ms")
    del bench, per_step

    # path B: float32 host phases, pure CG
    bench = polar_bench.build_synthetic()
    reset_counts()
    t0 = time.perf_counter()
    fB, enB = polar_bench.host_setup_forces(bench, mixed=False)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fB = fB.clone()
    t0 = time.perf_counter()
    per_step = [polar_bench.host_cg_step(bench, mixed=False)[1]
                for _ in range(HOST_STEPS)]
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["B"] = read_counts()
    print("path B: float32, host phases (HostPolarForces), pure CG")
    energy_row("B step 0 (init)", enB)
    for k, en in enumerate(per_step, 1):
        energy_row(f"B step {k}", en)
    check_finite("B", bench)
    evals = [enB] + per_step
    if not all(en["scf_converged"] for en in evals):
        raise AssertionError("path B: an SCF solve did not converge")
    scf = [en["scf_iters"] for en in evals]
    check_counts("B", launches["B"], dict(
        pair_panel=len(evals), wolf_panel=len(evals),
        eind_panel=sum(it + 1 for it in scf), dipole_panel=len(evals)))
    steps_per_s_B = HOST_STEPS / t_run
    print(f"path B: init {t_init * 1e3:.1f} ms; {HOST_STEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s_B:.3f} steps/s; scf_iters {scf}")
    for k in ("evdwl", "ecoul", "elong", "epol"):
        a, b = float(enB[k]), float(enA[k])
        print(f"path B step 0 {k}: host phases {a:.6f}, fused {b:.6f}")
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"path B step 0 {k}: {a} vs path A {b}")
    ferr = (fB[:n] - fA[:n]).abs()
    fmax = float(fA[:n].abs().max())
    if bool((ferr > 5e-4 * fA[:n].abs() + 5e-5 * fmax).any()):
        raise AssertionError(f"path B step 0 forces vs path A: max abs err "
                             f"{float(ferr.max()):.3e} (max |f| {fmax:.3e})")
    print(f"path B step 0 forces vs path A: max abs err "
          f"{float(ferr.max()):.3e} of max |f| {fmax:.3e}")
    print(f"steps_per_s_B {steps_per_s_B:.4f}")
    del bench, per_step, fB
    torch.cuda.empty_cache()

    # path C: float64 at 1e-11, host phases, mixed-precision solve
    kw64 = dict(dtype=torch.float64, precision=1e-11)
    bench = polar_bench.build_synthetic(**kw64)
    reset_counts()
    t0 = time.perf_counter()
    fC, enC = polar_bench.host_setup_forces(bench, mixed=True)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fC, muC = fC.clone(), bench.arrays["mu"].clone()
    outer = [bench.hpf.outer_passes]
    inner = [sum(bench.hpf.inner_iters)]
    per_step = []
    t0 = time.perf_counter()
    for _ in range(HOST_STEPS):
        per_step.append(polar_bench.host_cg_step(bench, mixed=True)[1])
        outer.append(bench.hpf.outer_passes)
        inner.append(sum(bench.hpf.inner_iters))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["C"] = read_counts()
    print("path C: float64, polar_precision 1e-11, host phases, mixed "
          "solve")
    energy_row("C step 0 (init)", enC)
    for k, en in enumerate(per_step, 1):
        energy_row(f"C step {k}", en)
    check_finite("C", bench)
    evals = [enC] + per_step
    if not all(en["scf_converged"] for en in evals):
        raise AssertionError("path C: an SCF solve did not converge")
    scf = [en["scf_iters"] for en in evals]
    # outer and inner are the loops' own counts; scf_iters is held to them
    if scf != [k + 2 * o for k, o in zip(inner, outer)]:
        raise AssertionError(f"path C: scf_iters {scf} is not inner {inner} "
                             f"+ 2 x outer {outer}")
    check_counts("C", launches["C"], dict(
        pair_panel_df=len(evals), eind_panel_df=sum(outer),
        eind_panel=sum(inner), dipole_panel_df=len(evals)))
    steps_per_s_C = HOST_STEPS / t_run
    print(f"path C: init {t_init * 1e3:.1f} ms; {HOST_STEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s_C:.3f} steps/s; scf_iters {scf}, "
          f"outer float64 passes {outer}, inner float32 iterations {inner}; "
          f"host reads per step: {statistics.mean(inner[1:]):.1f} in the "
          f"inner CG + {statistics.mean(outer[1:]):.1f} outer")
    print(f"steps_per_s_C {steps_per_s_C:.4f}")
    del bench, per_step
    torch.cuda.empty_cache()

    # path D: float64 fused step, initial forces only
    bench = polar_bench.build_synthetic(**kw64)
    reset_counts()
    t0 = time.perf_counter()
    fD, enD = polar_bench.setup_forces(bench)
    torch.cuda.synchronize()
    t_D = time.perf_counter() - t0
    launches["D"] = read_counts()
    muD = bench.arrays["mu"]
    energy_row("D step 0 (init)", enD)
    check_counts("D", launches["D"], dict(
        pair_panel_df=1, eind_panel_df=enD["scf_iters"] + 1,
        dipole_panel_df=1))
    print(f"path D: float64 fused step, pure CG through eind_panel_df: "
          f"{t_D:.4f} s for the initial forces, scf_iters "
          f"{enD['scf_iters']}")
    print(f"seconds_D {t_D:.4f}")
    del bench

    # step 0 of A, C and D against the float64 plain path on the card
    ref = polar_bench.build_synthetic(panel="scan", **kw64)
    t0 = time.perf_counter()
    f64, en64 = polar_bench.setup_forces(ref)
    torch.cuda.synchronize()
    print(f"float64 plain path (panel='scan', pure CG at 1e-11): "
          f"{time.perf_counter() - t0:.3f} s, scf_iters "
          f"{en64['scf_iters']}")
    mu64 = ref.arrays["mu"]
    for k in ("evdwl", "ecoul", "elong", "epol"):
        a, b = float(enA[k]), float(en64[k])
        tol = 2e-2 if k == "epol" else 1e-4 * abs(b)
        print(f"path A step 0 {k}: f32 kernels {a:.6f}, f64 plain {b:.6f}")
        if abs(a - b) > tol:
            raise AssertionError(f"path A step 0 {k}: {a} vs float64 {b}")
    fref = f64[:n]
    ferr = (fA[:n].double() - fref).abs()
    fmax = float(fref.abs().max())
    if bool((ferr > 5e-4 * fref.abs() + 5e-5 * fmax).any()):
        raise AssertionError(f"path A step 0 forces vs float64: max abs err "
                             f"{float(ferr.max()):.3e} (max |f| {fmax:.3e})")
    print(f"path A step 0 forces vs float64 plain: max abs err "
          f"{float(ferr.max()):.3e} of max |f| {fmax:.3e}")
    check_f64_step0("C", n, fC, muC, enC, f64, mu64, en64)
    check_f64_step0("D", n, fD, muD, enD, f64, mu64, en64)
    if abs(enD["scf_iters"] - en64["scf_iters"]) > 1:
        raise AssertionError(f"path D scf_iters {enD['scf_iters']} vs plain "
                             f"{en64['scf_iters']}")
    print(f"steps_per_s {steps_per_s:.4f}")

    del ref, f64, mu64, fC, muC, fD, muD, fA
    torch.cuda.empty_cache()

    # 5. the LJ melt on the cell engine: path E, kernel parity on its last
    # state, then paths F and E4
    f32 = torch.float32
    melt = lj_melt.build(scale=1, dtype=f32, neighbor="slots")
    msys = melt.system

    # path E: the 32,000-atom melt through SlotRunner
    reset_counts()
    t0 = time.perf_counter()
    sysE, resE, nlE, carry = melt.runner.setup(msys)
    rowE0 = thermo_row(sysE, resE, melt.thermo)
    t_init = time.perf_counter() - t0
    fE0 = resE.f.clone()
    sysE, resE, nlE, carry = melt.runner.run(sysE, resE, nlE, carry,
                                             MELT_STEPS)
    rowE100 = thermo_row(sysE, resE, melt.thermo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysE, resE, nlE, carry = melt.runner.run(sysE, resE, nlE, carry,
                                             MELT_WINDOW)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["E"] = read_counts()
    rowE500 = thermo_row(sysE, resE, melt.thermo)
    cfg = melt.runner.neighbor_cfg
    print(f"path E: {melt.natoms} atoms, float32, SlotRunner, grid "
          f"{cfg.nbins} x cap {cfg.cap}, rebuild every "
          f"{melt.runner.rebuild_every}")
    for tag, row in (("E step 0", rowE0), ("E step 100", rowE100),
                     (f"E step {MELT_STEPS + MELT_WINDOW}", rowE500)):
        melt_row(tag, row)
    if bool(nlE.overflow):
        raise AssertionError("path E: a cell overflowed its capacity")
    if rowE500["step"] != MELT_STEPS + MELT_WINDOW:
        raise AssertionError(f"path E: step {rowE500['step']}")
    for k, (want, rel) in LJ_LOG0.items():
        check_rel(f"path E step 0 {k} vs the reference log", rowE0[k], want,
                  rel)
    check_rel("path E step 100 etotal vs the reference log",
              rowE100["etotal"], *LJ_LOG100_ETOTAL)
    check_counts("E", launches["E"], dict(
        slot_lj_forces=1 + MELT_STEPS + 1 + MELT_WINDOW + 1))
    steps_per_s_E = MELT_WINDOW / t_run
    print(f"path E: setup + row {t_init * 1e3:.1f} ms; {MELT_WINDOW} steps "
          f"in {t_run:.4f} s = {steps_per_s_E:.1f} steps/s "
          f"({1e3 * t_run / MELT_WINDOW:.4f} ms/step)")
    print(f"steps_per_s_E {steps_per_s_E:.4f}")

    # kernel parity: on the melt after path E's steps (wrapped into the box,
    # as a rebuild leaves it) and on the ragged case
    melted, _ = wrap(sysE.x, sysE.box, sysE.image)
    rag = ragged_lj_case()
    lj_cases = {
        "melt": (melted, msys.mask, msys.box, melt.runner.ff.pair,
                 melt.runner.neighbor_cfg, melt.natoms),
        "ragged": tuple(rag[k] for k in ("x", "mask", "box", "pair", "cfg",
                                         "n"))}
    for cname, case in lj_cases.items():
        for name, (shape, kern, plain, timed) in \
                lj_kernel_calls(*case).items():
            for need_ev in (False, True):
                got, ref = kern(need_ev), plain(need_ev)
                torch.cuda.synchronize()
                label = f"{name}[{cname}, need_ev={need_ev}]"
                err, scale = lj_compare(label, got, ref, need_ev)
                again = kern(need_ev)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: a repeated launch "
                                         f"differs")
                line = (f"parity {label} ok on grid {shape}: max abs err "
                        f"{err:.3e} of max |f| {scale:.3e}")
                del got, ref, again
                if cname == "melt":
                    ms = cuda_ms(lambda: timed(need_ev), reps=20)
                    pms = cuda_ms(lambda: plain(need_ev), reps=3, warmup=1)
                    bms, by = cell_bound_ms(name, shape, melt.natoms)
                    r = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                             bound_ms=bms, bound_by=by)
                    if need_ev:
                        results[name]["variants"] = {f"{name}[need_ev]": r}
                    else:
                        results[name] = r
                    line += (f", kernel {ms:.4f} ms, plain {pms:.3f} ms, "
                             f"bound {bms:.4f} ms ({by})")
                print(line)
    del lj_cases, rag, melted
    torch.cuda.empty_cache()

    # step 0 of E against the float64 plain route on the card
    x64 = msys.x.double()
    box64 = Box(lo=msys.box.lo.double(), hi=msys.box.hi.double())
    cells64 = build_cells(x64, msys.mask, box64, cfg)
    f64, ev64, _, _ = cell_pair_forces(
        x64, msys.q.double(), msys.type, msys.mask, cells64, box64,
        melt.runner.ff.pair)
    fscale = max(float(f64.abs().max()), 1.0)
    ferr = float((fE0.double() - f64).abs().max())
    print(f"path E step 0 forces vs float64 plain: max abs err {ferr:.3e} "
          f"of max(max |f|, 1) {fscale:.3e}")
    if not ferr <= 1e-5 * fscale:
        raise AssertionError(f"path E step 0 forces vs float64: {ferr:.3e}")
    check_rel("path E step 0 evdwl vs float64 plain", rowE0["evdwl"],
              float(ev64) / melt.natoms, 1e-6)
    del x64, cells64, f64, carry

    # path F: the same melt through the generic Runner on cells
    meltF = lj_melt.build(scale=1, dtype=f32, neighbor="cells")
    reset_counts()
    sysF, resF, nlF, ist = meltF.runner.setup(meltF.system)
    rowF0 = thermo_row(sysF, resF, meltF.thermo)
    fF0 = resF.f.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysF, resF, nlF, ist = meltF.runner.run(sysF, resF, nlF, ist, MELT_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["F"] = read_counts()
    rowF100 = thermo_row(sysF, resF, meltF.thermo)
    print(f"path F: {meltF.natoms} atoms, float32, Runner on cells, pair "
          f"route {pair_route(sysF, meltF.runner.ff, nlF.nlist)}")
    melt_row("F step 0", rowF0)
    melt_row("F step 100", rowF100)
    if bool(nlF.overflow):
        raise AssertionError("path F: a cell overflowed its capacity")
    check_counts("F", launches["F"], dict(
        cell_pair_forces_lj=1 + MELT_STEPS + 1))
    for k in ("temp", "pe", "etotal", "press"):
        check_rel(f"path F step 0 {k} vs path E", rowF0[k], rowE0[k], 1e-5)
    fscale = max(float(fE0.abs().max()), 1.0)
    ferr = float((fF0 - fE0).abs().max())
    print(f"path F step 0 forces vs path E: max abs err {ferr:.3e} of "
          f"max(max |f|, 1) {fscale:.3e}")
    if not ferr <= 5e-6 * fscale:
        raise AssertionError(f"path F step 0 forces vs path E: {ferr:.3e}")
    check_rel("path F step 100 etotal vs path E", rowF100["etotal"],
              rowE100["etotal"], 1e-4)
    for k in ("temp", "pe"):
        check_rel(f"path F step 100 {k} vs path E", rowF100[k], rowE100[k],
                  2e-3)
    steps_per_s_F = MELT_STEPS / t_run
    print(f"path F: {MELT_STEPS} steps in {t_run:.4f} s = "
          f"{steps_per_s_F:.1f} steps/s")
    print(f"steps_per_s_F {steps_per_s_F:.4f}")
    del meltF, sysF, resF, nlF, ist, melt, sysE, resE
    torch.cuda.empty_cache()

    # path E4: SlotRunner at scale 4
    t0 = time.perf_counter()
    melt4 = lj_melt.build(scale=4, dtype=f32, neighbor="slots")
    t_build = time.perf_counter() - t0
    cfg = melt4.runner.neighbor_cfg
    reset_counts()
    sys4, res4, nl4, carry = melt4.runner.setup(melt4.system)
    row0 = thermo_row(sys4, res4, melt4.thermo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys4, res4, nl4, carry = melt4.runner.run(sys4, res4, nl4, carry,
                                              MELT_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["E4"] = read_counts()
    row100 = thermo_row(sys4, res4, melt4.thermo)
    print(f"path E4: {melt4.natoms} atoms (scale 4), float32, SlotRunner, "
          f"grid {cfg.nbins} x cap {cfg.cap}; built on the host in "
          f"{t_build:.1f} s")
    melt_row("E4 step 0", row0)
    melt_row("E4 step 100", row100)
    if bool(nl4.overflow):
        raise AssertionError("path E4: a cell overflowed its capacity")
    check_counts("E4", launches["E4"], dict(
        slot_lj_forces=1 + MELT_STEPS + 1))
    check_rel("path E4 step 0 pe vs the reference log", row0["pe"],
              *LJ_LOG0["pe"])
    check_rel("path E4 step 100 etotal vs the reference log",
              row100["etotal"], LJ_LOG100_ETOTAL[0], 1e-3)
    check_rel("path E4 step 100 etotal vs step 0", row100["etotal"],
              row0["etotal"], 3e-3)
    # the slot kernel at this grid, on the run's last state: against its
    # plain version, need_ev off (the form the steps launch) and on
    pair4, box4 = melt4.runner.ff.pair, sys4.box
    par4 = cell_kernels.lj_par(
        box4, pair4, cell_kernels.sentinel_scalars(box4, pair4)[0])
    grids4 = [carry.x[..., d] for d in range(3)]
    shape4 = tuple(grids4[0].shape)
    bms4, by4 = cell_bound_ms("slot_lj_forces", shape4, melt4.natoms)

    def slot4(fn, need_ev, **kw):
        fg, ev, vir = fn(grids4, box4, pair4, need_ev=need_ev, **kw)
        return torch.stack(list(fg), dim=-1), ev, vir

    for need_ev in (False, True):
        label = f"slot_lj_forces[scale 4, need_ev={need_ev}]"
        got = slot4(cell_kernels.slot_lj_forces, need_ev, par=par4)
        ref = slot4(cell_kernels.slot_lj_forces_plain, need_ev)
        torch.cuda.synchronize()
        err4, scale4 = lj_compare(label, got, ref, need_ev)
        del ref
        again = slot4(cell_kernels.slot_lj_forces, need_ev, par=par4)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: a repeated launch differs")
        del got, again
        ms4 = cuda_ms(lambda: cell_kernels.slot_lj_forces(
            grids4, box4, pair4, need_ev=need_ev, par=par4), reps=10)
        pms4 = cuda_ms(lambda: cell_kernels.slot_lj_forces_plain(
            grids4, box4, pair4, need_ev=need_ev), reps=2, warmup=0)
        key = "scale 4, need_ev" if need_ev else "scale 4"
        results["slot_lj_forces"]["variants"][f"slot_lj_forces[{key}]"] = \
            dict(max_abs_err=err4, ms=ms4, plain_ms=pms4, bound_ms=bms4,
                 bound_by=by4)
        print(f"parity {label} ok on grid {shape4}: max abs err {err4:.3e} "
              f"of max |f| {scale4:.3e}, kernel {ms4:.4f} ms, plain "
              f"{pms4:.1f} ms, bound {bms4:.4f} ms ({by4})")
    torch.cuda.empty_cache()
    steps_per_s_E4 = MELT_STEPS / t_run
    print(f"path E4: {MELT_STEPS} steps in {t_run:.4f} s = "
          f"{steps_per_s_E4:.2f} steps/s "
          f"({1e3 * t_run / MELT_STEPS:.3f} ms/step)")
    print(f"steps_per_s_E4 {steps_per_s_E4:.4f}")
    del melt4, sys4, res4, nl4, carry, grids4

    # 6. results
    total = {name: sum(launches[p][name] for p in launches)
             for name in ALL_KERNELS}
    never = [name for name, cnt in total.items() if cnt == 0]
    if never:
        raise AssertionError(f"kernels no path launched: {never}")
    out = []
    replaced = {**{k: v[0] for k, v in KERNELS.items()}, **CELL_KERNELS}
    for name, replaces in replaced.items():
        r = results[name]
        row = dict(name=name, route="cuda",
                   source=f"lidp_tpu_torch/csrc/{name}.cu",
                   replaces=replaces, launches=total[name],
                   launches_by_path={p: launches[p][name] for p in launches},
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], library_ms=None)
        if "variants" in r:
            row["variants"] = r["variants"]
        out.append(row)
    print(json.dumps({"kernels": out}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
