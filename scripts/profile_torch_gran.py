#!/usr/bin/env python3
"""The granular contact pass on one GPU: the live candidate pairs against
the whole slot-pair block (lidp_tpu_torch/ops/granular.py).

    python3 scripts/profile_torch_gran.py [--steps 1000] [--reps 10]

Runs chip_smoke.py's granular paths AY (bench/in.chute's lines on a
32,000-grain seeded chute) and AZ (8,000 grains poured onto an
8,000-grain bed) through the CLI on the card in float64, prints their
readings as chip_smoke.py's gran_readings does (steps/s by the Loop time
line, peak, rebuilds, candidate pairs, a contact pass's and the walls'
ms), then on each final state times, in turns (module, block, block,
module), `--reps` calls each by CUDA events:
  * module: gran_cell_forces on the grid's candidate pairs, its history
    updated in place (a copy of the final one), and candidate_pairs, the
    pairs of a new grid, which a step pays once a rebuild;
  * block: the same arithmetic on every slot pair of the (offsets,
    cells, cap, cap) block, masked, as the JAX package evaluates it
    (lidp_tpu/ops/granular.py), its sums along the block's rows, a new
    history written whole; in groups of offsets of at most 2^25 slot
    pairs (ops/eam.py's GROUP_PAIRS), so that a group's float64
    temporaries stay near 270 MB each.
Each time is the median of the calls; the block's forces, torques and
history are held against the module's (the largest difference over the
largest entry), and each form's peak memory above the state's is read by
torch.cuda.max_memory_allocated.  Every figure is printed beside the
card's name and power limit.  Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_PAIRS = 1 << 25


def block_contact(x, v, omega, mask, cells, box, p, shear,
                  shear_update=True):
    """gran_cell_forces' arithmetic on the whole slot-pair block, masked:
    (f, torque, the new history)."""
    import torch

    from lidp_tpu_torch.box import minimum_image
    from lidp_tpu_torch.ops import granular as gran

    n = x.shape[0]
    aos = cells.atom_of_slot
    nbins = tuple(aos.shape[:3])
    cap = aos.shape[-1]
    ncell = nbins[0] * nbins[1] * nbins[2]
    aos = aos.reshape(ncell, cap).long()
    valid = aos < n
    am = torch.clamp(aos, max=n - 1)

    def slot(a, fill=0.0):
        return torch.where(valid, a[am], fill)

    xs = [slot(x[:, d]) for d in range(3)]
    vs = [slot(v[:, d]) for d in range(3)]
    ws = [slot(omega[:, d]) for d in range(3)]
    rad = slot(p.radius)
    ms = slot(p.rmass, 1.0)
    frz = valid & p.frozen[am]
    exc = None if p.excl is None else valid & p.excl[am]
    fwd = gran._cell_index(nbins, x.device)
    noff = fwd.shape[0]
    # the cell each partner cell's sums go home from: inv[g, fwd[g, c]] = c
    inv = torch.empty_like(fwd)
    inv.scatter_(1, fwd, torch.arange(ncell, device=x.device).expand_as(fwd))
    ar = torch.arange(cap, device=x.device)
    tri = ar[:, None] < ar[None, :]
    L = box.img_lengths
    G = max(1, min(noff, GROUP_PAIRS // (ncell * cap * cap)))
    sides, shear_new = [], []
    for g0 in range(0, noff, G):
        idx = fwd[g0:g0 + G]
        ng = idx.shape[0]

        def ctr(a):
            return a[None, :, :, None]

        def nbr(a):
            return a[idx][:, :, None, :]

        ok = ctr(valid) & nbr(valid)
        if g0 == 0:
            ok[0] &= tri
        if exc is not None:
            ok = ok & ~(ctr(exc) & nbr(exc))
        dx, dy, dz = (minimum_image(ctr(a) - nbr(a), L[k])
                      for k, a in enumerate(xs))
        rsq = dx * dx + dy * dy + dz * dz
        radi, radj = ctr(rad), nbr(rad)
        radsum = radi + radj
        touch = ok & (rsq < radsum * radsum)
        rsq = torch.where(touch, rsq, 1.0)
        r = torch.sqrt(rsq)
        rinv = 1.0 / r
        rsqinv = 1.0 / rsq
        vr1, vr2, vr3 = (ctr(a) - nbr(a) for a in vs)
        vnnr = vr1 * dx + vr2 * dy + vr3 * dz
        vt1 = vr1 - dx * vnnr * rsqinv
        vt2 = vr2 - dy * vnnr * rsqinv
        vt3 = vr3 - dz * vnnr * rsqinv
        wr1, wr2, wr3 = ((radi * ctr(a) + radj * nbr(a)) * rinv for a in ws)
        mi, mj = ctr(ms), nbr(ms)
        meff = mi * mj / (mi + mj)
        meff = torch.where(ctr(frz), mj, meff)
        meff = torch.where(nbr(frz), mi, meff)
        damp = meff * p.gamman * vnnr * rsqinv
        ccel = torch.where(touch, p.kn * (radsum - r) * rinv - damp, 0.0)
        if p.kind == "hertz/history":
            polyhertz = torch.sqrt(torch.clamp(
                (radsum - r) * radi * radj / radsum, min=0.0))
            polyhertz = torch.where(touch, polyhertz, 0.0)
            ccel = ccel * polyhertz
        else:
            polyhertz = 1.0
        vtr1 = vt1 - (dz * wr2 - dy * wr3)
        vtr2 = vt2 - (dx * wr3 - dz * wr1)
        vtr3 = vt3 - (dy * wr1 - dx * wr2)
        fn = p.xmu * torch.abs(ccel * r)
        if p.kind == "hooke":
            vrel = torch.sqrt(vtr1 * vtr1 + vtr2 * vtr2 + vtr3 * vtr3)
            fsd = meff * p.gammat * vrel
            ft = torch.where(vrel != 0.0, torch.minimum(fn, fsd)
                             / torch.where(vrel > 0, vrel, 1.0), 0.0)
            fs1 = torch.where(touch, -ft * vtr1, 0.0)
            fs2 = torch.where(touch, -ft * vtr2, 0.0)
            fs3 = torch.where(touch, -ft * vtr3, 0.0)
            shear_new.append(shear[g0:g0 + ng])
        else:
            sh = shear[g0:g0 + ng].reshape(ng, ncell, cap, cap, 3)
            s1, s2, s3 = sh[..., 0], sh[..., 1], sh[..., 2]
            if shear_update:
                s1 = s1 + vtr1 * p.dt
                s2 = s2 + vtr2 * p.dt
                s3 = s3 + vtr3 * p.dt
            shrmag = torch.sqrt(s1 * s1 + s2 * s2 + s3 * s3)
            if shear_update:
                rsht = (s1 * dx + s2 * dy + s3 * dz) * rsqinv
                s1 = s1 - rsht * dx
                s2 = s2 - rsht * dy
                s3 = s3 - rsht * dz
            gmv = meff * p.gammat
            fs1 = -polyhertz * (p.kt * s1 + gmv * vtr1)
            fs2 = -polyhertz * (p.kt * s2 + gmv * vtr2)
            fs3 = -polyhertz * (p.kt * s3 + gmv * vtr3)
            fs = torch.sqrt(fs1 * fs1 + fs2 * fs2 + fs3 * fs3)
            over = touch & (fs > fn)
            nz = shrmag != 0.0
            scale = torch.where(over & nz,
                                fn / torch.where(fs > 0, fs, 1.0), 1.0)
            if shear_update:
                gt_kt = gmv / p.kt
                resc = over & nz
                s1 = torch.where(resc, scale * (s1 + gt_kt * vtr1)
                                 - gt_kt * vtr1, s1)
                s2 = torch.where(resc, scale * (s2 + gt_kt * vtr2)
                                 - gt_kt * vtr2, s2)
                s3 = torch.where(resc, scale * (s3 + gt_kt * vtr3)
                                 - gt_kt * vtr3, s3)
            live = touch & ~(over & ~nz)
            fs1 = torch.where(live, fs1 * scale, 0.0)
            fs2 = torch.where(live, fs2 * scale, 0.0)
            fs3 = torch.where(live, fs3 * scale, 0.0)
            shear_new.append(torch.where(
                touch[..., None], torch.stack([s1, s2, s3], -1),
                0.0).reshape(shear[g0:g0 + ng].shape))
        fxp = dx * ccel + fs1
        fyp = dy * ccel + fs2
        fzp = dz * ccel + fs3
        tor1 = rinv * (dy * fs3 - dz * fs2)
        tor2 = rinv * (dz * fs1 - dx * fs3)
        tor3 = rinv * (dx * fs2 - dy * fs1)
        own = torch.stack([a.sum(-1) for a in (
            fxp, fyp, fzp, -(radi * tor1), -(radi * tor2),
            -(radi * tor3))], -1)
        part = torch.stack([a.sum(-2) for a in (
            fxp, fyp, fzp, radj * tor1, radj * tor2, radj * tor3)], -1)
        home = part[torch.arange(ng, device=x.device)[:, None],
                    inv[g0:g0 + ng]]
        sides += [(own[k], home[k]) for k in range(ng)]
    acc = x.new_zeros((ncell, cap, 6))
    for own, home in sides:
        acc = acc + own - home
    soa = torch.clamp(cells.slot_of_atom, max=ncell * cap - 1).long()
    out = torch.where(mask[:, None], acc.reshape(-1, 6)[soa], 0.0)
    return out[:, :3], out[:, 3:], torch.cat(shear_new)


def ms_of(fn, reps):
    """Per-call CUDA-event times of `reps` calls after one warm-up."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def peak_above(fn):
    """The bytes fn() allocates above what is allocated before it."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def compare(path, script, steps, reps, smi):
    import torch

    from lidp_tpu_torch.ops import granular as gran

    sim = script._sim
    runner, st, s = sim.runner, sim.istate, sim.sys
    gp = runner.gp
    work = st.shear.clone()

    def module():
        return gran.gran_cell_forces(s.x, s.v, st.omega, s.mask, sim.nlist,
                                     s.box, gp, work, st.pairs)

    def block():
        return block_contact(s.x, s.v, st.omega, s.mask, sim.nlist, s.box,
                             gp, st.shear)

    def pairs():
        return runner.pairs_of(sim.nlist)

    fb, tb, shb = block()
    fm, tm, shm, _ = gran.gran_cell_forces(
        s.x, s.v, st.omega, s.mask, sim.nlist, s.box, gp, st.shear.clone(),
        st.pairs)
    errs = []
    for name, a, b in (("f", fm, fb), ("torque", tm, tb),
                       ("shear", shm, shb)):
        big = float(torch.max(torch.abs(a)))
        errs.append(f"{name} {float(torch.max(torch.abs(a - b))):.3e} of "
                    f"{big:.6g}")
    del fb, tb, shb, fm, tm, shm
    times = {"module": [], "block": [], "candidate_pairs": []}
    for name in ("module", "block", "block", "module"):
        times[name] += ms_of(module if name == "module" else block, reps)
    times["candidate_pairs"] = ms_of(pairs, reps)
    peaks = {"module": peak_above(module), "block": peak_above(block),
             "candidate_pairs": peak_above(pairs)}
    per = steps / max(runner.rebuilds, 1)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"path {path}: grid {tuple(sim.nlist.atom_of_slot.shape)}, "
          f"{int(st.pairs.flat.shape[0])} candidate pairs of "
          f"{st.shear.numel() // 3} slot pairs; block against module: "
          + ", ".join(errs))
    for k in ("module", "block", "candidate_pairs"):
        print(f"path {path}: {k} {med[k]:.4f} ms (median of "
              f"{len(times[k])}; {min(times[k]):.4f}-{max(times[k]):.4f}), "
              f"peak {peaks[k] / 2**20:.1f} MiB above the state; {smi}")
    print(f"path {path}: a step's contact work, module "
          f"{med['module'] + med['candidate_pairs'] / per:.4f} ms (the pass "
          f"and candidate_pairs once in {per:.1f} steps: {runner.rebuilds} "
          f"rebuilds in {steps}), block {med['block']:.4f} ms; {smi}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of each path (chip_smoke.py's GRAN_STEPS)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_gran: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = cs.smi_line()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}")
    steps = args.steps or cs.GRAN_STEPS
    work = tempfile.mkdtemp(prefix="profile_torch_gran_")
    try:
        for path in ("AY", "AZ"):
            d = os.path.join(work, path)
            os.makedirs(d)
            if path == "AY":
                cs.chute_layout(os.path.join(d, "data.chute"), *cs.AY_CHUTE)
                name, text = "in.chute", cs.CHUTE_SCRIPT
            else:
                name, text = "in.bed", cs.pour_bed_case(
                    d, *cs.AZ_BED, cs.AZ_POUR, cs.AZ_HEIGHT)
            script, log, peak = cs.gran_run(
                path, d, name, cs.gran_text(text, cs.GRAN_EVERY), steps)
            cs.gran_readings(path, script, log, steps, peak)
            compare(path, script, steps, args.reps, smi)
            del script
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
