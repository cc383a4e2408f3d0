"""Granular contact forces: pair gran/hooke, gran/hooke/history and
gran/hertz/history on the cell grid, the sphere/wall contacts of fix
wall/gran, and compute erotate/sphere (lidp_tpu/ops/granular.py).

Reference: pair_gran_hooke_history.cpp::compute (:100-315), Hookean
normal contact with velocity damping and tangential shear-history
friction with Coulomb rescaling; settings (:343): kn, kt = NULL -> 2/7 kn,
gamman, gammat = NULL -> gamman/2 (0 when dampflag is 0), xmu.
pair_gran_hooke.cpp keeps no history; pair_gran_hertz_history.cpp scales
both forces by polyhertz = sqrt(overlap * ri rj / (ri + rj)).

The shear history keeps the JAX package's layout: one (noff, bx, by, bz,
cap, cap, 3) tensor over the candidate slot pairs of the cell grid
(ops/cells.py: the own cell's upper triangle, then the 13 offsets of the
Newton half stencil), updated elementwise each step.  On a rebuild the
grid re-sorts; `migrate_shear` keeps a pair's history only where both of
its (cell, slot) endpoints still hold the same atoms, and zeroes it
elsewhere (LAMMPS's FixNeighHistory keys it by atom IDs instead: ROADMAP
queue 3).

Plain PyTorch, no kernel: the contact arithmetic runs on the candidate
pairs whose two slots hold atoms (candidate_pairs, formed once a grid:
its one host read), not on the whole (noff, cells, cap, cap) block; the
per-atom sums are taken row by row as the JAX package's dense rows are
(a row's pairs gathered by a table formed with the pairs, in the row's
order), then offset by offset, +i side, -j side: no float atomics, the
same bits on every run.  Every sqrt and division is
guarded with `where` before it is taken, as there, so a lane out of
contact carries no NaN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.box import Box, minimum_image
from lidp_tpu_torch.ops.cells import Cells, half_offsets

# compute_erotate_sphere.cpp / fix_nve_sphere.cpp: I = INERTIA m r^2
INERTIA = 0.4


@dataclasses.dataclass(frozen=True)
class GranParams:
    """The pair style's coefficients (host floats) and the per-atom
    tensors it reads."""

    kn: float
    kt: float
    gamman: float
    gammat: float
    xmu: float
    radius: torch.Tensor      # (N,)
    rmass: torch.Tensor       # (N,)
    frozen: torch.Tensor      # (N,) bool: fix freeze's group (meff rule)
    excl: torch.Tensor = None  # (N,) bool: neigh_modify exclude group
    dt: float = 1.0
    # hooke/history, hooke (no shear state) or hertz/history
    kind: str = "hooke/history"


def gran_coeffs(args):
    """(kn, kt, gamman, gammat, xmu) of the six pair_style (or fix
    wall/gran) tokens kn kt gamman gammat xmu dampflag."""
    kn = float(args[0])
    kt = kn * 2.0 / 7.0 if args[1] == "NULL" else float(args[1])
    gamman = float(args[2])
    gammat = 0.5 * gamman if args[3] == "NULL" else float(args[3])
    xmu = float(args[4])
    if int(args[5]) == 0:
        gammat = 0.0
    return kn, kt, gamman, gammat, xmu


def make_gran_params(args, radius, rmass, frozen, excl=None, dt=1.0,
                     dtype=torch.float64, kind="hooke/history",
                     device="cpu") -> GranParams:
    """GranParams of the 6 pair_style tokens; hertz/history takes kn and
    kt as given, as the reference's coeff does in its units."""
    kn, kt, gamman, gammat, xmu = gran_coeffs(args)

    def t(a, d=dtype):
        return torch.as_tensor(np.asarray(a), dtype=d, device=device)

    return GranParams(
        kn=kn, kt=kt, gamman=gamman, gammat=gammat, xmu=xmu,
        radius=t(radius), rmass=t(rmass), frozen=t(frozen, torch.bool),
        excl=None if excl is None else t(excl, torch.bool), dt=float(dt),
        kind=kind)


def gran_offsets(nbins):
    """The own cell, then the Newton half stencil of the grid."""
    return [(0, 0, 0)] + half_offsets(nbins)


def shear_shape(cells: Cells):
    aos = cells.atom_of_slot
    noff = len(gran_offsets(aos.shape[:3]))
    return (noff,) + tuple(aos.shape) + (aos.shape[-1], 3)


# a grid's offset cells by (nbins, device): a few entries a process
_CELL_INDEX = {}


def _cell_index(nbins, device):
    """(noff, ncells) long: the cell at c + off of each offset (periodic
    over the grid, as the rolls of the JAX package), cached per grid and
    device."""
    key = (tuple(nbins), str(device))
    if key not in _CELL_INDEX:
        nb = np.asarray(nbins)
        c = np.stack(np.meshgrid(*[np.arange(k) for k in nbins],
                                 indexing="ij"), -1).reshape(-1, 3)
        fwd = [c + o for o in gran_offsets(nbins)]
        fwd = np.stack([((a[:, 0] % nb[0]) * nb[1] + a[:, 1] % nb[1])
                        * nb[2] + a[:, 2] % nb[2] for a in fwd])
        _CELL_INDEX[key] = torch.as_tensor(fwd, device=device)
    return _CELL_INDEX[key]


@dataclasses.dataclass(frozen=True)
class CandidatePairs:
    """The candidate slot pairs of a grid that hold two atoms: their
    positions in the shear layout (flat, row-major over (noff, cells,
    cap, cap), ascending) and their atoms (ai on the centre cell's slot,
    aj on the offset cell's); and for each side the rows of the sums:
    dest_* the (offset, cell, slot) a row lands on in the (noff, cells,
    cap) layout, rows_* its pairs (P, the index of a zero, pads the row),
    in the order of the JAX package's dense row.  They change only when
    the grid does."""

    flat: torch.Tensor
    ai: torch.Tensor
    aj: torch.Tensor
    dest_i: torch.Tensor
    rows_i: torch.Tensor
    dest_j: torch.Tensor
    rows_j: torch.Tensor


def _sum_rows(key, order, cap):
    """(the distinct keys, the (nkeys, cap) table of the pairs of each,
    padded with P) for pair keys taken in `order` (keys ascending)."""
    P = key.shape[0]
    k = key[order]
    uniq, counts = torch.unique_consecutive(k, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    row = torch.repeat_interleave(
        torch.arange(uniq.shape[0], device=key.device), counts)
    table = torch.full((uniq.shape[0], cap), P, dtype=torch.long,
                       device=key.device)
    table[row, torch.arange(P, device=key.device) - start[row]] = order
    return uniq, table


def candidate_pairs(cells: Cells, n: int, excl=None) -> CandidatePairs:
    """The pairs the contact pass evaluates: both slots live, the own
    cell's upper triangle, and no pair of two atoms of neigh_modify
    exclude group's group (excl, (N,) bool).  Its host reads (the
    nonzero pairs, the rows' counts) come once a grid."""
    aos = cells.atom_of_slot
    nbins = tuple(aos.shape[:3])
    cap = aos.shape[-1]
    ncell = nbins[0] * nbins[1] * nbins[2]
    aos = aos.reshape(ncell, cap).long()
    valid = aos < n
    fwd = _cell_index(nbins, aos.device)
    ok = valid[None, :, :, None] & valid[fwd][:, :, None, :]
    ar = torch.arange(cap, device=aos.device)
    ok[0] &= ar[:, None] < ar[None, :]
    if excl is not None:
        ex = valid & excl[torch.clamp(aos, max=n - 1)]
        ok &= ~(ex[None, :, :, None] & ex[fwd][:, :, None, :])
    flat = ok.reshape(-1).nonzero().squeeze(1)
    sj = flat % cap
    t = flat // cap
    si = t % cap
    t = t // cap
    c = t % ncell
    g = t // ncell
    cj = fwd[g, c]
    # the centre side's rows (offset, cell, centre slot) are runs of flat;
    # the partner side's (offset, its own cell, partner slot) in a stable
    # order keep the centre slots ascending
    dest_i, rows_i = _sum_rows(flat // cap, torch.arange(
        flat.shape[0], device=flat.device), cap)
    key_j = (g * ncell + cj) * cap + sj
    dest_j, rows_j = _sum_rows(key_j, torch.sort(key_j, stable=True)[1],
                               cap)
    return CandidatePairs(flat=flat, ai=aos[c, si], aj=aos[cj, sj],
                          dest_i=dest_i, rows_i=rows_i, dest_j=dest_j,
                          rows_j=rows_j)


def migrate_shear(shear, old_cells: Cells, new_cells: Cells):
    """Keep shear for candidate pairs whose (cell, slot) endpoints still
    hold the same atoms after the rebuild; zero the rest."""
    same = (new_cells.atom_of_slot == old_cells.atom_of_slot)
    nbins = same.shape[:3]
    cap = same.shape[-1]
    same = same.reshape(-1, cap)
    fwd = _cell_index(nbins, same.device)
    keep = same[None, :, :, None] & same[fwd][:, :, None, :]
    return torch.where(keep.reshape(shear.shape[:-1])[..., None], shear, 0.0)


def gran_cell_forces(x, v, omega, mask, cells: Cells, box: Box,
                     p: GranParams, shear, pairs: CandidatePairs,
                     shear_update: bool = True, need_ev: bool = False):
    """Contact forces and torques over the cell grid (Newton half stencil,
    both atoms of a pair tallied, as the reference's newton/j < nlocal
    arm).  shear: (noff, bx, by, bz, cap, cap, 3), the persistent
    tangential history, zero off the candidate pairs (as every history
    the runner keeps is: migrate_shear keeps a pair's only where both
    its atoms stay); the new history is written into it in place
    (gran/hooke passes it through unchanged).  pairs: the grid's
    candidate_pairs.
    Returns (f (N,3), torque (N,3), shear, virial6); the virial is zero
    unless need_ev.

    The arithmetic runs on the live candidate pairs alone; each atom's
    sums are the JAX package's dense row sums (the centre atom's over its
    partners, +f; the partner's over its centres, -f, on its own cell),
    accumulated offset by offset.
    """
    dtype = x.dtype
    dev = x.device
    aos = cells.atom_of_slot
    nbins = tuple(aos.shape[:3])
    cap = aos.shape[-1]
    ncell = nbins[0] * nbins[1] * nbins[2]
    noff = len(gran_offsets(nbins))
    ai, aj = pairs.ai, pairs.aj
    L = box.img_lengths

    dx = minimum_image(x[ai, 0] - x[aj, 0], L[0])
    dy = minimum_image(x[ai, 1] - x[aj, 1], L[1])
    dz = minimum_image(x[ai, 2] - x[aj, 2], L[2])
    rsq = dx * dx + dy * dy + dz * dz
    radi, radj = p.radius[ai], p.radius[aj]
    radsum = radi + radj
    touch = rsq < radsum * radsum
    rsq = torch.where(touch, rsq, 1.0)
    r = torch.sqrt(rsq)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq

    vr = v[ai] - v[aj]
    vr1, vr2, vr3 = vr[:, 0], vr[:, 1], vr[:, 2]
    vnnr = vr1 * dx + vr2 * dy + vr3 * dz
    vt1 = vr1 - dx * vnnr * rsqinv
    vt2 = vr2 - dy * vnnr * rsqinv
    vt3 = vr3 - dz * vnnr * rsqinv
    wi, wj = omega[ai], omega[aj]
    wr1 = (radi * wi[:, 0] + radj * wj[:, 0]) * rinv
    wr2 = (radi * wi[:, 1] + radj * wj[:, 1]) * rinv
    wr3 = (radi * wi[:, 2] + radj * wj[:, 2]) * rinv

    mi, mj = p.rmass[ai], p.rmass[aj]
    meff = mi * mj / (mi + mj)
    # a frozen atom's partner takes its own mass (the reference's
    # FixFreeze test in compute)
    meff = torch.where(p.frozen[ai], mj, meff)
    meff = torch.where(p.frozen[aj], mi, meff)

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
        # pair_gran_hooke.cpp: the tangential damping force, capped at the
        # Coulomb limit; no history
        vrel = torch.sqrt(vtr1 * vtr1 + vtr2 * vtr2 + vtr3 * vtr3)
        fsd = meff * p.gammat * vrel
        ft = torch.where(vrel != 0.0, torch.minimum(fn, fsd)
                         / torch.where(vrel > 0, vrel, 1.0), 0.0)
        fs1 = torch.where(touch, -ft * vtr1, 0.0)
        fs2 = torch.where(touch, -ft * vtr2, 0.0)
        fs3 = torch.where(touch, -ft * vtr3, 0.0)
    else:
        sh = shear.reshape(-1, 3)[pairs.flat]
        s1, s2, s3 = sh[:, 0], sh[:, 1], sh[:, 2]
        if shear_update:
            s1 = s1 + vtr1 * p.dt
            s2 = s2 + vtr2 * p.dt
            s3 = s3 + vtr3 * p.dt
        shrmag = torch.sqrt(s1 * s1 + s2 * s2 + s3 * s3)
        # the shear displacement rotated into the tangent plane
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
        scale = torch.where(over & nz, fn / torch.where(fs > 0, fs, 1.0),
                            1.0)
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
        # a candidate out of contact keeps no shear (reference :168-175);
        # every other slot pair holds zero
        shear.reshape(-1, 3)[pairs.flat] = torch.where(
            touch[:, None], torch.stack([s1, s2, s3], dim=1), 0.0)

    fxp = dx * ccel + fs1
    fyp = dy * ccel + fs2
    fzp = dz * ccel + fs3
    tor1 = rinv * (dy * fs3 - dz * fs2)
    tor2 = rinv * (dz * fs1 - dx * fs3)
    tor3 = rinv * (dx * fs2 - dy * fs1)
    # the centre side: +f, -radi tor, summed over the partner slots; the
    # partner side: -f, -radj tor, summed over the centre slots onto the
    # partner's own cell; then offset by offset
    zero = x.new_zeros((1, 6))
    side = []
    for vals, dest, rows in (
            ((fxp, fyp, fzp, -(radi * tor1), -(radi * tor2),
              -(radi * tor3)), pairs.dest_i, pairs.rows_i),
            ((fxp, fyp, fzp, radj * tor1, radj * tor2, radj * tor3),
             pairs.dest_j, pairs.rows_j)):
        vals = torch.cat([torch.stack(vals, dim=1), zero])
        out = x.new_zeros((noff * ncell * cap, 6))
        out[dest] = vals[rows].sum(1)
        side.append(out.reshape(noff, ncell * cap, 6))
    acc = x.new_zeros((ncell * cap, 6))
    for g in range(noff):
        acc = acc + side[0][g] - side[1][g]
    if need_ev:
        vir = torch.stack([
            torch.sum(fxp * dx), torch.sum(fyp * dy), torch.sum(fzp * dz),
            torch.sum(fyp * dx), torch.sum(fzp * dx), torch.sum(fzp * dy)])
    else:
        vir = torch.zeros(6, dtype=dtype, device=dev)

    # slot space -> atom space; masked atoms name the slot past the grid
    soa = torch.clamp(cells.slot_of_atom, max=ncell * cap - 1).long()
    out = torch.where(mask[:, None], acc[soa], 0.0)
    return out[:, :3], out[:, 3:], shear, vir


def erotate_sphere(omega, radius, rmass, mask, mvv2e=1.0):
    """compute erotate/sphere: 0.5 INERTIA mvv2e sum m r^2 |w|^2 over the
    masked atoms of finite radius, a 0-d tensor."""
    w2 = torch.sum(omega * omega, dim=1)
    e = torch.where(mask & (radius > 0.0), rmass * radius * radius * w2, 0.0)
    return 0.5 * INERTIA * mvv2e * torch.sum(e)


def wall_contact_force(d, v, omega, radius, meff, shear, vwall, active,
                       kn, kt, gamman, gammat, xmu, dt, kind,
                       rwall=None, shear_update=True):
    """One wall-contact source over the atoms: the sphere/wall contacts of
    fix_wall_gran.cpp (hooke :459-535, hooke/history :539-654,
    hertz/history :658-780).  d (N,3): the vector from the wall's contact
    point to the atom; active (N,): the group and range gate; rwall (N,):
    hertz/history's curved-wall term (None for a plane, +-2 R for a
    zcylinder, the region's contact radius for wall/gran/region).
    Returns (f (N,3), torque (N,3), shear' (N,3)); the fix tallies no
    virial (no v_tally in its post_force)."""
    rsq = torch.sum(d * d, dim=1)
    touch = active & (rsq <= radius * radius) & (rsq > 0.0)
    rsq_s = torch.where(touch, rsq, 1.0)
    r = torch.sqrt(rsq_s)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq_s

    vr = v - vwall
    vnnr = torch.sum(vr * d, dim=1)
    vt = vr - d * (vnnr * rsqinv)[:, None]
    wr = radius[:, None] * omega * rinv[:, None]

    damp = meff * gamman * vnnr * rsqinv
    ccel = torch.where(touch, kn * (radius - r) * rinv - damp, 0.0)
    if kind == "hertz/history":
        if rwall is None:
            red = radius
        else:
            rs = rwall + radius
            red = torch.where(rwall == 0.0, radius,
                              radius * rwall / torch.where(rs != 0.0, rs, 1.0))
        polyhertz = torch.sqrt(torch.clamp((radius - r) * red, min=0.0))
        polyhertz = torch.where(touch, polyhertz, 0.0)
        ccel = ccel * polyhertz
    else:
        polyhertz = 1.0

    # vtr = vt - d x wr (the component form of :499-501)
    vtr1 = vt[:, 0] - (d[:, 2] * wr[:, 1] - d[:, 1] * wr[:, 2])
    vtr2 = vt[:, 1] - (d[:, 0] * wr[:, 2] - d[:, 2] * wr[:, 0])
    vtr3 = vt[:, 2] - (d[:, 1] * wr[:, 0] - d[:, 0] * wr[:, 1])
    fn = xmu * torch.abs(ccel * r)

    if kind == "hooke":
        vrel = torch.sqrt(vtr1 * vtr1 + vtr2 * vtr2 + vtr3 * vtr3)
        fsd = meff * gammat * vrel
        ft = torch.where(vrel != 0.0, torch.minimum(fn, fsd)
                         / torch.where(vrel > 0.0, vrel, 1.0), 0.0)
        fs1 = torch.where(touch, -ft * vtr1, 0.0)
        fs2 = torch.where(touch, -ft * vtr2, 0.0)
        fs3 = torch.where(touch, -ft * vtr3, 0.0)
        shear_out = shear
    else:
        s1, s2, s3 = shear[:, 0], shear[:, 1], shear[:, 2]
        if shear_update:
            s1 = s1 + vtr1 * dt
            s2 = s2 + vtr2 * dt
            s3 = s3 + vtr3 * dt
        shrmag = torch.sqrt(s1 * s1 + s2 * s2 + s3 * s3)
        if shear_update:
            rsht = (s1 * d[:, 0] + s2 * d[:, 1] + s3 * d[:, 2]) * rsqinv
            s1 = s1 - rsht * d[:, 0]
            s2 = s2 - rsht * d[:, 1]
            s3 = s3 - rsht * d[:, 2]
        fs1 = -polyhertz * (kt * s1 + meff * gammat * vtr1)
        fs2 = -polyhertz * (kt * s2 + meff * gammat * vtr2)
        fs3 = -polyhertz * (kt * s3 + meff * gammat * vtr3)
        fs = torch.sqrt(fs1 * fs1 + fs2 * fs2 + fs3 * fs3)
        over = touch & (fs > fn)
        nz = shrmag != 0.0
        scale = torch.where(over & nz,
                            fn / torch.where(fs > 0.0, fs, 1.0), 1.0)
        if shear_update:
            gt_kt = meff * gammat / (kt if kt != 0.0 else 1.0)
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
        # an atom out of contact loses its wall history (:353-356)
        shear_out = torch.stack([torch.where(touch, s1, 0.0),
                                 torch.where(touch, s2, 0.0),
                                 torch.where(touch, s3, 0.0)], dim=-1)

    fsv = torch.stack([fs1, fs2, fs3], dim=-1)
    f_add = d * ccel[:, None] + fsv
    # torque -= radius * rinv * (d x fs)  (:529-534)
    tor = torch.linalg.cross(d, fsv) * rinv[:, None]
    return f_add, -radius[:, None] * tor, shear_out
