"""Cell grid and the roll-based cell-pair forces (lidp_tpu/ops/cells.py).

Atoms are bucketed into a dense (nbx, nby, nbz, cap) slot grid once per
rebuild (`build_cells`: one stable sort and two scatters); each step the
per-slot coordinates are gathered once and the neighbour-cell interactions
are formed by rolling the whole grid, periodic wrap included, as
(cells, cap, cap) blocks.  Newton's third law is used as in a half
neighbour list: 13 of the 27 stencil offsets plus the upper triangle of the
own cell, +f on the centre atom and -f rolled back onto the neighbour;
energies and the virial carry full weight.

`cell_pair_forces` is the plain PyTorch route of the cell engine: float64,
several atom types and coulomb systems take it on the GPU too, exactly as
the JAX package sends them to its XLA function.  The single-type float32
LJ case goes to the CUDA kernels of ops/cell_kernels.py instead
(forcefield.compute_forces decides; a type exclusion table or the molecule
exclusion keeps a system on this function, as the JAX package's
_pallas_ok does).  Only lj/cut and lj/cut/coul/long are ported, with the
neigh_modify exclusions (type pairs, PairParams.excl; same-molecule pairs,
excl_mol with mol=): the port's PairParams cannot express the charmm
switches or the other pair and coulomb kinds, and a triclinic box does not
exist in the port.

Requires >= 3 bins in every dimension that has more than one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.box import Box, minimum_image
from lidp_tpu_torch.ops.pair import EWALD_F, erfc_as


def perp_widths(lengths, tilt=None):
    """Perpendicular distance between opposite cell faces per dimension:
    the edge lengths of an orthogonal box."""
    if tilt is not None and np.any(np.asarray(tilt, float) != 0.0):
        raise NotImplementedError(
            "triclinic boxes are not ported (ROADMAP queue 1 item 6, "
            "breadth)")
    return np.asarray(lengths, float)


@dataclasses.dataclass(frozen=True)
class CellConfig:
    nbins: tuple[int, int, int]
    cap: int
    cutneigh: float

    @staticmethod
    def for_box(box_lengths, cutneigh: float, density: float,
                cap_slack: float = 2.0, perp=None) -> "CellConfig":
        """Bin counts from the box edges (or `perp` widths) over the
        neighbour cutoff; the slot capacity from the mean occupancy times
        `cap_slack`, rounded up to a multiple of 8."""
        L = np.asarray(box_lengths, float)
        W = L if perp is None else np.asarray(perp, float)
        nb = []
        for w in W:
            n = int(max(1, np.floor(w / cutneigh)))
            # a dim thinner than ~3 cutoffs collapses to a single bin (all
            # pairs in-cell, minimum image handles the wrap); 2 bins would
            # alias the +1/-1 rolls onto the same neighbor
            nb.append(n if n >= 3 else 1)
        nb = tuple(nb)
        if max(nb) < 3:
            raise ValueError("cell kernel needs >= 3 bins in some dim")
        vol_bin = float(np.prod(L)) / float(np.prod(nb))
        cap = int(np.ceil(density * vol_bin * cap_slack / 8.0) * 8)
        return CellConfig(nbins=nb, cap=max(cap, 8), cutneigh=float(cutneigh))


@dataclasses.dataclass(frozen=True)
class Cells:
    atom_of_slot: torch.Tensor   # (nbx,nby,nbz,cap) int32, == n for empty
    slot_of_atom: torch.Tensor   # (N,) int32 linear slot index
    overflow: torch.Tensor       # () bool


def build_cells(x, mask, box: Box, cfg: CellConfig) -> Cells:
    """Bucket the unmasked atoms into the slot grid.  Slot ranks inside a
    cell follow atom order (the sort is stable).  `overflow` is set when a
    cell holds more than `cap` atoms (the extra atoms share its last slot)
    or a bin is thinner than the neighbour cutoff."""
    n = x.shape[0]
    nbx, nby, nbz = cfg.nbins
    nbins = nbx * nby * nbz
    dev = x.device
    dims = torch.tensor(cfg.nbins, dtype=torch.int32, device=dev)
    L = box.lengths

    frac = (x - box.lo) / L
    # wrap only periodic dims; non-periodic strays clamp to edge bins below
    if all(box.periodic):
        frac = frac - torch.floor(frac)
    else:
        pm = torch.tensor(box.periodic, device=dev)
        frac = torch.where(pm, frac - torch.floor(frac), frac)
    b3 = torch.minimum(torch.clamp((frac * dims).to(torch.int32), min=0),
                       dims - 1)
    bin_id = (b3[:, 0] * nby + b3[:, 1]) * nbz + b3[:, 2]
    bin_id = torch.where(mask, bin_id, nbins)

    binsize_bad = torch.zeros((), dtype=torch.bool, device=dev)
    for d in range(3):
        if cfg.nbins[d] > 1:
            binsize_bad = binsize_bad | ((L[d] / cfg.nbins[d]) < cfg.cutneigh)

    sb, order = torch.sort(bin_id, stable=True)
    pos = torch.arange(n, device=dev)
    first = torch.searchsorted(sb, sb, right=False)
    rank = pos - first
    overflow = torch.any((rank >= cfg.cap) & (sb < nbins)) | binsize_bad
    rank_c = torch.clamp(rank, max=cfg.cap - 1)

    slot_sorted = torch.where(sb < nbins, sb.long() * cfg.cap + rank_c,
                              nbins * cfg.cap)
    slot_of_atom = torch.zeros((n,), dtype=torch.int32, device=dev)
    slot_of_atom[order] = slot_sorted.to(torch.int32)
    # one slot past the grid takes the masked atoms and is cut off again
    atom_of_slot = torch.full((nbins * cfg.cap + 1,), n, dtype=torch.int32,
                              device=dev)
    atom_of_slot[slot_sorted] = order.to(torch.int32)
    atom_of_slot = atom_of_slot[:-1].reshape(nbx, nby, nbz, cfg.cap)
    return Cells(atom_of_slot=atom_of_slot, slot_of_atom=slot_of_atom,
                 overflow=overflow)


_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]
# Newton half stencil: the 13 lexicographically-positive offsets; the self
# cell (0,0,0) is handled with an upper-triangular slot mask.
_HALF_OFFSETS = [o for o in _OFFSETS if o > (0, 0, 0)]


def half_offsets(nbins) -> list:
    """Newton half stencil restricted to dims with more than one bin.

    Dims collapsed to a single bin (thin 2d slabs) contribute no roll:
    their pairs are all in-cell and minimum image covers the wrap."""
    ranges = [(-1, 0, 1) if nb > 1 else (0,) for nb in nbins]
    offs = [(i, j, k) for i in ranges[0] for j in ranges[1]
            for k in ranges[2]]
    return [o for o in offs if o > (0, 0, 0)]


def _roll(a, off, sign=-1):
    """Roll the three leading (cell) axes by sign*off."""
    shifts = [(sign * sh, ax) for ax, sh in enumerate(off) if sh]
    if not shifts:
        return a
    return torch.roll(a, [s for s, _ in shifts], [ax for _, ax in shifts])


def cell_pair_forces(x, q, type_, mask, cells: Cells, box: Box, p,
                     coul: bool | None = None, need_ev: bool = True,
                     mol=None):
    """LJ (+ real-space Ewald coulomb) forces via the rolled cell grid.

    `p` is a PairParams; with more than one atom type, or a type exclusion
    table, the tables are indexed per slot pair.  With p.excl_mol and the
    molecule ids `mol`, pairs of one molecule take no term.  need_ev=False
    skips the energy and virial sums and returns zeros for them.  Returns
    (f (N,3), evdwl, ecoul, virial6) in atom order; masked atoms get zero
    force."""
    n = x.shape[0]
    dtype = x.dtype
    if coul is None:
        coul = p.coul
    aos = cells.atom_of_slot                        # (bx,by,bz,cap)
    L = box.img_lengths
    cap = aos.shape[-1]

    amax = torch.clamp(aos, max=n - 1).long()
    valid = aos < n

    def slotify(a, pad=0):
        return torch.where(valid, a[amax], pad)

    xs = [slotify(x[:, d]) for d in range(3)]
    qs = slotify(q) if coul else None
    ntypes = p.lj3.shape[0] - 1
    multi_type = ntypes > 1 or p.excl is not None
    if multi_type:
        ts = slotify(type_).long()
        tabs = [t.to(dtype) for t in (p.lj3, p.lj4, p.offset, p.cut_ljsq,
                                      p.cutsq)]
    else:
        lj3, lj4, off11 = (t[1, 1].to(dtype)
                           for t in (p.lj3, p.lj4, p.offset))
        cut_ljsq, cutsq = p.cut_ljsq[1, 1].to(dtype), p.cutsq[1, 1].to(dtype)

    excl_mol = p.excl_mol and mol is not None
    if excl_mol:
        ms = slotify(mol, -1)

    fx = torch.zeros(aos.shape, dtype=dtype, device=x.device)
    fy = torch.zeros_like(fx)
    fz = torch.zeros_like(fx)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    evdwl, ecoul = zero, zero
    vir = [zero] * 6

    # upper triangle (i<j) for the self-cell block
    ar = torch.arange(cap, device=x.device)
    tri = ar[:, None] < ar[None, :]

    for off in [(0, 0, 0)] + half_offsets(aos.shape[:3]):
        def ctr(a):
            return a[..., :, None]

        def nbr(a):
            return _roll(a, off, -1)[..., None, :]

        dx = minimum_image(ctr(xs[0]) - nbr(xs[0]), L[0])
        dy = minimum_image(ctr(xs[1]) - nbr(xs[1]), L[1])
        dz = minimum_image(ctr(xs[2]) - nbr(xs[2]), L[2])
        rsq = dx * dx + dy * dy + dz * dz
        pair_ok = ctr(valid) & nbr(valid)
        if off == (0, 0, 0):
            pair_ok = pair_ok & tri
        if excl_mol:
            pair_ok = pair_ok & (ctr(ms) != nbr(ms))
        rsq = torch.where(pair_ok, rsq, 1.0e12)
        r2inv = 1.0 / rsq

        if multi_type:
            ti, tj = ctr(ts), nbr(ts)
            lj3, lj4, off11, cut_ljsq, cutsq = (t[ti, tj] for t in tabs)

        in_rng = rsq < cutsq
        if p.excl is not None:
            in_rng = in_rng & ~p.excl[ti, tj]
        lj_m = in_rng & (rsq < cut_ljsq)
        r6inv = r2inv * r2inv * r2inv
        forcelj = torch.where(
            lj_m, r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4), 0.0)
        if need_ev:
            philj = r6inv * (lj3 * r6inv - lj4)
            evdwl = evdwl + torch.sum(torch.where(lj_m, philj - off11, 0.0))

        if coul:
            qi, qj = ctr(qs), nbr(qs)
            cm = in_rng & (rsq < p.cut_coulsq)
            r = torch.sqrt(rsq)
            prefactor = p.qqrd2e * qi * qj / r
            if p.g_ewald > 0:
                grij = p.g_ewald * r
                expm2 = torch.exp(-grij * grij)
                erfc = erfc_as(grij, expm2)
                forcecoul = torch.where(
                    cm, prefactor * (erfc + EWALD_F * grij * expm2), 0.0)
            else:                                   # exact coul/cut
                erfc = 1.0
                forcecoul = torch.where(cm, prefactor, 0.0)
            if need_ev:
                ecoul = ecoul + torch.sum(
                    torch.where(cm, prefactor * erfc, 0.0))
        else:
            forcecoul = 0.0

        fpair = (forcelj + forcecoul) * r2inv
        px, py, pz = fpair * dx, fpair * dy, fpair * dz
        # Newton: +f on the center atom, -f rolled back onto the neighbor
        fx += px.sum(-1) - _roll(px.sum(-2), off, +1)
        fy += py.sum(-1) - _roll(py.sum(-2), off, +1)
        fz += pz.sum(-1) - _roll(pz.sum(-2), off, +1)
        if need_ev:
            terms = (px * dx, py * dy, pz * dz, px * dy, px * dz, py * dz)
            vir = [v + torch.sum(t) for v, t in zip(vir, terms)]

    # slot-space -> atom-space (one O(N) gather)
    # masked atoms name the slot past the grid: clamp, then zero them
    soa = torch.clamp(cells.slot_of_atom, max=aos.numel() - 1).long()
    f = torch.stack([fx.reshape(-1)[soa], fy.reshape(-1)[soa],
                     fz.reshape(-1)[soa]], dim=-1)
    f = torch.where(mask[:, None], f, 0.0)
    return f, evdwl, ecoul, torch.stack(vir)
