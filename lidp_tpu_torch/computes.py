"""Per-atom and reduced compute styles (lidp_tpu/computes.py, the
compute_*_atom.cpp / compute_reduce.cpp family), and the global computes
the thermo row reads (lidp_tpu/sim.py's compute wiring): plain torch on
the run's device.

Per-atom quantities are evaluated on demand, at thermo, dump and output
fix sample steps, never inside the step.  The pair passes go over row
blocks of the real atoms against their candidates (`_pair_rows`: the
atoms of each row's cell and the 26 around it, or every atom where the
box has too few cells; the geometry of a block, then the pairs inside the
cutoff gathered), in float64 whatever the run's dtype; each pair is formed
from both of its atoms' rows with the same bits (the minimum image is odd
in d), and an atom's sums are row sums of a dense block, so repeats are
bit-identical and no float index_add_ is involved.  The JAX package
enumerates i < j pairs in dense row blocks and adds each half with
np.add.at; the sums agree to their rounding.

Covered styles: ke/atom (compute_ke_atom.cpp), pe/atom
(compute_pe_atom.cpp: pair + equal-share bond terms; k-space, polarization
and fix shares are not tallied, as in the JAX package), stress/atom
(compute_stress_atom.cpp: kinetic + pairwise, in pressure*volume units),
coord/atom, cluster/atom (the ID minimization of compute_cluster_atom.cpp
to its fixed point, on the device), displace/atom, property/atom, reduce
and reduce/region (compute_reduce.cpp); the structure computes centro/atom,
cna/atom, orientorder/atom, hexorder/atom (on a nearest-first neighbour
table), fragment/atom, aggregate/atom and global/atom; chunk/atom and the
eleven */chunk computes (per-chunk sums as row sums of a dense chunk
table), heat/flux; and the global ones: com, gyration, ke, pe, msd, vacf,
rdf, group/group, temp/ramp, temp/region, temp/profile, ke/rigid and
erotate/rigid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lidp_tpu_torch.box import minimum_image, unwrap
from lidp_tpu_torch.ops.pair import pair_single

# elements of one (B, N) block of the pair passes: B rows of N columns
BLOCK_ELEMENTS = 1 << 23

# the per-atom styles eval_peratom takes
PERATOM_STYLES = ("ke/atom", "pe/atom", "stress/atom", "coord/atom",
                  "cluster/atom", "displace/atom", "property/atom",
                  "centro/atom", "cna/atom", "orientorder/atom",
                  "hexorder/atom", "fragment/atom", "aggregate/atom",
                  "global/atom", "erotate/sphere/atom", "contact/atom")
# the */chunk computes eval_chunk_agg takes (compute_*_chunk.cpp)
CHUNK_AGG_STYLES = ("com/chunk", "vcm/chunk", "gyration/chunk",
                    "angmom/chunk", "torque/chunk", "inertia/chunk",
                    "omega/chunk", "dipole/chunk", "msd/chunk",
                    "property/chunk", "temp/chunk")
# compute_omega_chunk.cpp:27, the determinant below which the inertia
# tensor is diagonalized rather than solved
OMEGA_EPS = 1.0e-6


def _f64(t):
    return t.to(torch.float64)


def _gmask(sim, gmask):
    """A script group mask (numpy, the real atoms) on the run's device."""
    return torch.as_tensor(np.asarray(gmask)[:sim.natoms],
                           device=sim.sys.x.device)


def _current_x(sim):
    """Current raw positions on the host (float64), what Region::match
    sees: the reference wraps atom->x only at reneighbor steps, so region
    tests between rebuilds see the drift (lidp_tpu/computes.py
    _current_x)."""
    return sim.sys.x[:sim.natoms].double().cpu().numpy()


def _cell_candidates(x, box, cut):
    """A function giving each row atom's candidate partners, (b, K) atom
    indices with n for none: the atoms of its cell and the 26 around it on
    a grid of cells no narrower than cut (sorted by cell, stably, so the
    order is the same on every call); None where a periodic dimension
    holds fewer than 3 such cells (a pair would then come twice), or the
    grid would be one cell."""
    n = x.shape[0]
    dev = x.device
    lo = box.lo.double()
    L = box.lengths.double()
    nb = []
    for d in range(3):
        k = int(float(L[d]) // cut)
        if box.periodic[d] and k < 3:
            return None
        nb.append(max(1, k))
    if nb[0] * nb[1] * nb[2] == 1:
        return None
    nbt = torch.tensor(nb, device=dev)
    xd = x.double()
    per = torch.tensor(box.periodic, device=dev)
    xw = torch.where(per, xd - torch.floor((xd - lo) / L) * L, xd)
    b = torch.floor((xw - lo) / (L / nbt)).long()
    b = torch.minimum(torch.clamp(b, min=0), nbt - 1)
    cell = (b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2]
    ncell = nb[0] * nb[1] * nb[2]
    order = torch.sort(cell, stable=True).indices
    counts = torch.bincount(cell, minlength=ncell)
    cap = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - start[cell[order]]
    table = torch.full((ncell + 1, cap), n, dtype=torch.long, device=dev)
    table[cell[order], rank] = order
    off = torch.tensor([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                        for k in (-1, 0, 1)], device=dev)

    def candidates(ri):
        nbr = b[ri][:, None, :] + off[None, :, :]          # (b, 27, 3)
        wrap = torch.remainder(nbr, nbt)
        nbr = torch.where(per, wrap, nbr)
        inside = ((nbr >= 0) & (nbr < nbt)).all(-1)
        c = (nbr[..., 0] * nb[1] + nbr[..., 1]) * nb[2] + nbr[..., 2]
        c = torch.where(inside, c, ncell)
        return table[c].reshape(ri.shape[0], 27 * cap)

    return candidates


def pair64(sim):
    """The force field's pair tables in float64 (cached on the
    Simulation): the pair passes form every pair in float64 from the run's
    positions, float32 runs too (the JAX package forms them in the run's
    dtype)."""
    pair = sim.runner.ff.pair
    cached = getattr(sim, "_pair64", None)
    if pair is None or (cached is not None and cached[0] is pair):
        return pair if pair is None else cached[1]
    p64 = dataclasses.replace(pair, **{
        f.name: getattr(pair, f.name).double()
        for f in dataclasses.fields(pair)
        if isinstance(getattr(pair, f.name), torch.Tensor)
        and getattr(pair, f.name).is_floating_point()})
    sim._pair64 = (pair, p64)
    return p64


class _Block:
    """One row block of a pair pass: rows i0 .. i0 + nrows of the rows
    asked for, width candidate columns each; the pairs inside the cutoff
    at (ii, kk) of the block, partner atoms jj, their rsq and d = x_i -
    x_j, and their special factors fl, fc (None without)."""

    def __init__(self, i0, nrows, width, ii, kk, jj, rsq, d, fl, fc):
        self.i0, self.nrows, self.width = i0, nrows, width
        self.ii, self.kk, self.jj = ii, kk, jj
        self.rsq, self.d, self.fl, self.fc = rsq, d, fl, fc

    def row_sums(self, vals):
        """Per-row sums of the pairs' values: placed by position into a
        dense (nrows, width) block (each position once) and summed along
        the rows, the same order on every call."""
        dense = vals.new_zeros((self.nrows, self.width) + vals.shape[1:])
        dense[self.ii, self.kk] = vals
        return dense.sum(1)


def _pair_rows(sim, extra_cut=None, rows=None, cols=None, specials=True,
               lengths=None, x=None, cutsq=None):
    """Yield _Blocks over row blocks: the pairs (i, j), i in `rows` (an
    index tensor; all real atoms by default) and j among the real atoms
    (`cols`, a bool mask, all by default), j != i, inside the pair's
    force cutoff (or extra_cut, every type; or the (T+1, T+1) table cutsq
    in its place).  With the force cutoff or cutsq and `specials`, the
    special pairs of weight 0 in both factors are left out as the
    reference's neighbor list leaves them, and fl, fc are the
    pairs' special factors.  d = x_i - x_j minimum-imaged over `lengths`
    (the periodic dimensions' by default), x the positions (the run's by
    default), all in float64.  The candidates are each row's cell and its
    neighbours (_cell_candidates) where the box allows, else every
    atom."""
    sys = sim.sys
    n = sim.natoms
    if x is None:
        x = sys.x[:n].double()
    L = (sys.box.img_lengths if lengths is None else lengths).double()
    ty = sys.type[:n]
    ff = sim.runner.ff
    pair = pair64(sim)
    sp_code = ff.sp_code
    spl = spc = None
    if extra_cut is None and specials and sp_code is not None:
        spl, spc = pair.special_lj, pair.special_coul
    if rows is None:
        rows = torch.arange(n, device=x.device)
    if cutsq is None:
        cutsq = pair.cutsq
    cut = extra_cut if extra_cut is not None else float(
        torch.sqrt(cutsq.double().max()))
    cand = None
    if lengths is None or all(sys.box.periodic):
        cand = _cell_candidates(x, sys.box, cut)
    if cand is None:
        allj = torch.arange(n, device=x.device)

        def cand(ri):
            return allj[None, :].expand(ri.shape[0], n)

        width = n
    else:
        width = cand(rows[:1]).shape[1]
    B = max(1, min(rows.shape[0], BLOCK_ELEMENTS // width))
    for i0 in range(0, rows.shape[0], B):
        ri = rows[i0:i0 + B]
        cj = cand(ri)
        valid = cj < n
        cj = torch.clamp(cj, max=n - 1)
        d = minimum_image(x[ri][:, None, :] - x[cj], L)
        rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        if extra_cut is not None:
            sel = rsq < extra_cut * extra_cut
        else:
            sel = rsq < cutsq[ty[ri][:, None], ty[cj]]
        sel &= valid & (cj != ri[:, None])
        if cols is not None:
            sel &= cols[cj]
        code = None
        if spl is not None:
            code = sp_code[ri[:, None], cj].long()
            sel &= ~((spl[code] == 0.0) & (spc[code] == 0.0))
        ii, kk = sel.nonzero(as_tuple=True)
        fl = fc = None
        if code is not None:
            c = code[ii, kk]
            fl, fc = spl[c], spc[c]
        yield _Block(i0, ri.shape[0], cj.shape[1], ii, kk, cj[ii, kk],
                     rsq[ii, kk], d[ii, kk], fl, fc)


def pair_pass(sim, want_stress=False):
    """(pe (N,), stress (N,6) or None) of the pair term, float64: each
    pair's energy and virial w d d halved between its atoms
    (peratom_pair_pe_stress), plus the equal-share bond energies.  Cached
    per state (Simulation.peratom_cache); the stress pass gives the pe
    too."""
    cache = sim.peratom_cache()
    key = ("pair", True) if ("pair", True) in cache or want_stress \
        else ("pair", False)
    if key in cache:
        return cache[key]
    n = sim.natoms
    sys = sim.sys
    dev = sys.x.device
    pe = torch.zeros(n, dtype=torch.float64, device=dev)
    st = torch.zeros((n, 6), dtype=torch.float64, device=dev) \
        if want_stress else None
    pair = pair64(sim)
    if pair is not None:
        q = sys.q[:n].double()
        ty = sys.type[:n]
        for blk in _pair_rows(sim):
            i0, i1 = blk.i0, blk.i0 + blk.nrows
            gi, jj = blk.ii + i0, blk.jj
            kw = ({} if blk.fl is None
                  else dict(factor_coul=blk.fc, factor_lj=blk.fl))
            eng, fpair = pair_single(blk.rsq, ty[gi], ty[jj], q[gi], q[jj],
                                     pair, **kw)
            pe[i0:i1] += 0.5 * blk.row_sums(eng)
            if want_stress:
                w = 0.5 * fpair
                d = blk.d
                v6 = torch.stack([w * d[:, 0] * d[:, 0],
                                  w * d[:, 1] * d[:, 1],
                                  w * d[:, 2] * d[:, 2],
                                  w * d[:, 0] * d[:, 1],
                                  w * d[:, 0] * d[:, 2],
                                  w * d[:, 1] * d[:, 2]], dim=1)
                st[i0:i1] += blk.row_sums(v6)
    pe = pe + _bonded_peratom(sim)
    cache[key] = (pe, st)
    return pe, st


def _bonded_peratom(sim):
    """Per-atom halves of the 2-body bond energies (ev_tally splits a
    bond's energy 0.5/0.5 between its atoms), summed on the host in bond
    order as the JAX package's np.add.at does.  Angle, dihedral and
    improper shares are not tallied (lidp_tpu/computes.py
    _bonded_peratom)."""
    n = sim.natoms
    ff = sim.runner.ff
    sys = sim.sys
    pe = np.zeros(n)
    for bp in getattr(ff, "bond", ()) or ():
        i, j = bp.idx[:, 0], bp.idx[:, 1]
        d = minimum_image(sys.x[i] - sys.x[j], sys.box.img_lengths)
        rsq = (d * d).sum(1)
        e_term = _bond_energy_terms(bp, rsq)
        if e_term is not None:
            idx = bp.idx.cpu().numpy()
            e = e_term.double().cpu().numpy()
            np.add.at(pe, idx[:, 0], 0.5 * e)
            np.add.at(pe, idx[:, 1], 0.5 * e)
    return torch.as_tensor(pe, device=sys.x.device)


def _bond_energy_terms(bp, rsq):
    """Per-bond energies of the closed-form styles (None: not tallied;
    lidp_tpu/computes.py _bond_energy_terms)."""
    t = bp.btype.long()
    k = bp.k[t]
    r0 = bp.r0[t]
    r = torch.sqrt(rsq)
    if bp.style == "harmonic":
        return k * (r - r0) ** 2
    if bp.style == "gromos":
        return k * (rsq - r0 * r0) ** 2
    if bp.style == "morse":
        ral = torch.exp(-r0 * (r - bp.eps[t]))
        return k * (1 - ral) ** 2
    if bp.style == "zero":
        return torch.zeros_like(r)
    return None


def coord_atom(sim, cutoff, gmask):
    """compute coord/atom cutoff: the neighbours within cutoff of each
    atom, every type (compute_coord_atom.cpp); 0 outside the group."""
    n = sim.natoms
    out = torch.zeros(n, dtype=torch.float64, device=sim.sys.x.device)
    for blk in _pair_rows(sim, extra_cut=cutoff):
        out[blk.i0:blk.i0 + blk.nrows] += blk.row_sums(
            torch.ones_like(blk.ii, dtype=torch.float64))
    return torch.where(_gmask(sim, gmask), out, 0.0)


def contact_atom(sim, gmask):
    """compute contact/atom: each atom's partners with r < ri + rj
    (compute_contact_atom.cpp), over row blocks of each atom's cell and
    the 26 around it (cells no narrower than twice the largest radius),
    or of every atom where the box has too few such cells; 0 outside the
    group."""
    n = sim.natoms
    sys = sim.sys
    x = sys.x[:n].double()
    rad = _f64(sim.gran_radius[:n])
    L = sys.box.img_lengths.double()
    cand = _cell_candidates(x, sys.box, 2.0 * float(rad.max())) if n else None
    if cand is None:
        allj = torch.arange(n, device=x.device)

        def cand(ri):
            return allj[None, :].expand(ri.shape[0], n)

    rows = torch.arange(n, device=x.device)
    out = torch.zeros(n, dtype=torch.float64, device=x.device)
    width = cand(rows[:1]).shape[1] if n else 1
    B = max(1, min(n, BLOCK_ELEMENTS // width))
    for i0 in range(0, n, B):
        ri = rows[i0:i0 + B]
        cj = cand(ri)
        valid = (cj < n) & (cj != ri[:, None])
        cj = torch.clamp(cj, max=n - 1)
        d = minimum_image(x[ri][:, None, :] - x[cj], L)
        rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        radsum = rad[ri][:, None] + rad[cj]
        out[i0:i0 + B] = (valid & (rsq < radsum * radsum)).sum(1).double()
    return torch.where(_gmask(sim, gmask), out, 0.0)


def erotate_sphere(sim, gmask):
    """compute erotate/sphere of a group, a 0-d tensor (ops/granular.py),
    over the existing atoms (the System's mask)."""
    from lidp_tpu_torch.ops.granular import erotate_sphere as erot

    gm = torch.as_tensor(np.asarray(gmask), device=sim.sys.x.device)
    return erot(sim.istate.omega, sim.gran_radius, sim.gran_rmass,
                gm & sim.sys.mask, mvv2e=sim.thermo_params.mvv2e)


def temp_sphere(sim, gmask):
    """compute temp/sphere (compute_temp_sphere.cpp): (sum m v^2 + sum
    INERTIA m r^2 w^2) mvv2e over dof boltz, dof 6 (3 in 2d) a
    finite-radius atom and dim a point atom, less dim; 0 without dof.  A
    0-d float64 tensor (the JAX package's sim.py:2979-2996)."""
    tp = sim.thermo_params
    n = sim.natoms
    gm = _gmask(sim, gmask)
    v = _f64(sim.sys.v[:n])
    w = _f64(sim.istate.omega[:n])
    r = _f64(sim.gran_radius[:n])
    m = _f64(sim.gran_rmass[:n])
    t = torch.sum(torch.where(gm, m * (v * v).sum(1)
                              + 0.4 * m * r * r * (w * w).sum(1), 0.0)) \
        * tp.mvv2e
    dof = float(torch.where(r[gm] > 0, 6 if tp.dim == 3 else 3,
                            tp.dim).sum()) - tp.dim
    return t / (dof * tp.boltz) if dof > 0 else torch.zeros_like(t)


def cluster_atom(sim, cutoff, gmask):
    """compute cluster/atom cutoff: each atom's cluster label, the
    smallest atom ID of its connected component within cutoff among the
    group (compute_cluster_atom.cpp iterates the ID minimization to
    convergence; the same fixed point, by scatter_reduce amin, an
    order-free minimum); 0 outside the group."""
    n = sim.natoms
    gm = _gmask(sim, gmask)
    pi, pj = [], []
    for blk in _pair_rows(sim, extra_cut=cutoff):
        a, b = blk.ii + blk.i0, blk.jj
        keep = gm[a] & gm[b]
        pi.append(a[keep])
        pj.append(b[keep])
    return _component_labels(n, pi, pj, gm)


def _component_labels(n, pi, pj, gm):
    """Each atom's label, the smallest atom ID of its connected component
    over the directed edges pj -> pi (lists of index tensors; both
    directions of a pair given), 0 outside the group gm: the ID
    minimization by scatter_reduce amin, an order-free minimum, iterated
    to its fixed point."""
    a = torch.cat(pi) if pi else torch.zeros(0, dtype=torch.long,
                                              device=gm.device)
    b = torch.cat(pj) if pj else a
    lab = torch.arange(n, device=gm.device)
    while True:
        new = lab.scatter_reduce(0, a, lab[b], reduce="amin")
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(gm, (lab + 1).double(), 0.0)


def fragment_aggregate_atom(sim, gmask, cutoff=None):
    """compute fragment/atom (bond connectivity) and aggregate/atom (bonds
    and pairs within cutoff): each atom's label, the smallest atom ID of
    its component among the group, 0 outside it
    (compute_fragment_atom.cpp, compute_aggregate_atom.cpp;
    lidp_tpu/computes.py fragment_aggregate_atom).  Bonds of type 0
    (broken) join nothing."""
    n = sim.natoms
    gm = _gmask(sim, gmask)
    dev = gm.device
    pi, pj = [], []
    bonds = sim.script._bonds
    if bonds is not None and len(bonds):
        keep = np.asarray(sim.script._bond_types) != 0
        ab = torch.as_tensor(np.asarray(bonds, np.int64)[keep] - 1,
                             device=dev)
        a, b = ab[:, 0], ab[:, 1]
        both = gm[a] & gm[b]
        pi += [a[both], b[both]]
        pj += [b[both], a[both]]
    if cutoff is not None:
        for blk in _pair_rows(sim, extra_cut=cutoff):
            a, b = blk.ii + blk.i0, blk.jj
            keep = gm[a] & gm[b]
            pi.append(a[keep])
            pj.append(b[keep])
    return _component_labels(n, pi, pj, gm)


# ------------------------ the nearest-first table ------------------------

class NeighborTable:
    """Every atom's neighbours within a cutoff, nearest first: nbr (N, K)
    atom indices (N where none), vec (N, K, 3) the minimum-imaged x_j -
    x_i, rsq (N, K) (inf where none) and count (N,), float64; K the
    largest count.  Ties in r^2 go to the lower index, the order the JAX
    package's stable argsort over its lists gives (lidp_tpu/computes.py
    _neighbor_lists: each atom's list in ascending neighbour index)."""

    def __init__(self, nbr, vec, rsq, count):
        self.nbr, self.vec, self.rsq, self.count = nbr, vec, rsq, count

    @property
    def valid(self):
        return self.nbr < self.nbr.shape[0]


def neighbor_table(sim, cutoff):
    """The NeighborTable of the current state within cutoff (every type,
    r^2 < cutoff^2 as _pair_rows selects), cached per state.  Built per
    row block of _pair_rows from its pairs alone: sorted by neighbour
    index, then stably by r^2, then stably by row, each pair lands at its
    rank in its row."""
    cache = sim.peratom_cache()
    key = ("neighbors", float(cutoff))
    if key in cache:
        return cache[key]
    n = sim.natoms
    dev = sim.sys.x.device
    parts = []
    for blk in _pair_rows(sim, extra_cut=cutoff):
        o = torch.sort(blk.jj, stable=True).indices
        o = o[torch.sort(blk.rsq[o], stable=True).indices]
        o = o[torch.sort(blk.ii[o], stable=True).indices]
        ii = blk.ii[o]
        cnt = torch.bincount(ii, minlength=blk.nrows)
        start = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(ii.shape[0], device=dev) - start[ii]
        parts.append((blk.i0, cnt, ii, rank, blk.jj[o], -blk.d[o],
                      blk.rsq[o]))
    count = torch.cat([p[1] for p in parts]) if parts else \
        torch.zeros(n, dtype=torch.long, device=dev)
    k = int(count.max()) if n else 0
    nbr = torch.full((n, k), n, dtype=torch.long, device=dev)
    vec = torch.zeros((n, k, 3), dtype=torch.float64, device=dev)
    rsq = torch.full((n, k), float("inf"), dtype=torch.float64, device=dev)
    for i0, _, ii, rank, jj, d, r2 in parts:
        nbr[i0 + ii, rank] = jj
        vec[i0 + ii, rank] = d
        rsq[i0 + ii, rank] = r2
    out = NeighborTable(nbr, vec, rsq, count)
    cache[key] = out
    return out


def _force_cutoff(sim):
    """The largest pair cutoff (EAM's under pair_style eam), as the JAX
    package takes it for centro/atom and the order parameters."""
    pair = sim.runner.ff.pair
    if pair is not None:
        return float(np.sqrt(np.max(pair.cutsq.double().cpu().numpy())))
    return float(sim.runner.ff.eam.cut)


def centro_atom(sim, nnn, gmask):
    """compute centro/atom fcc|bcc|N (compute_centro_atom.cpp): over the
    nnn nearest neighbours inside the force cutoff, the sum of the nnn/2
    smallest |r_j + r_k|^2 of the pairs j < k; 0 for an atom with fewer
    than nnn neighbours or outside the group."""
    tab = neighbor_table(sim, _force_cutoff(sim))
    n = sim.natoms
    out = torch.zeros(n, dtype=torch.float64, device=sim.sys.x.device)
    if tab.nbr.shape[1] < nnn:
        return out
    sel = tab.vec[:, :nnn]
    iu = torch.triu_indices(nnn, nnn, 1, device=sel.device)
    R = sel[:, iu[0]] + sel[:, iu[1]]                   # (N, P, 3)
    p2 = R[..., 0] ** 2 + R[..., 1] ** 2 + R[..., 2] ** 2
    p2 = torch.sort(p2, dim=1).values[:, :nnn // 2].sum(1)
    ok = _gmask(sim, gmask) & (tab.count >= nnn)
    return torch.where(ok, p2, 0.0)


# the (ncommon, nbonds, max bonds, min bonds) signatures of cna/atom
_CNA_FCC, _CNA_HCP, _CNA_ICO = (4, 2, 1, 1), (4, 2, 2, 0), (5, 5, 2, 2)
_CNA_BCC4, _CNA_BCC6 = (4, 4, 2, 2), (6, 6, 2, 2)


def cna_atom(sim, cutoff, gmask):
    """compute cna/atom cutoff (compute_cna_atom.cpp): 1 fcc, 2 hcp, 3 bcc,
    4 icosahedral, 5 other, 0 outside the group; classified for the atoms
    with 12 or 14 neighbours inside the cutoff from each neighbour's
    signature (common neighbours, bonds among them, the most and fewest
    bonds of one of them).  Membership tests on the neighbour table, as
    (M, 14, 14, K) comparisons in row blocks, in place of the JAX
    package's sets."""
    tab = neighbor_table(sim, cutoff)
    n = sim.natoms
    dev = sim.sys.x.device
    out = torch.full((n,), 5.0, dtype=torch.float64, device=dev)
    rows = ((tab.count == 12) | (tab.count == 14)).nonzero().squeeze(1)
    k = tab.nbr.shape[1]
    w = min(k, 14)
    pad = torch.cat([tab.nbr, torch.full((1, k), n, dtype=torch.long,
                                         device=dev)])
    B = max(1, BLOCK_ELEMENTS // (w * w * max(k, 1)))
    for r0 in range(0, rows.shape[0], B):
        ri = rows[r0:r0 + B]
        nb = tab.nbr[ri, :w]                                  # (b, w)
        ok = nb < n
        # adj[a, b]: neighbour b of i is in the list of neighbour a
        adj = (pad[nb][:, :, None, :] == nb[:, None, :, None]).any(-1)
        adj &= ok[:, :, None] & ok[:, None, :]
        nc = adj.sum(2)
        # bonds[a, b]: for b common to i and a, the other common
        # neighbours of (i, a) bonded to b
        bonds = (adj[:, :, None, :] & adj[:, None, :, :]).sum(3)
        bonds = torch.where(adj, bonds, 0)
        nbonds = bonds.sum(2) // 2
        big = torch.iinfo(torch.long).max
        bmax = torch.where(adj, bonds, -1).max(2).values.clamp(min=0)
        bmin = torch.where(adj, bonds, big).min(2).values
        bmin = torch.where(nc > 0, bmin, 0)

        def count(sig):
            hit = ((nc == sig[0]) & (nbonds == sig[1]) & (bmax == sig[2])
                   & (bmin == sig[3]) & ok)
            return hit.sum(1)

        c12 = tab.count[ri] == 12
        nfcc, nhcp, nico = count(_CNA_FCC), count(_CNA_HCP), count(_CNA_ICO)
        code12 = torch.where(
            nfcc == 12, 1.0, torch.where(
                (nfcc == 6) & (nhcp == 6), 2.0,
                torch.where(nico == 12, 4.0, 5.0)))
        code14 = torch.where((count(_CNA_BCC4) == 6)
                             & (count(_CNA_BCC6) == 8), 3.0, 5.0)
        out[ri] = torch.where(c12, code12, code14).double()
    return torch.where(_gmask(sim, gmask), out, 0.0)


def _assoc_legendre(l, m, x):
    """The associated Legendre P_l^m(x) by the reference's upward
    recurrence (compute_orientorder_atom.cpp:524-544; lidp_tpu/computes.py
    _assoc_legendre)."""
    if l < m:
        return torch.zeros_like(x)
    p = torch.ones_like(x)
    if m != 0:
        sqx = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
        for i in range(1, m + 1):
            p = p * ((2 * i - 1) * sqx)
    pm1 = torch.zeros_like(x)
    for i in range(m + 1, l + 1):
        pm2 = pm1
        pm1 = p
        p = ((2 * i - 1) * x * pm1 - (i + m - 1) * pm2) / (i - m)
    return p


def _polar_prefactor(l, m, costheta):
    """compute_orientorder_atom.cpp:504-521 (lidp_tpu/computes.py
    _polar_prefactor)."""
    mabs = abs(m)
    pref = 1.0
    for i in range(l - mabs + 1, l + mabs + 1):
        pref *= float(i)
    pref = math.sqrt((2 * l + 1) / (4.0 * math.pi * pref))
    out = pref * _assoc_legendre(l, mabs, costheta)
    if m < 0 and m % 2:
        out = -out
    return out


def _order_neighbors(sim, spec, nnn_default):
    """The order parameters' neighbours: the table within `cutoff` (the
    force cutoff by default), the first nnn of each atom (every one for
    nnn 0), and which atoms qualify (at least max(nnn, 1) neighbours, in
    the group)."""
    nnn = spec.get("nnn", nnn_default)
    cutoff = spec.get("cutoff") or _force_cutoff(sim)
    tab = neighbor_table(sim, cutoff)
    k = tab.nbr.shape[1]
    width = min(nnn, k) if nnn > 0 else k
    vec = tab.vec[:, :width]
    use = tab.valid[:, :width]
    ok = tab.count >= max(nnn, 1)
    return nnn, vec, use, ok


def orientorder_atom(sim, spec, gmask):
    """compute orientorder/atom [nnn N] [degrees nq l...] [components l]
    [cutoff c] (compute_orientorder_atom.cpp): the Steinhardt Q_l over the
    nnn nearest neighbours inside the cutoff, one column per degree
    (default 4 6 8 10 12), then the 2(2l+1) normalized real and imaginary
    qlm of `components l`; the qlm as complex sums over the table's
    rows."""
    n = sim.natoms
    dev = sim.sys.x.device
    qlist = spec.get("degrees", [4, 6, 8, 10, 12])
    comp_l = spec.get("components")
    nnn, vv, use, ok = _order_neighbors(sim, spec, 12)
    ok = ok & _gmask(sim, gmask)
    ncol = len(qlist) + (2 * (2 * comp_l + 1) if comp_l else 0)
    out = torch.zeros((n, ncol), dtype=torch.float64, device=dev)
    if not bool(ok.any()):
        return out
    rmag = torch.sqrt(vv[..., 0] ** 2 + vv[..., 1] ** 2 + vv[..., 2] ** 2)
    rmag = torch.where(use, rmag, 1.0)
    cth = vv[..., 2] / rmag
    rxy = torch.sqrt(vv[..., 0] ** 2 + vv[..., 1] ** 2)
    safe = rxy > 1e-300
    rs = torch.where(safe, rxy, 1.0)
    ephi = torch.complex(torch.where(safe, vv[..., 0] / rs, 1.0),
                         torch.where(safe, vv[..., 1] / rs, 0.0))
    wgt = use.double()
    nc = (torch.full_like(wgt[:, 0], float(nnn)) if nnn > 0
          else wgt.sum(1))
    fac = math.sqrt(4.0 * math.pi) / torch.clamp(nc, min=1.0)
    for col, lq in enumerate(qlist):
        qlm = torch.zeros((n, 2 * lq + 1), dtype=torch.complex128,
                          device=dev)
        qlm[:, lq] = (_polar_prefactor(lq, 0, cth) * wgt).sum(1)
        ephim = ephi
        for m in range(1, lq + 1):
            cc = (_polar_prefactor(lq, m, cth) * wgt * ephim).sum(1)
            qlm[:, m + lq] += cc
            # the (-1)^m conjugate relation (calc_boop:447-455)
            qlm[:, lq - m] += (-cc.conj() if m & 1 else cc.conj())
            ephim = ephim * ephi
        qm_sum = (qlm.real ** 2 + qlm.imag ** 2).sum(1)
        out[:, col] = fac * torch.sqrt(qm_sum / (2 * lq + 1))
        if comp_l == lq:
            normfac = torch.where(
                qm_sum > 0, 1.0 / torch.sqrt(torch.where(qm_sum > 0, qm_sum,
                                                         1.0)), 0.0)
            out[:, len(qlist)::2] = qlm.real * normfac[:, None]
            out[:, len(qlist) + 1::2] = qlm.imag * normfac[:, None]
    return torch.where(ok[:, None], out, 0.0)


def hexorder_atom(sim, spec, gmask):
    """compute hexorder/atom [degree n] [nnn N] [cutoff c]
    (compute_hexorder_atom.cpp): the 2-d q_n = (1/nnn) sum_j exp(i n
    theta_ij) over the nnn nearest neighbours; columns Re, Im."""
    deg = spec.get("degree", 6)
    nnn, vv, use, ok = _order_neighbors(sim, spec, 6)
    ok = ok & _gmask(sim, gmask)
    rxy = torch.sqrt(vv[..., 0] ** 2 + vv[..., 1] ** 2)
    rinv = 1.0 / torch.where(use, rxy, 1.0)
    z = torch.complex(vv[..., 0] * rinv, vv[..., 1] * rinv)
    zn = torch.ones_like(z)
    for _ in range(deg):
        zn = zn * z
    zn = torch.where(use, zn, 0.0)
    denom = (torch.full_like(rxy[:, 0], float(nnn)) if nnn > 0
             else use.double().sum(1))
    denom = torch.clamp(denom, min=1.0)
    out = torch.stack([zn.real.sum(1) / denom, zn.imag.sum(1) / denom], 1)
    return torch.where(ok[:, None], out, 0.0)


def _xu(sim):
    """Unwrapped positions of the real atoms (Domain::unmap)."""
    sys = sim.sys
    n = sim.natoms
    return unwrap(sys.x[:n], sys.box, sys.image[:n])


def eval_peratom(sim, cid):
    """A registered per-atom compute: (N,) or (N,K), float64 on the run's
    device, cached per state."""
    cache = sim.peratom_cache()
    if cid in cache:
        return cache[cid]
    if cid not in sim.peratom_computes and cid in sim.chunk_computes:
        # a chunk/atom compute's per-atom output is its chunk id
        # (compute_chunk_atom.cpp; lidp_tpu/computes.py:514-518)
        out = chunk_ids(sim, cid)[0].double()
        cache[cid] = out
        return out
    gmask, style, spec = sim.peratom_computes[cid]
    n = sim.natoms
    sys = sim.sys
    tp = sim.thermo_params
    gm = _gmask(sim, gmask)
    m = _f64(tp.mass_atom[:n])
    v = _f64(sys.v[:n])
    if style == "ke/atom":
        out = 0.5 * tp.mvv2e * m * (v * v).sum(1)
        out = torch.where(gm, out, 0.0)
    elif style == "pe/atom":
        out = torch.where(gm, pair_pass(sim)[0], 0.0)
    elif style == "stress/atom":
        # compute_stress_atom.cpp: -(m v v + pair virial share) * nktv2p
        st = pair_pass(sim, want_stress=True)[1]
        kin = torch.stack([m * v[:, 0] * v[:, 0], m * v[:, 1] * v[:, 1],
                           m * v[:, 2] * v[:, 2], m * v[:, 0] * v[:, 1],
                           m * v[:, 0] * v[:, 2], m * v[:, 1] * v[:, 2]],
                          dim=1) * tp.mvv2e
        out = -(kin + st) * float(tp.nktv2p)
        out = torch.where(gm[:, None], out, 0.0)
    elif style == "coord/atom":
        out = coord_atom(sim, float(spec["cutoff"]), gmask)
    elif style == "cluster/atom":
        out = cluster_atom(sim, float(spec["cutoff"]), gmask)
    elif style == "displace/atom":
        d = _f64(_xu(sim)) - spec["x0"]
        d = torch.where(gm[:, None], d, 0.0)
        out = torch.cat([d, torch.sqrt((d * d).sum(1))[:, None]], dim=1)
    elif style == "property/atom":
        src = _atom_fields(sim)
        cols = [torch.where(gm, src[w], 0.0) for w in spec["fields"]]
        out = cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)
    elif style == "centro/atom":
        nnn = {"fcc": 12, "bcc": 8}.get(spec["arg"])
        out = centro_atom(sim, nnn if nnn else int(spec["arg"]), gmask)
    elif style == "cna/atom":
        out = cna_atom(sim, float(spec["arg"]), gmask)
    elif style == "orientorder/atom":
        out = orientorder_atom(sim, spec["arg"], gmask)
    elif style == "hexorder/atom":
        out = hexorder_atom(sim, spec["arg"], gmask)
    elif style == "fragment/atom":
        out = fragment_aggregate_atom(sim, gmask)
    elif style == "aggregate/atom":
        out = fragment_aggregate_atom(sim, gmask, float(spec["cutoff"]))
    elif style == "global/atom":
        out = global_atom(sim, spec, gmask)
    elif style == "erotate/sphere/atom":
        # 0.5 INERTIA mvv2e m r^2 w^2 (compute_erotate_sphere_atom.cpp)
        r = _f64(sim.gran_radius[:n])
        w = _f64(sim.istate.omega[:n])
        out = 0.5 * 0.4 * tp.mvv2e * _f64(sim.gran_rmass[:n]) * r * r \
            * (w * w).sum(1)
        out = torch.where(gm & (r > 0), out, 0.0)
    elif style == "contact/atom":
        out = contact_atom(sim, gmask)
    else:
        raise ValueError(f"per-atom compute style {style}")
    cache[cid] = out
    return out


def _atom_fields(sim):
    """The per-atom input columns of property/atom, reduce, ave/atom and
    ave/histo (x y z vx vy vz fx fy fz q type mol mass id), float64."""
    n = sim.natoms
    sys = sim.sys
    s = sim.script
    dev = sys.x.device
    x = _f64(sys.x[:n])
    v = _f64(sys.v[:n])
    f = _f64(sim.res.f[:n]) if sim.res is not None else torch.zeros_like(x)
    src = {"q": _f64(sys.q[:n]),
           "type": torch.as_tensor(np.asarray(s.type)[:n], dtype=torch.float64,
                                   device=dev),
           "mol": torch.as_tensor(np.asarray(s.mol)[:n], dtype=torch.float64,
                                  device=dev),
           "mass": _f64(sim.thermo_params.mass_atom[:n]),
           "id": torch.arange(1, n + 1, dtype=torch.float64, device=dev)}
    for k, w in enumerate("xyz"):
        src[w] = x[:, k]
        src["v" + w] = v[:, k]
        src["f" + w] = f[:, k]
    return src


def peratom_column(sim, tok):
    """A per-atom input token (x/y/z, vx.., fx.., q, type, mol, mass, id,
    c_ID[/col], f_ID[/col] of fix ave/atom and store/state) as an (N,)
    float64 tensor: the input grammar of compute reduce, fix ave/atom,
    fix ave/histo and fix store/state (lidp_tpu/computes.py
    peratom_column).  A fix ave/atom that has
    averaged nothing yet gives zeros."""
    n = sim.natoms
    if tok.startswith(("c_", "f_")):
        name = tok[2:]
        col = None
        if name.endswith("]"):
            name, idx = name[:-1].split("[")
            col = int(idx) - 1
        if tok.startswith("c_"):
            if name not in sim.peratom_computes \
                    and name not in sim.chunk_computes:
                raise KeyError(f"{tok}: not a per-atom compute")
            arr = eval_peratom(sim, name)
        else:
            spec = sim.script.fixes.get(name)
            if spec is None or spec.style not in ("ave/atom",
                                                  "store/state"):
                raise NotImplementedError(
                    f"per-atom input {tok}: only fix ave/atom's and "
                    "store/state's are ported (fix store/force: ROADMAP "
                    "queue 1 item 6.1)")
            arr = getattr(spec, "_peratom_store", None)
            if arr is None:
                arr = torch.zeros(n, dtype=torch.float64,
                                  device=sim.sys.x.device)
        return arr if arr.ndim == 1 else arr[:, col if col is not None
                                             else 0]
    src = _atom_fields(sim)
    if tok not in src:
        raise KeyError(f"per-atom input {tok}")
    return src[tok]


def eval_reduce(sim, cid):
    """compute reduce / reduce/region (compute_reduce.cpp) with sum, ave,
    min or max: a list of 0-d float64 tensors, one per input (not yet
    read to the host)."""
    gmask, spec = sim.reduce_computes[cid]
    gm = _gmask(sim, gmask)
    if spec.get("region") is not None:
        rm = sim.script._region_mask(spec["region"], x=_current_x(sim))
        gm = gm & torch.as_tensor(np.asarray(rm)[:sim.natoms],
                                  device=gm.device)
    mode = spec["mode"]
    zero = torch.zeros((), dtype=torch.float64, device=gm.device)
    outs = []
    for tok in spec["inputs"]:
        sel = peratom_column(sim, tok)[gm]
        if mode == "sum":
            outs.append(sel.sum())
        elif sel.numel() == 0:
            outs.append(zero)
        elif mode == "min":
            outs.append(sel.min())
        elif mode == "max":
            outs.append(sel.max())
        else:
            outs.append(sel.mean())
    return outs


# ------------------------------ global computes ------------------------------

def simple_compute(sim, gmask, style):
    """compute com (3 components), gyration, ke, pe as 0-d float64 tensors
    (compute_com.cpp, compute_gyration.cpp, compute_ke.cpp,
    compute_pe.cpp: the force evaluation's pe, polarization included, no
    tail term); the masses are the thermo's (lidp_tpu/sim.py:3008-3030)."""
    if style == "pe":
        return [_f64(sim.res.pe)]
    n = sim.natoms
    gm = _gmask(sim, gmask)
    m = _f64(sim.thermo_params.mass_atom[:n])[gm]
    if style == "ke":
        v = _f64(sim.sys.v[:n])[gm]
        return [0.5 * sim.thermo_params.mvv2e * (m[:, None] * v * v).sum()]
    xu = _f64(_xu(sim))[gm]
    com = (m[:, None] * xu).sum(0) / m.sum()
    if style == "com":
        return [com[0], com[1], com[2]]
    d2 = ((xu - com) ** 2).sum(1)
    return [torch.sqrt((m * d2).sum() / m.sum())]


def msd(sim, gmask, x0):
    """compute msd (compute_msd.cpp): the group's mean squared
    displacement of the unwrapped positions from those at the compute's
    definition, per component and total."""
    gm = _gmask(sim, gmask)
    d = (_f64(_xu(sim)) - x0)[gm]
    comps = (d * d).mean(0)
    return [comps[0], comps[1], comps[2], comps.sum()]


def vacf(sim, gmask, v0):
    """compute vacf (compute_vacf.cpp): <v(t) . v(0)> over the group, per
    component and total, v0 the velocities at the definition."""
    gm = _gmask(sim, gmask)
    v = _f64(sim.sys.v[:sim.natoms])[gm]
    comps = (v * v0[gm]).mean(0)
    return [comps[0], comps[1], comps[2], comps.sum()]


def _bin_sums(ib, w, nbin):
    """Per-bin sums of w by the bin index ib, column sums of a masked
    (N, nbin) block: the same order on every call."""
    hit = ib[:, None] == torch.arange(nbin, device=ib.device)[None, :]
    return torch.where(hit, w[:, None], 0.0).sum(0)


def temp_variant(sim, gmask, style, args):
    """compute temp/ramp, temp/region and temp/profile as 0-d float64
    tensors (compute_temp_ramp.cpp, compute_temp_region.cpp,
    compute_temp_profile.cpp; lidp_tpu/sim.py _temp_variant)."""
    n = sim.natoms
    tp = sim.thermo_params
    dim = tp.dim
    gm = _gmask(sim, gmask)
    v = _f64(sim.sys.v[:n]).clone()
    x = _f64(sim.sys.x[:n])
    m = _f64(tp.mass_atom[:n])
    if style == "temp/ramp":
        # vdim vlo vhi dim clo chi [units lattice|box]; lattice units
        # scale coords and velocities (compute_temp_ramp.cpp:60-75)
        s3 = (np.ones(3) if "box" in args
              else np.asarray(sim.script._spacing3()))
        vdim = "xyz".index(args[0].lstrip("v"))
        cdim = "xyz".index(args[3])
        vlo, vhi = float(args[1]) * s3[vdim], float(args[2]) * s3[vdim]
        clo, chi = float(args[4]) * s3[cdim], float(args[5]) * s3[cdim]
        frac = torch.clamp((x[:, cdim] - clo) / (chi - clo), 0.0, 1.0)
        v[:, vdim] -= vlo + frac * (vhi - vlo)
        sel = gm
        dof = dim * int(gm.sum()) - dim
    elif style == "temp/region":
        rm = sim.script._region_mask(args[0], x=_current_x(sim))
        sel = gm & torch.as_tensor(np.asarray(rm)[:n], device=gm.device)
        dof = dim * int(sel.sum()) - dim
    else:
        # temp/profile xflag yflag zflag x|y|z nbin: 1d binning;
        # Evans-Morriss, the dof lose dim a bin (compute_temp_profile.cpp)
        flags = [int(args[0]), int(args[1]), int(args[2])]
        if args[3] not in ("x", "y", "z"):
            raise NotImplementedError(
                "compute temp/profile bins in one dimension (x, y or z), "
                "as the JAX package does")
        bdim = "xyz".index(args[3])
        nbin = int(args[4])
        box = sim.sys.box
        lo = float(box.lo[bdim])
        L = float(box.lengths[bdim])
        # bin_assign wraps a drifted coordinate by one period
        c = x[:, bdim].clone()
        if box.periodic[bdim]:
            c = torch.where(c < lo, c + L, c)
            c = torch.where(c >= lo + L, c - L, c)
        ib = torch.clamp(((c - lo) / L * nbin).long(), 0, nbin - 1)
        for d_ in range(3):
            if not flags[d_]:
                continue
            msum = _bin_sums(ib[gm], m[gm], nbin)
            psum = _bin_sums(ib[gm], (m * v[:, d_])[gm], nbin)
            vave = torch.where(msum > 0,
                               psum / torch.clamp(msum, min=1e-300), 0.0)
            v[:, d_] -= vave[ib]
        sel = gm
        dof = dim * int(gm.sum()) - dim - dim * nbin
    t = tp.mvv2e * (m[sel, None] * v[sel] ** 2).sum()
    if dof <= 0:
        return torch.zeros_like(t)
    return t / (dof * tp.boltz)


def rigid_scalar(sim, rstyle):
    """compute ke/rigid (0.5 mvv2e sum M vcm^2, compute_ke_rigid.cpp +
    FixRigid::extract_ke) or erotate/rigid (0.5 mvv2e sum I_k wbody_k^2,
    zero-inertia components dropped; extract_erotational), divided by
    natoms under thermo norm (both are extensive; lidp_tpu/sim.py
    _rigid_scalar)."""
    from lidp_tpu_torch.integrate.rigid import q_to_matrix

    p = sim.runner.integ.params
    st = sim.istate
    if not hasattr(p, "masstotal") or not hasattr(st, "vcm"):
        raise ValueError(f"compute {rstyle} needs a rigid-body fix")
    tp = sim.thermo_params
    norm = float(tp.natoms) if tp.norm else 1.0
    if rstyle == "ke/rigid":
        vcm = _f64(st.vcm)
        mv2 = _f64(p.masstotal) * (vcm * vcm).sum(1)
        return 0.5 * tp.mvv2e * mv2.sum() / norm
    R = _f64(q_to_matrix(st.quat))          # columns = body axes
    L = _f64(st.angmom)
    inertia = _f64(p.inertia)
    mbody = torch.einsum("bij,bi->bj", R, L)   # R^T L
    wbody = torch.where(inertia > 0.0,
                        mbody / torch.where(inertia > 0.0, inertia, 1.0), 0.0)
    return 0.5 * tp.mvv2e * (inertia * wbody * wbody).sum() / norm


def group_group_energy(sim, maska, maskb):
    """compute group/group: the pair energy (LJ + coulomb real space,
    Pair::single, no special factors, no polarization, as the JAX package
    takes it) between two groups, each unordered pair once, row-blocked
    over group A: a 0-d float64 tensor."""
    n = sim.natoms
    sys = sim.sys
    dev = sys.x.device
    ma = _gmask(sim, maska)
    mb = _gmask(sim, maskb)
    pair = pair64(sim)
    q = sys.q[:n].double()
    ty = sys.type[:n]
    rows = ma.nonzero().squeeze(1)
    both = ma & mb
    total = torch.zeros((), dtype=torch.float64, device=dev)
    # the JAX function folds every dimension (box.lengths)
    for blk in _pair_rows(sim, rows=rows, cols=mb, specials=False,
                          lengths=sys.box.lengths):
        gi, jj = rows[blk.i0 + blk.ii], blk.jj
        e, _ = pair_single(blk.rsq, ty[gi], ty[jj], q[gi], q[jj], pair)
        w = torch.where(both[gi] & both[jj], 0.5, 1.0)
        total = total + (e * w).sum()
    return total


def rdf(sim, gmask, nbin):
    """compute rdf Nbin (compute_rdf.cpp as the JAX package forms it): an
    (Nbin, 3) float64 numpy array [r, g(r), coord] over the group's
    unordered pairs within the pair cutoff.  The distances in float64 and
    their bins as np.histogram assigns them (its edges, with its
    correction of a guess off by one), counted exactly, over the cell
    candidates of _pair_rows."""
    n = sim.natoms
    sys = sim.sys
    dev = sys.x.device
    gm = _gmask(sim, gmask)
    ff = sim.runner.ff
    cutsq = ff.pair.cutsq if ff.pair is not None else None
    cut = (float(np.sqrt(np.max(cutsq.double().cpu().numpy())))
           if cutsq is not None else float(ff.eam.cut))
    rows = gm.nonzero().squeeze(1)
    ng = rows.shape[0]
    edges_np = np.linspace(0.0, cut, nbin + 1)
    edges = torch.as_tensor(edges_np, device=dev)
    hist = torch.zeros(nbin, dtype=torch.long, device=dev)
    # the candidates a hair past the cutoff, then r < cut exactly as the
    # JAX function selects them; each unordered pair from its lower atom
    for blk in _pair_rows(sim, extra_cut=cut * (1.0 + 1e-9), rows=rows,
                          cols=gm, lengths=sys.box.lengths):
        r = torch.sqrt(blk.rsq)
        keep = (blk.jj > rows[blk.i0 + blk.ii]) & (r < cut)
        rr = r[keep]
        idx = (rr / cut * nbin).long()
        idx = torch.where(idx == nbin, nbin - 1, idx)
        idx = torch.where(rr < edges[idx], idx - 1, idx)
        idx = torch.where((rr >= edges[idx + 1]) & (idx != nbin - 1),
                          idx + 1, idx)
        hist += torch.bincount(idx, minlength=nbin)
    hist = hist.cpu().numpy()
    rc = 0.5 * (edges_np[1:] + edges_np[:-1])
    box_l = sys.box.lengths.double().cpu().numpy()
    npairs_density = ng * (ng - 1) / 2 / float(np.prod(box_l))
    shell = 4.0 / 3.0 * np.pi * (edges_np[1:] ** 3 - edges_np[:-1] ** 3)
    g = hist / (shell * npairs_density)
    coord = np.cumsum(hist) * 2.0 / ng
    return np.stack([rc, g, coord], axis=1)


# ------------------------------ the chunks ------------------------------

def chunk_ids(sim, cid):
    """compute chunk/atom (compute_chunk_atom.cpp; lidp_tpu/sim.py
    _chunk_ids): (ids, nchunk, coord), ids (N,) long on the run's device,
    1..nchunk, 0 outside the compute's group or padding; coord the bins'
    printed centres, numpy (nchunk,) for bin/1d, (nchunk, d) for
    bin/2d|3d, None for type and molecule.  Bins (setup_xyz_bins): the
    origin (lower, center, upper or a coordinate) extended down by whole
    bins to cover the box, the positions wrapped into the box along every
    binned dimension, the index clipped into [0, nbin), ids row-major
    with the last dimension fastest; in float64 from the run's positions.
    Cached per state."""
    cache = sim.peratom_cache()
    key = ("chunk", cid)
    if key in cache:
        return cache[key]
    gmask, spec = sim.chunk_computes[cid]
    n = sim.natoms
    sys = sim.sys
    dev = sys.x.device
    coord = None
    if spec["which"] == "type":
        ids = sys.type[:n].long()
        nchunk = int(sim.script.ntypes)
    elif spec["which"] == "molecule":
        ids = sys.mol[:n].long()
        nchunk = int(ids.max()) if n else 0
    else:
        lo_all = sys.box.lo.double().cpu().numpy()
        prd_all = sys.box.lengths.double().cpu().numpy()
        s3 = sim.script.lattice_spacing3
        per_dim = []
        for d, org, delta in zip(spec["dims"], spec["origins"],
                                 spec["deltas"]):
            lo, prd = float(lo_all[d]), float(prd_all[d])
            if spec["units"] == "reduced":
                delta = delta * prd
            elif spec["units"] == "lattice" and s3 is not None:
                delta = delta * float(s3[d])
            origin = {"lower": lo, "upper": lo + prd,
                      "center": lo + 0.5 * prd}.get(org)
            if origin is None:
                origin = float(org)
            while origin > lo:
                origin -= delta
            nbin = int(np.ceil((lo + prd - origin) / delta))
            # divisors as device tensors: CUDA divides by a host scalar
            # through its reciprocal, which moves a position on a bin's
            # edge into the next bin
            prd_t, delta_t = (torch.tensor(v, dtype=torch.float64,
                                           device=dev) for v in (prd, delta))
            x = sys.x[:n, d].double()
            x = x - prd * torch.floor((x - lo) / prd_t)
            idx = torch.clamp(torch.floor((x - origin) / delta_t).long(), 0,
                              nbin - 1)
            per_dim.append((idx, nbin,
                            origin + (np.arange(nbin) + 0.5) * delta))
        nchunk = 1
        ids = torch.zeros(n, dtype=torch.long, device=dev)
        for idx, nbin, _ in per_dim:
            ids = ids * nbin + idx
            nchunk *= nbin
        ids = ids + 1
        grids = np.meshgrid(*[c for _, _, c in per_dim], indexing="ij")
        coord = np.stack([g.reshape(-1) for g in grids], axis=-1)
        if len(per_dim) == 1:
            coord = coord[:, 0]
    ids = torch.where(_gmask(sim, gmask) & sys.mask[:n], ids, 0)
    out = (ids, nchunk, coord)
    cache[key] = out
    return out


class ChunkTable:
    """The atoms of each chunk in a dense (nchunk, cap) index table, in
    ascending atom order, N where none: a per-chunk sum is a sum along a
    row of the gathered values, the same order on every call (no float
    index_add_).  Atoms of chunk 0 (outside the group) are in no row."""

    def __init__(self, ids, nchunk):
        n = ids.shape[0]
        dev = ids.device
        self.n, self.nchunk = n, nchunk
        counts = torch.bincount(ids, minlength=nchunk + 1)
        self.count = counts[1:nchunk + 1]
        order = torch.sort(ids, stable=True).indices
        sid = ids[order]
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(n, device=dev) - start[sid]
        cap = int(self.count.max()) if nchunk and n else 0
        self.table = torch.full((nchunk + 1, max(cap, 1)), n,
                                dtype=torch.long, device=dev)
        live = sid > 0
        self.table[sid[live], rank[live]] = order[live]
        self.table = self.table[1:]

    def sum(self, w):
        """Per-chunk sums of w ((N,) or (N, k)): (nchunk,) or (nchunk, k).
        On the CPU the last of a row's running sums, which add in
        ascending atom order as the JAX package's np.bincount does (the
        same bits); on the card the row sums, in a fixed order (torch's
        CUDA cumsum is not promised to repeat)."""
        rows = torch.cat([w, w.new_zeros((1,) + w.shape[1:])])[self.table]
        return rows.sum(1) if rows.is_cuda else rows.cumsum(1)[:, -1]


def _xu64(sim):
    """Unwrapped positions of the real atoms in float64 (Domain::unmap)."""
    sys = sim.sys
    n = sim.natoms
    return sys.x[:n].double() + sys.image[:n].double() \
        * sys.box.lengths.double()


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def eval_chunk_agg(sim, cid):
    """The */chunk computes (compute_com_chunk.cpp, vcm, gyration, angmom,
    torque, inertia, omega, dipole, msd, property and temp/chunk;
    lidp_tpu/computes.py eval_chunk_agg): an (nchunk, ncols) float64
    tensor on the run's device from the unwrapped positions, or a 0-d one
    for temp/chunk with no value keyword.  The compute's own group gates
    atoms on top of the chunk compute's.  msd/chunk takes its reference
    centres at its first evaluation (the run's setup: Simulation.run) and
    gives zeros there.  Cached per state."""
    cache = sim.peratom_cache()
    key = ("chunkagg", cid)
    if key in cache:
        return cache[key]
    gmask, style, chunkid, extra = sim.chunkagg_computes[cid]
    ids, nchunk, ccoord = chunk_ids(sim, chunkid)
    n = sim.natoms
    sys = sim.sys
    tp = sim.thermo_params
    ids = torch.where(_gmask(sim, gmask), ids, 0)
    sel = ids > 0
    tab = ChunkTable(ids, nchunk)
    m = _f64(tp.mass_atom[:n])
    xu = _xu64(sim)
    v = _f64(sys.v[:n])
    at = torch.clamp(ids - 1, min=0)
    M = tab.sum(m)
    ok = M > 0.0
    Ms = torch.clamp(M, min=1e-300)

    def per_mass(w3):
        return torch.where(ok[:, None], tab.sum(m[:, None] * w3)
                           / Ms[:, None], 0.0)

    com = per_mass(xu)
    d = xu - com[at]
    if style == "com/chunk":
        out = com
    elif style == "vcm/chunk":
        out = per_mass(v)
    elif style == "gyration/chunk":
        if "tensor" in extra:
            # xx yy zz xy xz yz / masstotal (compute_array)
            cols = torch.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1],
                                d[:, 2] * d[:, 2], d[:, 0] * d[:, 1],
                                d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]], 1)
            out = torch.where(ok[:, None],
                              tab.sum(m[:, None] * cols) / Ms[:, None], 0.0)
        else:
            rg = torch.sqrt(tab.sum(m * (d * d).sum(1)) / Ms)
            out = torch.where(ok, rg, 0.0)[:, None]
    elif style == "angmom/chunk":
        out = tab.sum(m[:, None] * _cross(d, v))
    elif style == "torque/chunk":
        out = tab.sum(_cross(d, _f64(sim.res.f[:n])))
    elif style in ("inertia/chunk", "omega/chunk"):
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        ine = tab.sum(torch.stack([m * (dy * dy + dz * dz),
                                   m * (dx * dx + dz * dz),
                                   m * (dx * dx + dy * dy),
                                   -(m * dx * dy), -(m * dy * dz),
                                   -(m * dx * dz)], 1))
        out = ine if style == "inertia/chunk" else _omega(
            ine, tab.sum(m[:, None] * _cross(d, v)))
    elif style == "dipole/chunk":
        q = _f64(sys.q[:n])
        if any(e.startswith("geom") for e in extra):
            cnt = tab.sum(torch.ones_like(m))
            ctr = torch.where((cnt > 0)[:, None], tab.sum(xu)
                              / torch.clamp(cnt, min=1e-300)[:, None], 0.0)
        else:
            ctr = com
        mu = tab.sum(q[:, None] * xu) - tab.sum(q)[:, None] * ctr
        out = torch.cat([mu, torch.sqrt((mu * mu).sum(1))[:, None]], 1)
    elif style == "msd/chunk":
        refs = sim.msdchunk_ref
        if cid not in refs:
            refs[cid] = com.clone()
            out = torch.zeros((nchunk, 4), dtype=torch.float64,
                              device=xu.device)
        else:
            dd = com - refs[cid]
            out = torch.cat([dd * dd, (dd * dd).sum(1)[:, None]], 1)
    elif style == "property/chunk":
        cols = []
        for tok in extra:
            if tok == "count":
                cols.append(tab.sum(torch.ones_like(m)))
            elif tok.startswith("coord"):
                cc = np.asarray(ccoord)
                j = int(tok[5:]) - 1
                cols.append(torch.as_tensor(cc if cc.ndim == 1 else cc[:, j],
                                            device=xu.device))
            else:
                cols.append(torch.arange(1, nchunk + 1, dtype=torch.float64,
                                         device=xu.device))
        out = torch.stack(cols, 1)
    else:
        out = _temp_chunk(sim, tab, extra, nchunk, sel, m, v, M, ok, at)
    cache[key] = out
    return out


def _omega(ine, L):
    """omega/chunk's angular velocities from the inertia tensors (xx yy zz
    xy yz xz) and angular momenta, batched: solved where det(I) > EPS,
    else by the principal axes with the moments below EPS of the largest
    zeroed (angmom_to_omega).  The sum over the axes e_k (e_k . L) / w_k
    depends neither on the eigenvectors' signs nor on the basis of a
    degenerate subspace, so the batched eigh serves for LAPACK's."""
    z = ine
    I = torch.stack([torch.stack([z[:, 0], z[:, 3], z[:, 5]], 1),
                     torch.stack([z[:, 3], z[:, 1], z[:, 4]], 1),
                     torch.stack([z[:, 5], z[:, 4], z[:, 2]], 1)], 1)
    det = torch.linalg.det(I)
    solve = det > OMEGA_EPS
    eye = torch.eye(3, dtype=I.dtype, device=I.device).expand_as(I)
    w_solve = torch.linalg.solve(torch.where(solve[:, None, None], I, eye),
                                 L)
    w, E = torch.linalg.eigh(I)
    w = torch.where(w < OMEGA_EPS * w.max(1, keepdim=True).values, 0.0, w)
    lam = torch.einsum("bji,bj->bi", E, L)
    wbody = torch.where(w > 0, lam / torch.clamp(w, min=1e-300), 0.0)
    w_eig = torch.einsum("bij,bj->bi", E, wbody)
    return torch.where(solve[:, None], w_solve, w_eig)


def _temp_chunk(sim, tab, extra, nchunk, sel, m, v, M, ok, at):
    """temp/chunk (compute_temp_chunk.cpp): with no value keyword the
    scalar temperature of the chunked atoms (com yes: each chunk's vcm
    removed; dof nchunk*cdof + adof*count), else the columns temp, kecom
    and internal."""
    tp = sim.thermo_params
    comflag, adof, cdof, vals = temp_chunk_keywords(extra, tp.dim)
    vcm = torch.where(ok[:, None], tab.sum(m[:, None] * v)
                      / torch.clamp(M, min=1e-300)[:, None], 0.0)
    vv = v - vcm[at] if comflag else v
    if not vals:
        t = tp.mvv2e * torch.where(sel, m * (vv * vv).sum(1), 0.0).sum()
        dof = nchunk * cdof + adof * float(int(sel.sum()))
        return t / (dof * tp.boltz) if dof > 0 else torch.zeros_like(t)
    cnt = tab.sum(torch.ones_like(m))
    cols = []
    for tok in vals:
        if tok == "temp":
            t = tab.sum(m * (vv * vv).sum(1)) * tp.mvv2e
            dof = cdof + adof * cnt
            cols.append(torch.where(dof > 0, t / torch.clamp(dof, min=1e-300)
                                    / tp.boltz, 0.0))
        elif tok == "kecom":
            cols.append(0.5 * tp.mvv2e * M * (vcm * vcm).sum(1))
        else:
            dv = v - vcm[at]
            cols.append(0.5 * tp.mvv2e * tab.sum(m * (dv * dv).sum(1)))
    return torch.stack(cols, 1)


def temp_chunk_keywords(extra, dim):
    """temp/chunk's arguments: (com, adof, cdof, values), adof dim and
    cdof 0 by default."""
    comflag, adof, cdof, vals = False, float(dim), 0.0, []
    i = 0
    while i < len(extra):
        if extra[i] == "com":
            comflag = extra[i + 1] == "yes"
            i += 2
        elif extra[i] == "adof":
            adof = float(extra[i + 1])
            i += 2
        elif extra[i] == "cdof":
            cdof = float(extra[i + 1])
            i += 2
        else:
            vals.append(extra[i])
            i += 1
    return comflag, adof, cdof, vals


def eval_heat_flux(sim, cid):
    """compute heat/flux ke-ID pe-ID stress-ID (ComputeHeatFlux::
    compute_vector; lidp_tpu/computes.py eval_heat_flux): the (6,) float64
    tensor [Jx Jy Jz Jcx Jcy Jcz], J = sum (pe + ke) v - S.v / nktv2p over
    the group, Jc its convective part (no volume normalization, as in the
    reference)."""
    gmask, ids = sim.hf_computes[cid]
    n = sim.natoms
    gm = _gmask(sim, gmask)
    ke = eval_peratom(sim, ids[0])
    pe = eval_peratom(sim, ids[1])
    st = eval_peratom(sim, ids[2])
    v = _f64(sim.sys.v[:n])
    eng = torch.where(gm, pe + ke, 0.0)
    jc = (eng[:, None] * v).sum(0)
    jv = -torch.stack([
        st[:, 0] * v[:, 0] + st[:, 3] * v[:, 1] + st[:, 4] * v[:, 2],
        st[:, 3] * v[:, 0] + st[:, 1] * v[:, 1] + st[:, 5] * v[:, 2],
        st[:, 4] * v[:, 0] + st[:, 5] * v[:, 1] + st[:, 2] * v[:, 2]], 1)
    jv = torch.where(gm[:, None], jv, 0.0).sum(0) \
        / float(sim.thermo_params.nktv2p)
    return torch.cat([jc + jv, jc])


def global_atom(sim, spec, gmask):
    """compute global/atom index input... (compute_global_atom.cpp:336-420):
    per atom, the entry of each global vector (a chunk array's column or
    its whole array read row by row, heat/flux) at the atom's index (its
    per-atom input rounded down, 1-based); 0 out of range or outside the
    group."""
    from lidp_tpu_torch.styles import fix_output

    gm = _gmask(sim, gmask)
    idx = torch.floor(peratom_column(sim, spec["ref"])).long() - 1
    cols = []
    for tok in spec["inputs"]:
        vec = fix_output.global_array(sim, tok).reshape(-1)
        inside = (idx >= 0) & (idx < vec.shape[0]) & gm
        col = vec[torch.clamp(idx, 0, vec.shape[0] - 1)]
        cols.append(torch.where(inside, col, 0.0))
    return cols[0] if len(cols) == 1 else torch.stack(cols, 1)
