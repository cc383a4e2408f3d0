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
and reduce/region (compute_reduce.cpp); and the global ones: com,
gyration, ke, pe, msd, vacf, rdf, group/group, temp/ramp, temp/region,
temp/profile, ke/rigid and erotate/rigid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.box import minimum_image, unwrap
from lidp_tpu_torch.ops.pair import pair_single

# elements of one (B, N) block of the pair passes: B rows of N columns
BLOCK_ELEMENTS = 1 << 23

# the per-atom styles eval_peratom takes
PERATOM_STYLES = ("ke/atom", "pe/atom", "stress/atom", "coord/atom",
                  "cluster/atom", "displace/atom", "property/atom")


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
               lengths=None, x=None):
    """Yield _Blocks over row blocks: the pairs (i, j), i in `rows` (an
    index tensor; all real atoms by default) and j among the real atoms
    (`cols`, a bool mask, all by default), j != i, inside the pair's
    force cutoff (or extra_cut, every type).  With the force cutoff and
    `specials`, the special pairs of weight 0 in both factors are left out
    as the reference's neighbor list leaves them, and fl, fc are the
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
    cut = extra_cut if extra_cut is not None else float(
        torch.sqrt(pair.cutsq.double().max()))
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
            sel = rsq < pair.cutsq[ty[ri][:, None], ty[cj]]
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
    c_ID[/col], f_ID[/col] of fix ave/atom) as an (N,) float64 tensor: the
    input grammar of compute reduce, fix ave/atom and fix ave/histo
    (lidp_tpu/computes.py peratom_column).  A fix ave/atom that has
    averaged nothing yet gives zeros."""
    n = sim.natoms
    if tok.startswith(("c_", "f_")):
        name = tok[2:]
        col = None
        if name.endswith("]"):
            name, idx = name[:-1].split("[")
            col = int(idx) - 1
        if tok.startswith("c_"):
            if name not in sim.peratom_computes:
                raise KeyError(f"{tok}: not a per-atom compute")
            arr = eval_peratom(sim, name)
        else:
            spec = sim.script.fixes.get(name)
            if spec is None or spec.style != "ave/atom":
                raise NotImplementedError(
                    f"per-atom input {tok}: only fix ave/atom's are ported "
                    "(fix store/state and store/force: ROADMAP queue 1 "
                    "items 6.16 and 6.1)")
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
