"""Trajectory dump writers and reader (lidp_tpu/io/dump.py, an own copy
reading the port's tensors; the Python row formatter, not the compiled
one).

Matches the reference Dump::write (dump.cpp:302) / DumpCustom text layout
(columns like ``x y z type mol``), with ``dump_modify sort id`` ordering
(the arrays are already id-ordered).  The per-atom compute columns c_ID
and c_ID[i] (computes.eval_peratom), fix ave/atom's and fix store/state's
f_ID and f_ID[i] (zeros before ave/atom's first Nfreq), as the JAX writer
forms them (its io/dump.py:45-60).  Also dump xyz (dump_xyz.cpp), cfg
(dump_cfg.cpp), the binary dcd (dump_dcd.cpp), image and movie frames
(a software rasterizer writing PPM, as the JAX package's), dump local
(dump_local.cpp) over the local computes' rows, and the native text
reader behind read_dump and rerun.

The local computes' rows: pair/local and property/local's pair columns
are formed on the run's device from the per-atom pair pass's cell
candidates (computes._pair_rows, float64), i < j in (i, j) order as the
JAX package's dense scan gives them; the bonded and rigid rows on the
host, as the JAX functions form them.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np
import torch

_INT_COLS = {"id", "type", "mol"}
COLUMNS = ("id", "type", "mol", "x", "y", "z", "xs", "ys", "zs", "xu", "yu",
           "zu", "vx", "vy", "vz", "q", "fx", "fy", "fz", "mux", "muy",
           "muz")
# the local compute styles dump local reads
LOCAL_STYLES = ("pair/local", "bond/local", "angle/local", "dihedral/local",
                "improper/local", "property/local", "rigid/local")
# the values each local style takes (compute_*_local.cpp as the JAX
# functions read them)
PAIR_LOCAL_VALUES = ("dist", "eng", "force", "fx", "fy", "fz", "p1", "p2")
PROPERTY_PAIR_VALUES = ("patom1", "patom2", "ptype1", "ptype2", "natom1",
                        "natom2", "ntype1", "ntype2")
PROPERTY_BOND_VALUES = ("batom1", "batom2", "btype")
RIGID_LOCAL_VALUES = ("id", "mol", "mass") + tuple(
    p + ax for ax in "xyz" for p in ("", "i", "v", "f", "tq", "omega",
                                     "angmom", "inertia")) + tuple(
    ax + "u" for ax in "xyz") + tuple("quat" + k for k in "wijk")
_TRICLINIC = "ROADMAP queue 1 item 6.4, triclinic boxes"


def _np(t, n):
    return t[:n].double().cpu().numpy()


def _nreal(sys):
    return int(np.count_nonzero(sys.mask.cpu().numpy()))


def _wrapped(sys, x):
    """x (host, float64) wrapped into the box on the periodic dims only:
    the reference never remaps f/s/m boundaries (Dump::write)."""
    lo = sys.box.lo.double().cpu().numpy()
    hi = sys.box.hi.double().cpu().numpy()
    L = hi - lo
    per = np.asarray(sys.box.periodic, bool)
    return np.where(per, x - np.floor((x - lo) / L) * L, x), lo, hi, L


def _open(spec, binary=False):
    """The dump's file: truncated at its first frame, appended after."""
    mode = ("a" if getattr(spec, "_started", False) else "w") + (
        "b" if binary else "")
    spec._started = True
    return open(spec.path, mode)


def write_dump_frame(spec, sys, script, gmask, f=None):
    """Append one frame of dump `spec` (style custom, atom or xyz) for the
    atoms of the group mask `gmask` (numpy, the script's real atoms):
    positions wrapped into the box on periodic dimensions (the engine
    keeps rigid coordinates unwrapped), unwrapped ones as xu yu zu.  f:
    the forces of the frame's step (zeros when absent)."""
    for c in spec.columns:
        if c not in COLUMNS and not c.startswith(("c_", "f_")):
            raise NotImplementedError(
                f"dump column {c} is not ported (only {', '.join(COLUMNS)}, "
                "c_ID and f_ID; ROADMAP queue 1 item 4)")
    n = len(gmask)
    x = _np(sys.x, n)
    xw, lo, hi, L = _wrapped(sys, x)
    ids = np.nonzero(gmask)[0]
    if spec.style == "xyz":
        # dump_xyz.cpp: natoms line, comment, then `TYPE x y z` rows (the
        # element symbol is the type number without a dump_modify element
        # map)
        typ = np.asarray(script.type)
        vals = []
        for i in ids:
            vals += (int(typ[i]), xw[i, 0], xw[i, 1], xw[i, 2])
        with _open(spec) as fh:
            fh.write("%d\n" % len(ids))
            fh.write("Atoms. Timestep: %d\n" % int(sys.step))
            fh.write(("%d %g %g %g\n" * len(ids)) % tuple(vals))
        return
    v = _np(sys.v, n)
    mu = _np(sys.mu, n)
    fv = _np(f, n) if f is not None else np.zeros_like(x)
    colvec = {
        "id": ids + 1,
        "x": xw[ids, 0], "y": xw[ids, 1], "z": xw[ids, 2],
        # scaled coords (dump atom default)
        "xs": (xw[ids, 0] - lo[0]) / L[0],
        "ys": (xw[ids, 1] - lo[1]) / L[1],
        "zs": (xw[ids, 2] - lo[2]) / L[2],
        "xu": x[ids, 0], "yu": x[ids, 1], "zu": x[ids, 2],
        "type": np.asarray(script.type)[ids],
        "mol": np.asarray(script.mol)[ids],
        "vx": v[ids, 0], "vy": v[ids, 1], "vz": v[ids, 2],
        "q": _np(sys.q, n)[ids],
        "fx": fv[ids, 0], "fy": fv[ids, 1], "fz": fv[ids, 2],
        "mux": mu[ids, 0], "muy": mu[ids, 1], "muz": mu[ids, 2],
    }
    for c in spec.columns:
        if c.startswith(("c_", "f_")):
            colvec[c] = _peratom_column(script, c, n)[ids]
    with _open(spec) as fh:
        fh.write("ITEM: TIMESTEP\n%d\n" % int(sys.step))
        fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % len(ids))
        fh.write("ITEM: BOX BOUNDS pp pp pp\n")
        for d in range(3):
            fh.write("%-1.16e %-1.16e\n" % (lo[d], hi[d]))
        fh.write("ITEM: ATOMS " + " ".join(spec.columns) + "\n")
        vals = np.stack([np.asarray(colvec[c], np.float64)
                         for c in spec.columns], axis=1)
        flags = [c in _INT_COLS for c in spec.columns]
        ffmt = getattr(spec, "float_fmt", "%g")
        for r in range(vals.shape[0]):
            fh.write(" ".join(
                str(int(vals[r, c])) if flags[c] else ffmt % vals[r, c]
                for c in range(vals.shape[1])) + "\n")


def _peratom_column(script, c, n):
    """A dump column c_ID[/i] (a per-atom compute, a chunk/atom compute's
    chunk ids) or f_ID[/i] (fix ave/atom's average, zeros before it has
    one; fix store/state's snapshot) as an (n,) numpy array."""
    from lidp_tpu_torch import computes

    sim = script._sim
    name = c[2:].split("[")[0]
    if c.startswith("c_"):
        if name not in sim.peratom_computes \
                and name not in sim.chunk_computes:
            raise ValueError(f"dump column {c}: compute {name} is not a "
                             "per-atom compute")
    elif script.fixes[name].style not in ("ave/atom", "store/state"):
        raise NotImplementedError(
            f"dump column {c}: only fix ave/atom's and store/state's "
            "per-atom values are ported (fix store/force: ROADMAP queue 1 "
            "item 6.1)")
    return computes.peratom_column(sim, c).cpu().numpy()[:n]


def write_cfg_frame(spec, sys, script, gmask):
    """Extended CFG format (dump_cfg.cpp / AtomEye): H0 cell matrix,
    .NO_VELOCITY., per-atom mass + type label + scaled coords + any
    auxiliary columns after the mandatory `mass type xs ys zs` prefix."""
    ids = np.nonzero(gmask)[0]
    n = len(gmask)
    xw, lo, _, L = _wrapped(sys, _np(sys.x, n))
    xs = (xw - lo) / L
    cols = list(spec.columns)
    if cols[:5] != ["mass", "type", "xs", "ys", "zs"]:
        raise ValueError(
            "dump cfg requires 'mass type xs ys zs' leading columns")
    aux = cols[5:]
    v = _np(sys.v, n)
    auxsrc = {"vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
              "q": _np(sys.q, n), "id": np.arange(1, n + 1)}
    for a in aux:
        if a not in auxsrc:
            raise ValueError(f"dump cfg auxiliary column {a} (vx vy vz q "
                             "id)")
    typ = np.asarray(script.type)
    mass = np.asarray(script.mass_type)[typ]
    with _open(spec) as fh:
        fh.write("Number of particles = %d\n" % len(ids))
        fh.write("A = 1.0 Angstrom (basic length-scale)\n")
        for r in range(3):
            for c in range(3):
                fh.write("H0(%d,%d) = %.10g A\n"
                         % (r + 1, c + 1, L[r] if r == c else 0.0))
        fh.write(".NO_VELOCITY.\n")
        fh.write("entry_count = %d\n" % (3 + len(aux)))
        for k, a in enumerate(aux):
            fh.write("auxiliary[%d] = %s\n" % (k, a))
        last_t = None
        for i in ids:
            if typ[i] != last_t:
                fh.write("%.10g\n%d\n" % (mass[i], int(typ[i])))
                last_t = typ[i]
            row = list(xs[i]) + [auxsrc[a][i] for a in aux]
            fh.write(" ".join("%.10g" % val for val in row) + "\n")


def _fortran_rec(fh, payload: bytes):
    fh.write(struct.pack("<i", len(payload)))
    fh.write(payload)
    fh.write(struct.pack("<i", len(payload)))


def write_dcd_frame(spec, sys, script, gmask):
    """CHARMM-format binary DCD frame (dump_dcd.cpp): 84-byte CORD header +
    title + natoms records once, then per frame a 6-double unit cell record
    and three float32 coordinate records."""
    ids = np.nonzero(gmask)[0]
    xw, _, _, L = _wrapped(sys, _np(sys.x, len(gmask)))
    first = not getattr(spec, "_started", False)
    with _open(spec, binary=True) as fh:
        if first:
            # CORD + 9 ints + delta + cell flag + 8 zeros + version = 84 B
            hdr = b"CORD" + struct.pack(
                "<9if9ii", 0, int(sys.step), spec.every, 0, 0, 0, 0, 0, 0,
                float(script.dt), 1, 0, 0, 0, 0, 0, 0, 0, 0, 24)
            _fortran_rec(fh, hdr)
            title = b"Created by lidp_tpu (dump_dcd.cpp format)".ljust(80)
            _fortran_rec(fh, struct.pack("<i", 1) + title)
            _fortran_rec(fh, struct.pack("<i", len(ids)))
        # unit cell: [a, cos(gamma), b, cos(beta), cos(alpha), c]
        _fortran_rec(fh, struct.pack("<6d", L[0], 0.0, L[1], 0.0, 0.0, L[2]))
        for d in range(3):
            _fortran_rec(fh, xw[ids, d].astype("<f4").tobytes())


# ------------------------------ local rows ------------------------------

def _group_t(sim, gmask):
    return torch.as_tensor(np.asarray(gmask)[:sim.natoms],
                           device=sim.sys.x.device)


def local_pairs(sim, gmask, skin=False):
    """The pairs of the local computes (compute_pair_local.cpp
    compute_pairs, compute_property_local.cpp): every i < j pair with both
    atoms in the group inside the pair's force cutoff (plus the skin for
    property/local's n* columns), the special pairs of weight 0 in both
    factors left out as the reference's neighbor list leaves them.  Formed
    on the device from the per-atom pass's cell candidates
    (computes._pair_rows) in float64, in (i, j) order.  Returns (i, j,
    rsq, d = x_i - x_j, fl, fc) as tensors, fl and fc None without special
    bonds."""
    from lidp_tpu_torch import computes

    n = sim.natoms
    g = _group_t(sim, gmask)
    cutsq = None
    if skin:
        cut = torch.sqrt(computes.pair64(sim).cutsq.double())
        cutsq = (cut + float(sim.script.skin)) ** 2
    rows = g.nonzero().squeeze(1)
    dev = sim.sys.x.device
    parts = [(torch.zeros(0, dtype=torch.long, device=dev),) * 2
             + (torch.zeros(0, dtype=torch.float64, device=dev),
                torch.zeros((0, 3), dtype=torch.float64, device=dev))]
    specials = None
    for blk in computes._pair_rows(sim, rows=rows, cols=g, cutsq=cutsq):
        gi = rows[blk.i0:blk.i0 + blk.nrows][blk.ii]
        sel = (gi < blk.jj).nonzero().squeeze(1)
        # the block's rows ascend; within a row, the candidates come by
        # cell: (i, j) order is a sort of the block's pairs
        sel = sel[torch.argsort(gi[sel] * n + blk.jj[sel])]
        parts.append((gi[sel], blk.jj[sel], blk.rsq[sel], blk.d[sel]))
        if blk.fl is not None:
            specials = (specials or []) + [(blk.fl[sel], blk.fc[sel])]
    out = tuple(torch.cat([p[k] for p in parts]) for k in range(4))
    if specials is None:
        return out + (None, None)
    return out + tuple(torch.cat([s[k] for s in specials]) for k in (0, 1))


def pair_local_rows(sim, gmask, values):
    """compute pair/local (compute_pair_local.cpp): dist, eng, force, fx,
    fy, fz, p1, p2 of each pair of local_pairs, eng and force from
    Pair::single (ops/pair.py pair_single, which leaves out polarization
    as the reference's single does): float64 tensors on the device."""
    from lidp_tpu_torch import computes
    from lidp_tpu_torch.ops.pair import pair_single

    for v in values:
        if v not in PAIR_LOCAL_VALUES:
            raise ValueError(f"pair/local value {v}")
    pair = computes.pair64(sim)
    if pair is None:
        raise ValueError("compute pair/local needs a pair style with "
                         "Pair::single")
    i, j, rsq, d, fl, fc = local_pairs(sim, gmask)
    sys = sim.sys
    ty = sys.type
    q = sys.q.double()
    one = torch.ones_like(rsq)
    eng, fpair = pair_single(rsq, ty[i], ty[j], q[i], q[j], pair,
                             factor_coul=one if fc is None else fc,
                             factor_lj=one if fl is None else fl)
    r = torch.sqrt(rsq)
    cols = {"dist": r, "eng": eng, "force": r * fpair,
            "p1": i + 1.0, "p2": j + 1.0}
    for k, ax in enumerate("xyz"):
        cols["f" + ax] = d[:, k] * fpair
    return [cols[v].double() for v in values]


def property_local_rows(sim, script, gmask, values):
    """compute property/local (compute_property_local.cpp): the pair
    columns (patom1/2, ptype1/2 over local_pairs; natom1/2, ntype1/2 over
    the neighbour pairs, cutoff plus skin) on the device, or the bond
    columns (batom1/2, btype) on the host, in the rows pair/local and
    bond/local give, so that mixed dump-local columns line up."""
    kinds = {v[0] for v in values}
    if kinds <= {"p", "n"}:
        for v in values:
            if v not in PROPERTY_PAIR_VALUES:
                raise ValueError(f"property/local value {v}")
        i, j = local_pairs(sim, gmask,
                           skin=any(v.startswith("n") for v in values))[:2]
        ty = sim.sys.type
        cols = {"atom1": i + 1.0, "atom2": j + 1.0,
                "type1": ty[i].double(), "type2": ty[j].double()}
        return [cols[v[1:]].double() for v in values]
    if kinds <= {"b"}:
        bonds = np.asarray(script._bonds, np.int64)
        btyp = np.asarray(script._bond_types, np.int64)
        gm = np.asarray(gmask)[:sim.natoms]
        keep = gm[bonds[:, 0] - 1] & gm[bonds[:, 1] - 1] & (btyp != 0)
        cols = {"batom1": bonds[keep, 0], "batom2": bonds[keep, 1],
                "btype": btyp[keep]}
        out = []
        for v in values:
            if v not in cols:
                raise ValueError(f"property/local value {v}")
            out.append(cols[v].astype(float))
        return out
    raise ValueError(
        "property/local: mixed pair/bond value kinds in one compute")


def _min_image(d, L):
    return d - np.round(d / L) * L


def _geometry(sim):
    """Host positions of the real atoms and a minimum-image function over
    the periodic dims (lidp_tpu/io/dump.py _angle_geometry)."""
    sys = sim.sys
    x = _np(sys.x, sim.natoms)
    L = sys.box.lengths.double().cpu().numpy()

    def mi(d):
        for dim in range(3):
            if sys.box.periodic[dim]:
                d[:, dim] = _min_image(d[:, dim], L[dim])
        return d

    return x, mi


def bond_local_rows(sim, script, gmask, values):
    """compute bond/local (compute_bond_local.cpp): dist, engpot, force
    per bond with both atoms in the group, bond styles harmonic and fene
    as the JAX function forms them."""
    style = script.bond_style
    if style not in ("harmonic", "fene"):
        raise NotImplementedError(
            f"compute bond/local under bond_style {style}: the JAX package "
            "evaluates every style but harmonic as fene (ROADMAP queue 3 "
            "item 47)")
    bonds = np.asarray(script._bonds, np.int64) - 1
    btyp = np.asarray(script._bond_types, np.int64)
    x, mi = _geometry(sim)
    gm = np.asarray(gmask)[:sim.natoms]
    keep = gm[bonds[:, 0]] & gm[bonds[:, 1]]
    bonds, btyp = bonds[keep], btyp[keep]
    d = mi(x[bonds[:, 0]] - x[bonds[:, 1]])
    r = np.sqrt(np.sum(d * d, axis=-1))
    co = script.bond_coeffs
    k = np.array([co[int(t)][0] for t in btyp])
    if style == "harmonic":
        r0 = np.array([co[int(t)][1] for t in btyp])
        dr = r - r0
        epot = k * dr * dr
        fbond = -2.0 * k * dr / np.where(r > 0, r, 1.0)
    else:   # fene (bond_fene.cpp)
        R0 = np.array([co[int(t)][1] for t in btyp])
        eps = np.array([co[int(t)][2] for t in btyp])
        sig = np.array([co[int(t)][3] for t in btyp])
        if np.any(eps != 1.0):
            raise NotImplementedError(
                "compute bond/local under bond_style fene with epsilon != 1: "
                "the JAX package drops epsilon from the WCA term (ROADMAP "
                "queue 3 item 47)")
        rlogarg = 1.0 - (r / R0) ** 2
        epot = -0.5 * k * R0 * R0 * np.log(rlogarg)
        sr6 = (sig / np.where(r > 0, r, 1.0)) ** 6
        inside = r < sig * 2.0 ** (1.0 / 6.0)
        epot = epot + np.where(inside, 4.0 * (sr6 * sr6 - sr6) + 1.0, 0.0)
        fbond = -k / rlogarg + np.where(
            inside, 24.0 * (2.0 * sr6 * sr6 - sr6) / (r * r), 0.0)
    cols = {"dist": r, "engpot": epot, "force": fbond * r}
    out = []
    for v in values:
        if v not in cols:
            raise ValueError(f"bond/local value {v}")
        out.append(cols[v])
    return out


def angle_local_rows(sim, script, gmask, values):
    """compute angle/local (compute_angle_local.cpp): theta (degrees) and
    eng per angle with all three atoms in the group."""
    angles = np.asarray(script._angles, np.int64) - 1
    atyp = np.asarray(script._angle_types, np.int64)
    x, mi = _geometry(sim)
    gm = np.asarray(gmask)[:sim.natoms]
    keep = gm[angles[:, 0]] & gm[angles[:, 1]] & gm[angles[:, 2]]
    angles, atyp = angles[keep], atyp[keep]
    d1 = mi(x[angles[:, 0]] - x[angles[:, 1]])
    d2 = mi(x[angles[:, 2]] - x[angles[:, 1]])
    c = (d1 * d2).sum(1) / (np.linalg.norm(d1, axis=1)
                            * np.linalg.norm(d2, axis=1))
    theta = np.arccos(np.clip(c, -1.0, 1.0))
    out = []
    for v in values:
        if v == "theta":
            out.append(np.rad2deg(theta))
        elif v == "eng":
            co = script.angle_coeffs
            k = np.array([co[int(t)][0] for t in atyp])
            style = script.angle_style
            if style in ("harmonic", "charmm"):
                t0 = np.deg2rad([co[int(t)][1] for t in atyp])
                e = k * (theta - t0) ** 2
                if style == "charmm":
                    kub = np.array([co[int(t)][2] for t in atyp])
                    rub = np.array([co[int(t)][3] for t in atyp])
                    r13 = np.linalg.norm(d2 - d1, axis=1)
                    e = e + kub * (r13 - rub) ** 2
            elif style == "cosine":
                e = k * (1.0 + np.cos(theta))
            elif style == "cosine/squared":
                t0 = np.deg2rad([co[int(t)][1] for t in atyp])
                e = k * (np.cos(theta) - np.cos(t0)) ** 2
            else:
                raise ValueError(f"angle/local eng unsupported for {style}")
            out.append(e)
        else:
            raise ValueError(f"angle/local value {v}")
    return out


def _torsion_rows(sim, script, gmask, values, quads, word):
    """dihedral/local phi and improper/local chi (compute_*_local.cpp):
    the torsion angle in degrees of each quad in the group."""
    quads = np.asarray(quads, np.int64) - 1
    gm = np.asarray(gmask)[:sim.natoms]
    quads = quads[gm[quads].all(axis=1)]
    x, mi = _geometry(sim)
    b1 = mi(x[quads[:, 1]] - x[quads[:, 0]])
    b2 = mi(x[quads[:, 2]] - x[quads[:, 1]])
    b3 = mi(x[quads[:, 3]] - x[quads[:, 2]])
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    nn = np.maximum(np.linalg.norm(n1, axis=1)
                    * np.linalg.norm(n2, axis=1), 1e-30)
    cphi = np.clip((n1 * n2).sum(1) / nn, -1.0, 1.0)
    sphi = (np.cross(n1, n2) * b2).sum(1) / (
        nn * np.linalg.norm(b2, axis=1))
    phi = np.rad2deg(np.arctan2(sphi, cphi))
    for v in values:
        if v != word:
            raise ValueError(f"{'dihedral' if word == 'phi' else 'improper'}"
                             f"/local value {v}")
    return [phi for _ in values]


def rigid_local_rows(sim, values):
    """compute rigid/local (compute_rigid_local.cpp:61-96, pack columns
    :150-260): one row per rigid body of the run's rigid integrator.  id
    and mol are the body's lowest atom tag and its molecule id (the
    reference packs those of the rank-local owning atom)."""
    from lidp_tpu_torch.integrate.rigid import q_to_matrix

    integ = getattr(sim.runner, "integ", None)
    p = getattr(integ, "params", None)
    st = sim.istate
    if not hasattr(p, "nbody") or not hasattr(st, "xcm"):
        raise ValueError("compute rigid/local requires a rigid fix")
    for v in values:
        if v not in RIGID_LOCAL_VALUES:
            raise ValueError(f"rigid/local value {v}")

    def h(t):
        return t.double().cpu().numpy()

    nb = p.nbody
    body = p.body.cpu().numpy()
    xcm, vcm, fcm = h(st.xcm)[:nb], h(st.vcm)[:nb], h(st.fcm)[:nb]
    tq, L, quat = h(st.torque)[:nb], h(st.angmom)[:nb], h(st.quat)[:nb]
    inertia = h(p.inertia)[:nb]
    R = h(q_to_matrix(st.quat))[:nb]
    mbody = np.einsum("bij,bi->bj", R, L)
    wbody = np.where(inertia > 0.0,
                     mbody / np.where(inertia > 0.0, inertia, 1.0), 0.0)
    omega = np.einsum("bij,bj->bi", R, wbody)
    lo = h(sim.sys.box.lo)
    lens = h(sim.sys.box.hi) - lo
    img = np.floor((xcm - lo) / lens).astype(int)
    xwrap = xcm - img * lens
    first = np.full(nb, -1, int)
    for i in range(len(body) - 1, -1, -1):
        if 0 <= body[i] < nb:
            first[body[i]] = i
    mol = getattr(sim.script, "mol", None)
    cols = {"id": first + 1.0,
            "mol": (np.asarray(mol, float)[first] if mol is not None
                    else first + 1.0),
            "mass": h(p.masstotal)[:nb]}
    for d, ax in enumerate("xyz"):
        cols[ax] = xwrap[:, d]
        cols[ax + "u"] = xcm[:, d]
        cols["i" + ax] = img[:, d].astype(float)
        cols["v" + ax] = vcm[:, d]
        cols["f" + ax] = fcm[:, d]
        cols["tq" + ax] = tq[:, d]
        cols["omega" + ax] = omega[:, d]
        cols["angmom" + ax] = L[:, d]
        cols["inertia" + ax] = inertia[:, d]
    for k, d in zip("wijk", range(4)):
        cols["quat" + k] = quat[:, d]
    return [cols[v] for v in values]


def local_rows(sim, script, cid):
    """The columns of local compute `cid` at the current state: tensors on
    the device (pair/local, property/local's pair columns) or host
    arrays."""
    grp, style, vals = script.computes[cid]
    gm = script.groups[grp]
    if style == "pair/local":
        return pair_local_rows(sim, gm, vals)
    if style == "property/local":
        return property_local_rows(sim, script, gm, vals)
    if style == "bond/local":
        return bond_local_rows(sim, script, gm, vals)
    if style == "angle/local":
        return angle_local_rows(sim, script, gm, vals)
    if style == "dihedral/local":
        return _torsion_rows(sim, script, gm, vals, script._dihedrals, "phi")
    if style == "improper/local":
        return _torsion_rows(sim, script, gm, vals, script._impropers, "chi")
    if style == "rigid/local":
        return rigid_local_rows(sim, vals["values"])
    raise ValueError(f"dump local needs a local compute, got {style}")


def write_local_frame(spec, sim, script):
    """dump local (dump_local.cpp): per-entry rows of the local computes'
    columns (`index`, `c_ID`, `c_ID[n]` tokens; the ENTRIES header echoes
    them), values `%.8g` as the JAX writer prints them.  The rows are
    formed on the device and read in one transfer; each frame's (device
    ms, format ms, rows) is appended to spec.timings."""
    t0 = time.perf_counter()
    cache = {}
    cols = []
    for tok in spec.columns:
        if tok == "index":
            cols.append(("index", None))
            continue
        cid, idx = (tok[2:].rstrip("]").split("[") if "[" in tok
                    else (tok[2:], "1"))
        if cid not in cache:
            cache[cid] = local_rows(sim, script, cid)
        cols.append((tok, cache[cid][int(idx) - 1]))
    host = [(t, c.cpu().numpy() if isinstance(c, torch.Tensor) else c)
            for t, c in cols]
    lens = {len(c) for _, c in host if c is not None}
    if len(lens) > 1:
        raise ValueError(f"dump {spec.did}: local columns of different "
                         f"lengths {sorted(lens)}")
    nrows = lens.pop() if lens else 0
    t1 = time.perf_counter()
    flat = np.empty((nrows, len(host)), object)
    fmt = []
    for k, (_, c) in enumerate(host):
        if c is None:
            flat[:, k] = range(1, nrows + 1)
            fmt.append("%d")
        else:
            flat[:, k] = np.asarray(c, np.float64).tolist()
            fmt.append("%.8g")
    row_fmt = " ".join(fmt) + "\n"
    sys = sim.sys
    lo = sys.box.lo.double().cpu().numpy()
    hi = sys.box.hi.double().cpu().numpy()
    with _open(spec) as fh:
        fh.write("ITEM: TIMESTEP\n%d\n" % int(sys.step))
        fh.write("ITEM: NUMBER OF ENTRIES\n%d\n" % nrows)
        bflags = " ".join("pp" if p else "ff" for p in sys.box.periodic)
        fh.write(f"ITEM: BOX BOUNDS {bflags}\n")
        for dd in range(3):
            fh.write(f"{lo[dd]:.16e} {hi[dd]:.16e}\n")
        fh.write("ITEM: ENTRIES %s\n" % " ".join(t for t, _ in host))
        if nrows:
            fh.write((row_fmt * nrows) % tuple(flat.ravel().tolist()))
    t2 = time.perf_counter()
    spec.timings = getattr(spec, "timings", []) + [
        (1e3 * (t1 - t0), 1e3 * (t2 - t1), nrows)]


# default dump_image type palette (dump_image.cpp default color cycle)
_IMAGE_COLORS = np.array([
    [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 0.0], [0.0, 1.0, 1.0],
    [1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.65, 0.0],
])
# the keywords the rasterizer reads, and their value counts
IMAGE_KEYWORDS = {"size": 2, "zoom": 1, "adiam": 1, "view": 2}


def write_image_frame(spec, sys, script, gmask, path=None):
    """dump image (dump_image.cpp re-imagined small, as the JAX package
    draws it): an orthographic software rasterizer, atoms as depth-sorted
    diffuse-shaded spheres colored by type, written as binary PPM (the
    reference's -DLAMMPS_JPEG fallback format) to `path` (spec.path with
    `*` replaced by the step by default).  Keywords: size, zoom, adiam,
    view."""
    kw = {"size": (512, 512), "zoom": 1.0, "adiam": None,
          "view": (60.0, 30.0)}
    toks = list(spec.columns[2:])   # after the color/diameter attrs
    i = 0
    while i < len(toks):
        if toks[i] == "size":
            kw["size"] = (int(toks[i + 1]), int(toks[i + 2]))
        elif toks[i] == "zoom":
            kw["zoom"] = float(toks[i + 1])
        elif toks[i] == "adiam":
            kw["adiam"] = float(toks[i + 1])
        elif toks[i] == "view":
            kw["view"] = (float(toks[i + 1]), float(toks[i + 2]))
        i += 1 + IMAGE_KEYWORDS[toks[i]]
    W, H = kw["size"]

    n = _nreal(sys)
    sel = np.asarray(gmask)[:n]
    x = _np(sys.x, n)[sel]
    ty = sys.type[:n].cpu().numpy()[sel]
    x, lo, hi, L = _wrapped(sys, x)

    th, ph = np.radians(kw["view"][0]), np.radians(kw["view"][1])
    # camera basis: right/up/depth from polar theta, azimuth phi
    dirv = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)])
    up0 = np.array([0.0, 0.0, 1.0]) if abs(dirv[2]) < 0.99 \
        else np.array([0.0, 1.0, 0.0])
    right = np.cross(up0, dirv)
    right /= np.linalg.norm(right)
    up = np.cross(dirv, right)
    ctr = 0.5 * (lo + hi)
    rel = x - ctr
    u = rel @ right
    v = rel @ up
    w = rel @ dirv
    ext = max(float(np.max(np.abs(L))) * 0.75, 1e-6)
    scale = min(W, H) / (2.0 * ext) * kw["zoom"]
    diam = (kw["adiam"] if kw["adiam"] is not None
            else 0.5 * float(np.min(L)) / max(len(x) ** (1.0 / 3.0), 1.0))
    rad_px = np.full(len(x), max(0.5 * diam * scale, 1.0))

    img = np.zeros((H, W, 3), np.float64)
    zbuf = np.full((H, W), -np.inf)
    px = (W / 2.0 + u * scale)
    py = (H / 2.0 - v * scale)
    light = np.array([-0.4, 0.4, 0.8])
    light /= np.linalg.norm(light)
    for k in np.argsort(w):           # back-to-front (painter + zbuffer)
        r = rad_px[k]
        x0, x1 = int(max(px[k] - r, 0)), int(min(px[k] + r + 1, W))
        y0, y1 = int(max(py[k] - r, 0)), int(min(py[k] + r + 1, H))
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        dx = (xx - px[k]) / r
        dy = (yy - py[k]) / r
        d2 = dx * dx + dy * dy
        inside = d2 <= 1.0
        nz = np.sqrt(np.clip(1.0 - d2, 0.0, 1.0))
        zhere = w[k] + nz
        shade = np.clip(-dx * light[0] + dy * light[1] + nz * light[2],
                        0.15, 1.0)
        color = _IMAGE_COLORS[(int(ty[k]) - 1) % len(_IMAGE_COLORS)]
        m = inside & (zhere > zbuf[y0:y1, x0:x1])
        for c in range(3):
            ch = img[y0:y1, x0:x1, c]
            ch[m] = color[c] * shade[m]
        zbuf[y0:y1, x0:x1][m] = zhere[m]
    path = path or spec.path.replace("*", str(int(sys.step)))
    with open(path, "wb") as fh:
        fh.write(b"P6\n%d %d\n255\n" % (W, H))
        fh.write((img * 255.0 + 0.5).astype(np.uint8).tobytes())


def write_movie_frame(spec, sys, script, gmask):
    """dump movie (dump_movie.cpp pipes frames to ffmpeg): numbered PPM
    frames `path.NNNNNN.ppm` beside the target, as the JAX package writes
    them (it assembles none)."""
    k = getattr(spec, "_movie_frame", 0)
    spec._movie_frame = k + 1
    write_image_frame(spec, sys, script, gmask,
                      path=f"{spec.path}.{k:06d}.ppm")


def read_dump_frames(path):
    """Parse a native text dump (the dump_custom.cpp format;
    reader_native.cpp analog) into a list of frames
    ``(step, lo, hi, colnames, data[n, ncol])``.  A triclinic frame
    (BOX BOUNDS xy xz yz) raises: the port has no tilted box."""
    frames = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("ITEM: TIMESTEP"):
            i += 1
            continue
        step = int(lines[i + 1])
        i += 2
        if not lines[i].startswith("ITEM: NUMBER OF ATOMS"):
            raise ValueError("malformed dump: expected NUMBER OF ATOMS")
        n = int(lines[i + 1])
        i += 2
        hdr = lines[i]
        if not hdr.startswith("ITEM: BOX BOUNDS"):
            raise ValueError("malformed dump: expected BOX BOUNDS")
        if " xy " in hdr + " " or "xy xz yz" in hdr:
            raise NotImplementedError(
                f"read_dump of a triclinic frame (step {step} of "
                f"{os.path.basename(path)}) is not ported ({_TRICLINIC})")
        lo = np.zeros(3)
        hi = np.zeros(3)
        for d in range(3):
            t = lines[i + 1 + d].split()
            lo[d], hi[d] = float(t[0]), float(t[1])
        i += 4
        cols = lines[i].split()[2:]
        data = np.asarray(
            [[float(v) for v in lines[i + 1 + k].split()]
             for k in range(n)])
        i += 1 + n
        frames.append((step, lo, hi, cols, data))
    return frames
