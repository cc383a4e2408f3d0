"""Builders for the MOLECULE-package bonded style families
(lidp_tpu/styles/bonded_builders.py).

Translates the parsed script state (bond/angle/dihedral/improper style and
the per-type coefficient lists) into ops.bonded params, in the coeff orders
of the reference's bond_*.cpp / angle_*.cpp / dihedral_*.cpp /
improper_*.cpp ::coeff methods.  A `hybrid` style (bond_hybrid.cpp etc.)
is decomposed here: each sub-style gets its own params with the term list
filtered to its types, and the caller sums the contributions.  The tables
are built in numpy, float64, as the JAX package builds them, then moved to
the run's dtype and device.

Every builder returns a tuple of params (empty if there are no terms).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def read_lammps_table(path, keyword):
    """Parse one section of a LAMMPS bond/angle table file
    (bond_table.cpp::read_table): the `keyword` line, the `N <n> ...`
    line, then `index x energy force` rows."""
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln and not ln.startswith("#") and ln.split()[0] == keyword:
            break
        i += 1
    else:
        raise ValueError(f"keyword {keyword} not found in {path}")
    params = lines[i + 1].split()
    if params[0] != "N":
        raise ValueError(f"table {keyword}: expected N line")
    n = int(params[1])
    rows = []
    j = i + 2
    while len(rows) < n and j < len(lines):
        ln = lines[j].strip()
        j += 1
        if not ln or ln.startswith("#"):
            continue
        rows.append([float(v) for v in ln.split()[1:4]])
    if len(rows) != n:
        raise ValueError(f"table {keyword}: expected {n} rows")
    arr = np.array(rows)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def _uniform_resample(xf, ef, ff, m=None):
    """A uniform grid passes through verbatim (linear lookups then match
    the reference bit for bit); a non-uniform one is linearly resampled
    onto max(4*len, 2048) points (the reference spline-resamples,
    bond_table.cpp compute_table)."""
    dx = np.diff(xf)
    if m is None and np.allclose(dx, dx[0], rtol=1e-9, atol=0.0):
        return np.asarray(xf), np.asarray(ef), np.asarray(ff)
    m = m or max(4 * len(xf), 2048)
    xs = np.linspace(xf[0], xf[-1], m)
    return xs, np.interp(xs, xf, ef), np.interp(xs, xf, ff)


def _partition_hybrid(style, style_args, coeffs):
    """hybrid: coeff lines are `type sub-style args...`.  Returns
    [(sub_style, {type: args}), ...] in the style_args order."""
    subs = list(style_args)
    if len(set(subs)) != len(subs):
        raise NotImplementedError(
            f"{style} hybrid with duplicate sub-styles")
    per = {s: {} for s in subs}
    for t, co in coeffs.items():
        if not co or not isinstance(co[0], str):
            raise ValueError(
                f"{style} hybrid coeff for type {t} must name a sub-style")
        sname = co[0]
        if sname == "none":
            continue
        if sname not in per:
            raise ValueError(f"{style} hybrid: unknown sub-style {sname}")
        per[sname][t] = co[1:]
    return [(s, per[s]) for s in subs if per[s]]


def _to(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _idx(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _tables(coeffs, root, T, rescale):
    """The per-type uniform tables of a table style: (te, tf, lo, step)
    (T+1, M), (T+1, M), (T+1,), (T+1,); `rescale` maps the file's (x, e, f)
    to the table's units."""
    tabs = {}
    for t, co in coeffs.items():
        xf, ef, ff = read_lammps_table(os.path.join(root, str(co[0])),
                                       str(co[1]))
        tabs[t] = _uniform_resample(*rescale(xf, ef, ff))
    m = max(len(tb[0]) for tb in tabs.values())
    te, tf = np.zeros((T + 1, m)), np.zeros((T + 1, m))
    lo, step = np.zeros(T + 1), np.ones(T + 1)
    for t, (xs, es, fs) in tabs.items():
        if len(xs) != m:
            xs, es, fs = _uniform_resample(xs, es, fs, m)
        te[t], tf[t] = es, fs
        lo[t] = xs[0]
        step[t] = xs[1] - xs[0]
    return te, tf, lo, step


# --------------------------------- bonds -----------------------------------

_BOND_NCOEFF = {"harmonic": 2, "fene": 4, "fene/expand": 5, "morse": 3,
                "nonlinear": 3, "gromos": 2, "quartic": 5, "zero": 0}


def _bond_params_one(style, coeffs, bidx, btyp, TB, dtype, device, script,
                     pair_tables, root):
    """One BondParams for one (sub-)style over the given bond subset."""
    from lidp_tpu_torch.ops.bonded import BondParams

    c = np.zeros((5, TB + 1))
    extra = {}
    if style == "table":
        # bond_coeff type file keyword (bond_table.cpp::coeff)
        te, tf, lo, step = _tables(coeffs, root, TB,
                                   lambda x, e, f: (x, e, f))
        extra = dict(tab_e=_to(te, dtype, device),
                     tab_f=_to(tf, dtype, device),
                     tab_rlo=_to(lo, dtype, device),
                     tab_dr=_to(step, dtype, device))
    else:
        need = _BOND_NCOEFF[style]
        for bt, co in coeffs.items():
            vals = [float(v) for v in co[:need]]
            if len(vals) != need:
                raise ValueError(
                    f"bond_style {style} needs {need} coeffs, got {co}")
            for ci, v in enumerate(vals):
                c[ci, bt] = v
    if style == "quartic" and pair_tables is not None:
        # subtract the lj/cut pair single of intact bonds
        # (bond_quartic.cpp pair->single block, special_bonds 1 1 1)
        eps, sig, cut = pair_tables
        s6 = sig ** 6
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(cut > 0, (sig / np.where(cut > 0, cut, 1.0))
                             ** 6, 0.0)
        off = (4.0 * eps * (ratio * ratio - ratio)
               if getattr(script, "_pair_shift", False)
               else np.zeros_like(eps))
        extra.update(
            plj1=_to(48.0 * eps * s6 * s6, dtype, device),
            plj2=_to(24.0 * eps * s6, dtype, device),
            plj3=_to(4.0 * eps * s6 * s6, dtype, device),
            plj4=_to(4.0 * eps * s6, dtype, device),
            pcutsq=_to(cut * cut, dtype, device),
            poffset=_to(off, dtype, device),
            ptype=_idx(script.type, device))
    return BondParams(
        idx=_idx(bidx, device), btype=_idx(btyp, device),
        k=_to(c[0], dtype, device), r0=_to(c[1], dtype, device),
        eps=_to(c[2], dtype, device), sigma=_to(c[3], dtype, device),
        c5=_to(c[4], dtype, device), style=style, **extra)


def build_bond_params(script, dtype, bond_keep=None, pair_tables=None,
                      device="cpu"):
    """Tuple of BondParams (one per hybrid sub-style; one otherwise);
    bond_keep masks out the bonds fix shake constrains."""
    bidx = script._bonds - 1
    btyp = np.asarray(script._bond_types if script._bond_types is not None
                      else np.ones(len(script._bonds)))
    # delete_bonds turns interactions off by negating the type
    # (delete_bonds.cpp:173); type 0 rows hit the zeroed coeff slot
    btyp = np.maximum(btyp, 0)
    if bond_keep is not None:
        bidx, btyp = bidx[bond_keep], btyp[bond_keep]
    if not len(bidx):
        return ()
    TB = max(script.bond_coeffs.keys(), default=0)
    root = getattr(script, "root", ".")
    if script.bond_style == "hybrid":
        out = []
        for sname, coeffs in _partition_hybrid(
                "bond", script.bond_style_args, script.bond_coeffs):
            sel = np.isin(btyp, list(coeffs.keys()))
            if sel.any():
                out.append(_bond_params_one(
                    sname, coeffs, bidx[sel], btyp[sel], TB, dtype, device,
                    script, pair_tables, root))
        return tuple(out)
    return (_bond_params_one(
        script.bond_style, script.bond_coeffs, bidx, btyp, TB, dtype, device,
        script, pair_tables, root),)


# --------------------------------- angles ----------------------------------

def _angle_params_one(style, coeffs, aidx, atyp, TA, dtype, device, root):
    from lidp_tpu_torch.ops.bonded import AngleParams

    ka, th0 = np.zeros(TA + 1), np.zeros(TA + 1)
    c3, c4 = np.zeros(TA + 1), np.zeros(TA + 1)
    kw = {}
    if style == "table":
        # angle_table.cpp:242: theta deg -> rad, f to energy/radian
        te, tf, lo, step = _tables(
            coeffs, root, TA,
            lambda x, e, f: (np.deg2rad(x), e, f * 180.0 / np.pi))
        kw = dict(tab_e=_to(te, dtype, device), tab_f=_to(tf, dtype, device),
                  tab_tlo=_to(lo, dtype, device),
                  tab_dt=_to(step, dtype, device))
    else:
        for at, co in coeffs.items():
            if style == "zero":
                continue
            vals = [float(v) for v in co]
            ka[at] = vals[0]
            if style in ("harmonic", "charmm", "cosine/squared",
                         "cosine/delta"):
                th0[at] = np.deg2rad(vals[1])
            if style == "charmm":
                c3[at], c4[at] = vals[2], vals[3]
            if style == "cosine/periodic":
                # C B n -> k = C/n^2 (angle_cosine_periodic.cpp::coeff)
                b, n_ = vals[1], vals[2]
                ka[at] = vals[0] / (n_ * n_)
                c3[at], c4[at] = b, n_
    if style in ("charmm", "cosine/periodic"):
        kw = dict(k_ub=_to(c3, dtype, device), r_ub=_to(c4, dtype, device))
    return AngleParams(
        idx=_idx(aidx, device), atype=_idx(atyp, device),
        k=_to(ka, dtype, device), theta0=_to(th0, dtype, device),
        style=style, **kw)


def build_angle_params(script, dtype, angle_keep=None, device="cpu"):
    aidx = script._angles - 1
    atyp = np.maximum(np.asarray(script._angle_types), 0)
    if angle_keep is not None:
        aidx, atyp = aidx[angle_keep], atyp[angle_keep]
    if not len(aidx):
        return ()
    TA = max(script.angle_coeffs.keys(), default=0)
    root = getattr(script, "root", ".")
    if script.angle_style == "hybrid":
        out = []
        for sname, coeffs in _partition_hybrid(
                "angle", script.angle_style_args, script.angle_coeffs):
            sel = np.isin(atyp, list(coeffs.keys()))
            if sel.any():
                out.append(_angle_params_one(
                    sname, coeffs, aidx[sel], atyp[sel], TA, dtype, device,
                    root))
        return tuple(out)
    return (_angle_params_one(
        script.angle_style, script.angle_coeffs, aidx, atyp, TA, dtype,
        device, root),)


# -------------------------------- dihedrals --------------------------------

def charmm_14_tables(script, eps, sig):
    """The charmm dihedral's 1-4 energy tables (lj14_3, lj14_4) (T+1,T+1):
    per-type eps14/sig14 from the four-argument pair_coeff (else the pair
    tables' diagonal), mixed as the pair tables (eps geometric, sigma
    arithmetic), explicit i != j pairs kept (dihedral_charmm.cpp
    init_style's pair extract)."""
    T14 = script.ntypes
    e14_t = np.array([eps[t, t] for t in range(T14 + 1)])
    s14_t = np.array([sig[t, t] for t in range(T14 + 1)])
    coeffs14 = getattr(script, "pair_coeffs14", {})
    for (i14, j14), (e14, s14) in coeffs14.items():
        if i14 == j14:
            e14_t[i14], s14_t[i14] = e14, s14
    eps14 = np.sqrt(np.outer(e14_t, e14_t))
    sig14 = 0.5 * (s14_t[:, None] + s14_t[None, :])
    for (i14, j14), (e14, s14) in coeffs14.items():
        eps14[i14, j14] = eps14[j14, i14] = e14
        sig14[i14, j14] = sig14[j14, i14] = s14
    s6 = sig14 ** 6
    return 4.0 * eps14 * s6 * s6, 4.0 * eps14 * s6


def _dihedral_params_one(style, coeffs, didx, dtyp, TD, dtype, device,
                         script, u, eps, sig):
    from lidp_tpu_torch.ops.bonded import DihedralParams

    cs = np.zeros((5, TD + 1))
    for dt_, co in coeffs.items():
        if style == "zero":
            continue
        for ci, val in enumerate([float(v) for v in co[:5]]):
            cs[ci, dt_] = val
    extra = {}
    if style in ("charmm", "charmmfsw"):
        # K n d(deg) weight; the weighted 1-4 pair term needs q, the types
        # and the pair style's 1-4 tables (dihedral_charmm.cpp::coeff +
        # init_style)
        cs[2] = np.deg2rad(cs[2])
        lj14_3, lj14_4 = charmm_14_tables(script, eps, sig)
        extra = dict(q=_to(script.q, dtype, device),
                     lj14_3=_to(lj14_3, dtype, device),
                     lj14_4=_to(lj14_4, dtype, device),
                     type_=_idx(script.type, device), qqrd2e=u.qqr2e)
        if style == "charmmfsw":
            # dihedral_charmmfsw.cpp init_style: the cutoffs of the paired
            # pair style, and dihedflag 0 under coul/charmmfsh (its
            # shifted 1-4 coulomb), else 1
            p = script.pair
            extra.update(cut_lj_inner14=float(p.cut_lj_inner),
                         cut_lj14=float(p.cut_lj_global),
                         cut_coul14=float(p.cut_coul or p.cut_lj_global),
                         dihedflag=0 if "charmmfsh" in p.name else 1)
    return DihedralParams(
        idx=_idx(didx, device), dtype_=_idx(dtyp, device),
        c1=_to(cs[0], dtype, device), c2=_to(cs[1], dtype, device),
        c3=_to(cs[2], dtype, device), c4=_to(cs[3], dtype, device),
        c5=_to(cs[4], dtype, device), style=style, **extra)


def build_dihedral_params(script, dtype, u, eps, sig, device="cpu"):
    """eps, sig: the pair style's mixed (T+1,T+1) tables, for charmm's 1-4
    term."""
    didx = script._dihedrals - 1
    dtyp = np.maximum(np.asarray(script._dihedral_types), 0)
    if not len(didx):
        return ()
    TD = max(script.dihedral_coeffs.keys(), default=0)
    if script.dihedral_style == "hybrid":
        out = []
        for sname, coeffs in _partition_hybrid(
                "dihedral", script.dihedral_style_args,
                script.dihedral_coeffs):
            sel = np.isin(dtyp, list(coeffs.keys()))
            if sel.any():
                out.append(_dihedral_params_one(
                    sname, coeffs, didx[sel], dtyp[sel], TD, dtype, device,
                    script, u, eps, sig))
        return tuple(out)
    return (_dihedral_params_one(
        script.dihedral_style, script.dihedral_coeffs, didx, dtyp, TD, dtype,
        device, script, u, eps, sig),)


# -------------------------------- impropers --------------------------------

def _improper_params_one(style, coeffs, iidx, ityp, TI, dtype, device):
    from lidp_tpu_torch.ops.bonded import ImproperParams

    ki, chi0 = np.zeros(TI + 1), np.zeros(TI + 1)
    c2, c3 = np.zeros(TI + 1), np.zeros(TI + 1)
    for it_, co in coeffs.items():
        if style == "zero":
            continue
        vals = [float(v) for v in co]
        ki[it_] = vals[0]
        if style == "harmonic":
            chi0[it_] = np.deg2rad(vals[1])
        elif style == "cvff":
            c2[it_], c3[it_] = vals[1], vals[2]    # d(+-1), n
        elif style == "umbrella":
            w0 = np.deg2rad(vals[1])
            chi0[it_] = w0
            # improper_umbrella.cpp::coeff C = K/sin^2(w0)
            c2[it_] = ki[it_] / np.sin(w0) ** 2 if w0 != 0.0 else 0.0
    return ImproperParams(
        idx=_idx(iidx, device), itype=_idx(ityp, device),
        k=_to(ki, dtype, device), chi0=_to(chi0, dtype, device),
        c2=_to(c2, dtype, device), c3=_to(c3, dtype, device), style=style)


def build_improper_params(script, dtype, device="cpu"):
    iidx = script._impropers - 1
    ityp = np.maximum(np.asarray(script._improper_types), 0)
    if not len(iidx):
        return ()
    TI = max(script.improper_coeffs.keys(), default=0)
    if script.improper_style == "hybrid":
        out = []
        for sname, coeffs in _partition_hybrid(
                "improper", script.improper_style_args,
                script.improper_coeffs):
            sel = np.isin(ityp, list(coeffs.keys()))
            if sel.any():
                out.append(_improper_params_one(
                    sname, coeffs, iidx[sel], ityp[sel], TI, dtype, device))
        return tuple(out)
    return (_improper_params_one(
        script.improper_style, script.improper_coeffs, iidx, ityp, TI,
        dtype, device),)
