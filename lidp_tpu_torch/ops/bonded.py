"""Bonded interactions (lidp_tpu/ops/bonded.py): the MOLECULE-package
bond, angle, dihedral and improper style families as gather/scatter tensor
ops over the term lists, the CHARMM dihedral's weighted 1-4 pair term, and
the special-bond correction of the list-free pair passes.

Bond styles (bond_*.cpp): harmonic, fene, fene/expand, morse, nonlinear,
gromos, quartic (with the intact mask and the pair-single subtraction),
table, zero.  Angle styles (angle_*.cpp): harmonic, charmm (Urey-Bradley),
cosine, cosine/squared, cosine/delta, cosine/periodic, table, zero.
Dihedral styles: opls, harmonic, charmm (+ the weighted 1-4 term),
charmmfsw's 1-4 form, multi/harmonic, helix, zero.  Improper styles:
harmonic, cvff, umbrella, zero.  A hybrid style is one params object per
sub-style (styles/bonded_builders.py), summed by the caller.

The JAX package takes the angle, dihedral and improper forces from
jax.grad of each term's energy and the virial from a strain derivative.
Here every style but the umbrella improper has its closed form: the angle
styles through dE/dcos(theta) (the reference's a11/a12/a22 form,
angle_harmonic.cpp), the dihedral and improper styles through dE/dphi and
the gradient of the signed dihedral angle (Blondel & Karplus, J. Comput.
Chem. 17, 1132 (1996)), the 1-4 and Urey-Bradley terms as pair forces.  The
umbrella improper takes torch.autograd.grad of its energy on local leaves
(its three bond vectors) under torch.enable_grad().  Each term's virial is
the sum of d (x) f over its bond vectors, which equals the strain
derivative.  Forces are scattered with index_add_ (float atomics on the
GPU: the last bits differ between runs).

The special-bond correction: a pair pass that takes no special codes (the
cell grid at full weight, the panel kernels with the special pairs' LJ term
left out) is corrected over the O(N*S) pairs of the special lists: the LJ
term to factor_lj times its full (unswitched, as in the JAX package) value,
the coulomb term by the kspace-present convention forcecoul -= (1 -
factor_coul) * prefactor (pair_lj_cut_coul_long.cpp compute()).

Plain PyTorch, as XLA runs it in the JAX package: no kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from lidp_tpu_torch.box import minimum_image


def _mi(d, box):
    return minimum_image(d, box.img_lengths)


def _scatter(x, pairs):
    """f (N,3) of (atom index (M,), force (M,3)) pairs, by index_add_."""
    f = torch.zeros_like(x)
    for idx, fv in pairs:
        f.index_add_(0, idx, fv)
    return f


def _vir6(pairs):
    """Virial xx yy zz xy xz yz = sum d (x) f over (d (M,3), f (M,3))."""
    w = sum(d[:, :, None] * fv[:, None, :] for d, fv in pairs)
    w = w.sum(0)
    return torch.stack([w[0, 0], w[1, 1], w[2, 2], w[0, 1], w[0, 2],
                        w[1, 2]])


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


# ---------------------------------- bonds ----------------------------------

@dataclasses.dataclass(frozen=True)
class BondParams:
    """The JAX BondParams: idx (NB,2) 0-based atom indices, btype (NB,)
    1-based types, per-type tables (T+1,), row 0 unused.  By style (the
    bond_coeff order of bond_*.cpp::coeff):
      harmonic:    k=K         r0=r0
      fene:        k=K         r0=R0     eps=eps  sigma=sigma
      fene/expand: k=K         r0=R0     eps=eps  sigma=sigma  c5=delta
      morse:       k=D0        r0=alpha  eps=r0
      nonlinear:   k=epsilon   r0=r0     eps=lamda
      gromos:      k=K         r0=r0
      quartic:     k=K         r0=B1     eps=B2   sigma=Rc     c5=U0
    table: per-type energy/force tables on a uniform grid from tab_rlo in
    steps of tab_dr.  quartic's pair subtraction: the lj/cut tables
    plj1..4, pcutsq, poffset (T_atom+1)^2 and the atom types ptype."""

    idx: torch.Tensor
    btype: torch.Tensor
    k: torch.Tensor
    r0: torch.Tensor
    eps: torch.Tensor
    sigma: torch.Tensor
    c5: Optional[torch.Tensor] = None
    tab_e: Optional[torch.Tensor] = None
    tab_f: Optional[torch.Tensor] = None
    tab_rlo: Optional[torch.Tensor] = None
    tab_dr: Optional[torch.Tensor] = None
    plj1: Optional[torch.Tensor] = None
    plj2: Optional[torch.Tensor] = None
    plj3: Optional[torch.Tensor] = None
    plj4: Optional[torch.Tensor] = None
    pcutsq: Optional[torch.Tensor] = None
    poffset: Optional[torch.Tensor] = None
    ptype: Optional[torch.Tensor] = None
    style: str = "harmonic"


def _where_pos(r):
    return torch.where(r > 0, r, 1.0)


def bond_forces(x, box, p: BondParams):
    """(f (N,3), ebond, virial6) of one bond style (quartic: its bond part
    and pair subtraction together, as the JAX function returns them)."""
    i, j = p.idx[:, 0], p.idx[:, 1]
    d = _mi(x[i] - x[j], box)
    rsq = _dot(d, d)
    t = p.btype
    k, r0 = p.k[t], p.r0[t]
    st = p.style
    if st == "harmonic":
        r = torch.sqrt(rsq)
        dr = r - r0
        fbond = torch.where(r > 0, -2.0 * k * dr / _where_pos(r), 0.0)
        ebond = torch.sum(k * dr * dr)
    elif st in ("fene", "fene/expand"):
        # bond_fene.cpp:60-95 / bond_fene_expand.cpp (r -> r - shift)
        r = torch.sqrt(rsq)
        rs = r - p.c5[t] if st == "fene/expand" else r
        rssq = rs * rs
        r0sq = r0 * r0
        # the reference warns and clamps at 0.1
        rlogarg = torch.clamp(1.0 - rssq / r0sq, min=0.1)
        rsafe = _where_pos(r)
        fbond = (-k / rlogarg if st == "fene"
                 else -k * rs / rlogarg / rsafe)
        ebond = -0.5 * torch.sum(k * r0sq * torch.log(rlogarg))
        eps, sig = p.eps[t], p.sigma[t]
        rssq_safe = torch.where(rssq > 0, rssq, 1.0)
        sr2 = sig * sig / rssq_safe
        sr6 = sr2 * sr2 * sr2
        inside = rssq < math.pow(2.0, 1.0 / 3.0) * sig * sig
        if st == "fene":
            flj = 48.0 * eps * sr6 * (sr6 - 0.5) / rssq_safe
        else:
            # bond_fene_expand.cpp:100: the LJ force along d is /rshift/r
            flj = (48.0 * eps * sr6 * (sr6 - 0.5)
                   / torch.where(rs != 0, rs, 1.0) / rsafe)
        fbond = fbond + torch.where(inside, flj, 0.0)
        ebond = ebond + torch.sum(torch.where(
            inside, 4.0 * eps * sr6 * (sr6 - 1.0) + eps, 0.0))
    elif st == "morse":
        # bond_morse.cpp: E = D0 (1 - e^{-alpha (r - r0)})^2
        d0, alpha, rr0 = k, r0, p.eps[t]
        r = torch.sqrt(rsq)
        ralpha = torch.exp(-alpha * (r - rr0))
        fbond = torch.where(
            r > 0, -2.0 * d0 * alpha * (1 - ralpha) * ralpha / _where_pos(r),
            0.0)
        ebond = torch.sum(d0 * (1 - ralpha) ** 2)
    elif st == "nonlinear":
        # bond_nonlinear.cpp: E = eps dr^2 / (lamda^2 - dr^2)
        epsb, lam = k, p.eps[t]
        r = torch.sqrt(rsq)
        dr = r - r0
        lamsq = lam * lam
        denom = lamsq - dr * dr
        fbond = -epsb / _where_pos(r) * 2.0 * dr * lamsq / (denom * denom)
        ebond = torch.sum(epsb * dr * dr / denom)
    elif st == "gromos":
        # bond_gromos.cpp: E = K (r^2 - r0^2)^2
        dr = rsq - r0 * r0
        fbond = -4.0 * k * dr
        ebond = torch.sum(k * dr * dr)
    elif st == "table":
        # linear interpolation on the per-type resampled grid
        r = torch.sqrt(rsq)
        m = p.tab_e.shape[1]
        s = torch.clamp((r - p.tab_rlo[t]) / p.tab_dr[t], 0.0, m - 1 - 1e-7)
        i0 = s.long()
        frac = s - i0
        e0, e1 = p.tab_e[t, i0], p.tab_e[t, i0 + 1]
        f0, f1 = p.tab_f[t, i0], p.tab_f[t, i0 + 1]
        fbond = (f0 + frac * (f1 - f0)) / _where_pos(r)   # -dE/dr / r
        ebond = torch.sum(e0 + frac * (e1 - e0))
    elif st == "zero":
        fbond = torch.zeros_like(rsq)
        ebond = x.new_zeros(())
    elif st == "quartic":
        # the JAX function's first three: the force with the pair
        # subtraction, the virial without it
        return _bond_quartic(x, d, rsq, p)[:3]
    else:
        raise ValueError(st)
    fvec = fbond[:, None] * d
    return (_scatter(x, ((i, fvec), (j, -fvec))), ebond,
            _vir6(((d, fvec),)))


def _bond_quartic(x, d, rsq, p: BondParams):
    """bond_quartic.cpp: E = K dr^2 (dr - B1)(dr - B2) + U0 + LJ(1,1)
    inside 2^(1/6), dr = r - Rc; a bond stretched past Rc is broken (masked
    out).  The lj/cut pair interaction of each intact bonded pair is
    subtracted, tallied into the pair accumulators by the caller.  Returns
    (f, ebond, virial6, devdwl, dvirial6)."""
    i, j = p.idx[:, 0], p.idx[:, 1]
    t = p.btype
    k, b1, b2, rc, u0 = p.k[t], p.r0[t], p.eps[t], p.sigma[t], p.c5[t]
    intact = rsq < rc * rc
    r = torch.sqrt(rsq)
    dr = r - rc
    r2 = dr * dr
    ra, rb = dr - b1, dr - b2
    fbond = -k / _where_pos(r) * (r2 * (ra + rb) + 2.0 * dr * ra * rb)
    ebond = k * r2 * ra * rb + u0
    sr2 = 1.0 / torch.where(rsq > 0, rsq, 1.0)
    sr6 = sr2 * sr2 * sr2
    inside = rsq < math.pow(2.0, 1.0 / 3.0)
    fbond = fbond + torch.where(inside, 48.0 * sr6 * (sr6 - 0.5) * sr2, 0.0)
    ebond = ebond + torch.where(inside, 4.0 * sr6 * (sr6 - 1.0) + 1.0, 0.0)
    fbond = torch.where(intact, fbond, 0.0)
    ebond = torch.sum(torch.where(intact, ebond, 0.0))
    devd = x.new_zeros(())
    dfp = torch.zeros_like(fbond)
    if p.plj1 is not None:
        ti, tj = p.ptype[i], p.ptype[j]
        in_cut = intact & (rsq < p.pcutsq[ti, tj])
        fp = sr6 * (p.plj1[ti, tj] * sr6 - p.plj2[ti, tj]) * sr2
        ep = sr6 * (p.plj3[ti, tj] * sr6 - p.plj4[ti, tj]) - p.poffset[ti, tj]
        dfp = torch.where(in_cut, -fp, 0.0)
        devd = torch.sum(torch.where(in_cut, -ep, 0.0))
    fvec = (fbond + dfp)[:, None] * d
    f = _scatter(x, ((i, fvec), (j, -fvec)))
    return (f, ebond, _vir6(((d, fbond[:, None] * d),)), devd,
            _vir6(((d, dfp[:, None] * d),)))


def bond_quartic_full(x, box, p: BondParams):
    """quartic with the pair subtraction split out for the caller's
    pair-accumulator tally: (f, ebond, vir_bond, devdwl, vir_pair)."""
    i, j = p.idx[:, 0], p.idx[:, 1]
    d = _mi(x[i] - x[j], box)
    return _bond_quartic(x, d, _dot(d, d), p)


# ---------------------------------- angles ---------------------------------

@dataclasses.dataclass(frozen=True)
class AngleParams:
    """The JAX AngleParams: idx (NA,3) i-j-k with j the centre, atype
    (NA,), per-type k and theta0 (radians); charmm's Urey-Bradley K_ub and
    r_ub in k_ub/r_ub; cosine/periodic's C/n^2 in k, B in k_ub, n in r_ub;
    table: per-type tables over theta (radians) on a uniform grid, tab_f
    = -dE/dtheta."""

    idx: torch.Tensor
    atype: torch.Tensor
    k: torch.Tensor
    theta0: torch.Tensor
    k_ub: Optional[torch.Tensor] = None
    r_ub: Optional[torch.Tensor] = None
    tab_e: Optional[torch.Tensor] = None
    tab_f: Optional[torch.Tensor] = None
    tab_tlo: Optional[torch.Tensor] = None
    tab_dt: Optional[torch.Tensor] = None
    style: str = "harmonic"


def _chebyshev(c, m):
    """(T_m(c), T_m'(c)) for the per-term multiplicities m in 1..8 (the
    recurrence of angle_cosine_periodic.cpp)."""
    tn_2, tn_1 = torch.ones_like(c), c
    dn_2, dn_1 = torch.zeros_like(c), torch.ones_like(c)
    tm = torch.where(m == 1, tn_1, 0.0)
    dm = torch.where(m == 1, dn_1, 0.0)
    for n in range(2, 9):
        tn = 2.0 * c * tn_1 - tn_2
        dn = 2.0 * tn_1 + 2.0 * c * dn_1 - dn_2
        tn_2, tn_1, dn_2, dn_1 = tn_1, tn, dn_1, dn
        tm = tm + torch.where(m == n, tn, 0.0)
        dm = dm + torch.where(m == n, dn, 0.0)
    return tm, dm


def _angle_terms(c, d1, d2, p: AngleParams):
    """(energy per term, dE/dcos(theta) per term) of the angle styles
    (angle_*.cpp; the JAX package's _angle_energy), Urey-Bradley apart."""
    t = p.atype
    k = p.k[t]
    st = p.style
    if st == "cosine":
        # angle_cosine.cpp: E = K (1 + cos theta)
        return k * (1.0 + c), k
    if st == "cosine/squared":
        # angle_cosine_squared.cpp: E = K (cos th - cos th0)^2
        dc = c - torch.cos(p.theta0[t])
        return k * dc * dc, 2.0 * k * dc
    if st == "cosine/periodic":
        # angle_cosine_periodic.cpp: E = 2 (C/n^2) [1 - B (-1)^n cos(n th)]
        # with cos(n th) = T_n(cos th)
        b, m = p.k_ub[t], p.r_ub[t]
        tm, dm = _chebyshev(c, m)
        sign = 1.0 - 2.0 * torch.remainder(m, 2.0)
        return 2.0 * k * (1.0 - b * sign * tm), -2.0 * k * b * sign * dm
    if st == "zero":
        z = torch.zeros_like(c)
        return z, z
    theta = torch.acos(c)
    dtheta_dc = -1.0 / torch.sqrt(1.0 - c * c)
    if st == "cosine/delta":
        # angle_cosine_delta.cpp: E = K (1 - cos(th - th0))
        u = theta - p.theta0[t]
        return k * (1.0 - torch.cos(u)), k * torch.sin(u) * dtheta_dc
    if st in ("harmonic", "charmm"):
        u = theta - p.theta0[t]
        return k * u * u, 2.0 * k * u * dtheta_dc
    raise ValueError(st)


def angle_forces(x, box, p: AngleParams):
    """Returns (f, eangle, virial6)."""
    i, j, k = p.idx[:, 0], p.idx[:, 1], p.idx[:, 2]
    d1 = _mi(x[i] - x[j], box)
    d2 = _mi(x[k] - x[j], box)
    rsq1, rsq2 = _dot(d1, d1), _dot(d2, d2)
    r1, r2 = torch.sqrt(rsq1), torch.sqrt(rsq2)
    c = torch.clamp(_dot(d1, d2) / (r1 * r2), -1.0, 1.0)
    if p.style == "table":
        # angle_table.cpp linear lookup: e and f (= -dE/dtheta) interpolate
        # independently; the force comes from the interpolated f, as in
        # the JAX package (the gradient of the piecewise-linear energy
        # would be a staircase)
        t = p.atype
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-16))
        m = p.tab_e.shape[1]
        sidx = torch.clamp((torch.acos(c) - p.tab_tlo[t]) / p.tab_dt[t],
                           0.0, m - 1 - 1e-7)
        i0 = sidx.long()
        frac = sidx - i0
        e_term = p.tab_e[t, i0] + frac * (p.tab_e[t, i0 + 1]
                                          - p.tab_e[t, i0])
        fmag = p.tab_f[t, i0] + frac * (p.tab_f[t, i0 + 1]
                                        - p.tab_f[t, i0])
        a = fmag / s
    else:
        e_term, a = _angle_terms(c, d1, d2, p)
    # f1 = -dE/dc dc/dd1 (angle_harmonic.cpp's a11, a12, a22)
    a11 = a * c / rsq1
    a12 = -a / (r1 * r2)
    a22 = a * c / rsq2
    f1 = a11[:, None] * d1 + a12[:, None] * d2
    f3 = a22[:, None] * d2 + a12[:, None] * d1
    pairs = [(i, f1), (k, f3), (j, -(f1 + f3))]
    vir = [(d1, f1), (d2, f3)]
    eangle = torch.sum(e_term)
    if p.style == "charmm":
        # Urey-Bradley 1-3 harmonic (angle_charmm.cpp:95-115)
        d13 = d2 - d1
        r13 = torch.sqrt(_dot(d13, d13))
        du = r13 - p.r_ub[p.atype]
        kub = p.k_ub[p.atype]
        fub = (-2.0 * kub * du / r13)[:, None] * d13      # on atom k
        pairs += [(k, fub), (i, -fub)]
        vir.append((d13, fub))
        eangle = eangle + torch.sum(kub * du * du)
    return _scatter(x, pairs), eangle, _vir6(vir)


# ------------------------------ dihedrals ----------------------------------

@dataclasses.dataclass(frozen=True)
class DihedralParams:
    """The JAX DihedralParams: idx (ND,4) i-j-k-l, dtype_ (ND,), per-type
    c1..c5 (opls: K1..K4; harmonic: K, d, n; charmm/charmmfsw: K, n, d
    (radians), weight; multi/harmonic: A1..A5; helix: A, B, C).  The
    charmm 1-4 term: charges q (N,), the eps14/sig14 energy tables lj14_3,
    lj14_4 (T+1,T+1), atom types type_ (N,), qqrd2e; charmmfsw's cutoffs
    and dihedflag (0: the charmmfsh pair's shifted coulomb, 1: 1/r)."""

    idx: torch.Tensor
    dtype_: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor
    c4: torch.Tensor
    c5: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    lj14_3: Optional[torch.Tensor] = None
    lj14_4: Optional[torch.Tensor] = None
    type_: Optional[torch.Tensor] = None
    qqrd2e: float = 0.0
    cut_lj_inner14: float = 0.0
    cut_lj14: float = 0.0
    cut_coul14: float = 0.0
    dihedflag: int = 1
    style: str = "opls"


def _phi_and_grads(b1, b2, b3):
    """The signed dihedral angle of b1 = x_j - x_i, b2 = x_k - x_j, b3 =
    x_l - x_k (the JAX package's atan2 form) and its gradient with respect
    to the four atoms (Blondel & Karplus 1996): (phi, cos phi (clipped),
    sin phi, (g_i, g_j, g_k, g_l))."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    n1sq, n2sq = _dot(n1, n1), _dot(n2, n2)
    nn = torch.clamp(torch.sqrt(n1sq) * torch.sqrt(n2sq), min=1e-30)
    rb2 = torch.sqrt(_dot(b2, b2))
    cphi = torch.clamp(_dot(n1, n2) / nn, -1.0, 1.0)
    sphi = _dot(torch.linalg.cross(n1, n2), b2) / (nn * rb2)
    phi = torch.atan2(sphi, cphi)
    gi = (-rb2 / n1sq)[:, None] * n1
    gl = (rb2 / n2sq)[:, None] * n2
    p1 = (_dot(b1, b2) / (n1sq * rb2))[:, None] * n1
    p3 = (_dot(b3, b2) / (n2sq * rb2))[:, None] * n2
    gj = -gi + p1 + p3
    gk = -gl - p1 - p3
    return phi, cphi, sphi, (gi, gj, gk, gl)


def _dihedral_dE(phi, cphi, sphi, p: DihedralParams):
    """(energy per term, dE/dphi per term) of the dihedral styles (the JAX
    package's _dihedral_energy)."""
    t = p.dtype_
    st = p.style
    if st == "opls":
        # E = 0.5[k1(1+cos p) + k2(1-cos 2p) + k3(1+cos 3p) + k4(1-cos 4p)]
        k1, k2, k3, k4 = p.c1[t], p.c2[t], p.c3[t], p.c4[t]
        e = 0.5 * (k1 * (1 + torch.cos(phi)) + k2 * (1 - torch.cos(2 * phi))
                   + k3 * (1 + torch.cos(3 * phi))
                   + k4 * (1 - torch.cos(4 * phi)))
        de = 0.5 * (-k1 * torch.sin(phi) + 2 * k2 * torch.sin(2 * phi)
                    - 3 * k3 * torch.sin(3 * phi)
                    + 4 * k4 * torch.sin(4 * phi))
        return e, de
    if st == "harmonic":
        # E = K[1 + d cos(n phi)]; c1=K, c2=d, c3=n
        kk, dd, nn = p.c1[t], p.c2[t], p.c3[t]
        return (kk * (1 + dd * torch.cos(nn * phi)),
                -kk * dd * nn * torch.sin(nn * phi))
    if st in ("charmm", "charmmfsw"):
        # E = K[1 + cos(n phi - d)] (dihedral_charmm.cpp)
        kk, nn, dd = p.c1[t], p.c2[t], p.c3[t]
        u = nn * phi - dd
        return kk * (1 + torch.cos(u)), -kk * nn * torch.sin(u)
    if st == "multi/harmonic":
        # dihedral_multi_harmonic.cpp: E = sum_{i=1..5} A_i cos^(i-1) phi
        a1, a2, a3, a4, a5 = p.c1[t], p.c2[t], p.c3[t], p.c4[t], p.c5[t]
        c = cphi
        e = a1 + c * (a2 + c * (a3 + c * (a4 + c * a5)))
        dedc = a2 + c * (2 * a3 + c * (3 * a4 + c * 4 * a5))
        return e, -dedc * sphi
    if st == "helix":
        # dihedral_helix.cpp: E = A(1-cos p) + B(1+cos 3p) + C(1+cos(p+pi/4))
        a, b, c = p.c1[t], p.c2[t], p.c3[t]
        e = (a * (1.0 - cphi) + b * (1.0 + torch.cos(3.0 * phi))
             + c * (1.0 + torch.cos(phi + math.pi / 4.0)))
        de = (a * sphi - 3.0 * b * torch.sin(3.0 * phi)
              - c * torch.sin(phi + math.pi / 4.0))
        return e, de
    if st == "zero":
        z = torch.zeros_like(phi)
        return z, z
    raise ValueError(st)


def _four_body(x, box, idx, dE_of):
    """Forces, energy and virial of a four-body term whose energy depends
    on the signed dihedral angle of idx's atoms: dE_of(phi, cphi, sphi)
    gives (energy per term, dE/dphi per term)."""
    i, j, k, l = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    b1 = _mi(x[j] - x[i], box)
    b2 = _mi(x[k] - x[j], box)
    b3 = _mi(x[l] - x[k], box)
    phi, cphi, sphi, grads = _phi_and_grads(b1, b2, b3)
    e, de = dE_of(phi, cphi, sphi)
    fi, fj, fk, fl = (-de[:, None] * g for g in grads)
    f = _scatter(x, ((i, fi), (j, fj), (k, fk), (l, fl)))
    # positions relative to j: x_i = -b1, x_k = b2, x_l = b2 + b3
    vir = _vir6(((-b1, fi), (b2, fk), (b2 + b3, fl)))
    return f, torch.sum(e), vir


def dihedral_forces(x, box, p: DihedralParams):
    """Returns (f, edihed, virial6) of the torsion term (the charmm 1-4
    term is charmm_14_forces)."""
    return _four_body(x, box, p.idx,
                      lambda phi, c, s: _dihedral_dE(phi, c, s, p))


def _charmm_14_pair(d14, p: DihedralParams):
    """Per-term (evdwl14, ecoul14, fpair) of the weighted 1-4 LJ and
    coulomb between the dihedral's end atoms (dihedral_charmm.cpp:231-268,
    weightflag branch, no cutoff; dihedral_charmmfsw.cpp's offsets and
    shifted coulomb); F on the first atom = fpair * d14."""
    i1, i4 = p.idx[:, 0], p.idx[:, 3]
    w = p.c4[p.dtype_]
    rsq = _dot(d14, d14)
    rinv = 1.0 / torch.sqrt(rsq)
    r2inv = rinv * rinv
    r6inv = r2inv * r2inv * r2inv
    t1, t4 = p.type_[i1], p.type_[i4]
    lj3, lj4 = p.lj14_3[t1, t4], p.lj14_4[t1, t4]
    qq = p.qqrd2e * p.q[i1] * p.q[i4]
    flj = r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4) * r2inv
    if p.style == "charmmfsw":
        c3i = 1.0 / p.cut_lj14 ** 3
        ci3i = 1.0 / p.cut_lj_inner14 ** 3
        elj = (lj3 * (r6inv * r6inv - ci3i * ci3i * c3i * c3i)
               - lj4 * (r6inv - ci3i * c3i))
        if p.dihedflag:
            ecoul = qq * rinv
            fcoul = qq * rinv * r2inv
        else:
            rcinv = 1.0 / p.cut_coul14
            r = rsq * rinv
            ecoul = qq * (rinv + r * rcinv * rcinv - 2.0 * rcinv)
            fcoul = qq * (rinv * r2inv - rinv * rcinv * rcinv)
    else:
        elj = r6inv * (lj3 * r6inv - lj4)
        ecoul = qq * rinv
        fcoul = qq * rinv * r2inv
    return w * elj, w * ecoul, w * (flj + fcoul)


def charmm_14_forces(x, box, p: DihedralParams):
    """The weighted 1-4 pair term of dihedral charmm: (f, evdwl14,
    ecoul14, virial6); the reference tallies the energies into the pair
    accumulators (E_vdwl, E_coul), not into E_dihed."""
    i, l = p.idx[:, 0], p.idx[:, 3]
    d14 = _mi(x[i] - x[l], box)
    ev, ec, fpair = _charmm_14_pair(d14, p)
    fv = fpair[:, None] * d14
    return (_scatter(x, ((i, fv), (l, -fv))), torch.sum(ev), torch.sum(ec),
            _vir6(((d14, fv),)))


# ------------------------------- impropers ---------------------------------

@dataclasses.dataclass(frozen=True)
class ImproperParams:
    """The JAX ImproperParams: idx (NI,4) i-j-k-l, itype (NI,), k and chi0
    (radians).  harmonic: E = K (chi - chi0)^2 with chi the signed i-j-k-l
    dihedral angle, chi - chi0 wrapped into (-pi, pi]; cvff: E = K [1 + d
    cos(n chi)], d in c2, n in c3; umbrella (DREIDING inversion): chi0 =
    w0, c2 = K/sin^2(w0)."""

    idx: torch.Tensor
    itype: torch.Tensor
    k: torch.Tensor
    chi0: torch.Tensor
    c2: Optional[torch.Tensor] = None
    c3: Optional[torch.Tensor] = None
    style: str = "harmonic"


def _umbrella_energy(vb1, vb2, vb3, p: ImproperParams):
    """improper_umbrella.cpp: vb1 = j - i, vb2 = k - i, vb3 = l - i; cos of
    the angle between n = vb1 x vb2 and vb3 is sin(omega), with the
    projhfg sign fix (the JAX package's form)."""
    n1 = torch.linalg.cross(vb1, vb2)
    c = _dot(n1, vb3) / torch.clamp(
        torch.linalg.norm(n1, dim=1) * torch.linalg.norm(vb3, dim=1),
        min=1e-30)
    c = torch.clamp(c, -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-16))
    projhfg = (_dot(vb3, vb1) / torch.linalg.norm(vb1, dim=1)
               + _dot(vb3, vb2) / torch.linalg.norm(vb2, dim=1))
    s = torch.where(projhfg > 0.0, -s, s)
    t = p.itype
    w0, kw, cc = p.chi0[t], p.k[t], p.c2[t]
    dom = s - torch.cos(w0)
    return torch.sum(torch.where(w0 == 0.0, kw * (1.0 - s),
                                 0.5 * cc * dom * dom))


def _umbrella_forces(x, box, p: ImproperParams):
    """The umbrella improper through torch.autograd.grad on its three bond
    vectors as local leaves."""
    i, j, k, l = p.idx[:, 0], p.idx[:, 1], p.idx[:, 2], p.idx[:, 3]
    vecs = [_mi(x[a] - x[i], box).detach() for a in (j, k, l)]
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_(True) for v in vecs]
        e = _umbrella_energy(*leaves, p)
        grads = torch.autograd.grad(e, leaves)
    fj, fk, fl = (-g for g in grads)
    f = _scatter(x, ((j, fj), (k, fk), (l, fl), (i, -(fj + fk + fl))))
    vir = _vir6(tuple(zip(vecs, (fj, fk, fl))))
    return f, e.detach(), vir


def improper_forces(x, box, p: ImproperParams):
    """Returns (f, eimp, virial6)."""
    if p.style == "umbrella":
        return _umbrella_forces(x, box, p)
    t = p.itype

    def dE(chi, cphi, sphi):
        if p.style == "cvff":
            # E = K [1 + d cos(n chi)]
            kk, dd, nn = p.k[t], p.c2[t], p.c3[t]
            return (kk * (1.0 + dd * torch.cos(nn * chi)),
                    -kk * dd * nn * torch.sin(nn * chi))
        if p.style == "zero":
            z = torch.zeros_like(chi)
            return z, z
        if p.style != "harmonic":
            raise ValueError(p.style)
        dchi = chi - p.chi0[t]
        # wrapped into (-pi, pi] like the reference's acos-based branch
        dchi = dchi - 2 * math.pi * torch.round(dchi / (2 * math.pi))
        return p.k[t] * dchi * dchi, 2.0 * p.k[t] * dchi

    return _four_body(x, box, p.idx, dE)


# ------------------------- special-bond correction -------------------------

def special_pair_sums(xr, qr, tr, x, q, type_, sp_idx, sp_lvl, L, tabs,
                      special_lj, special_coul, cut_coulsq, qqrd2e, *,
                      nvalid, lj_counted, row_mask=None):
    """The correction on the rows xr, qr, tr (R atoms) of the special
    lists sp_idx, sp_lvl (R,S) into the columns x, q, type_ (all atoms).

    tabs: the (lj3, lj4, offset, cut_ljsq, cutsq) type tables; a slot is
    live where sp_idx < nvalid.  lj_counted: the factor the main pass gave
    a special pair's LJ term, 1.0 where it took every pair at full weight
    (the cell grid), 0.0 where it left the special pairs out (the panel
    kernels); the correction adds (factor_lj - lj_counted) times the LJ
    term.  row_mask (R,), optional: rows that take no correction.
    Returns (df (R,3), devdwl, decoul, dvir6), energies and virial halved
    (each pair is in both atoms' lists)."""
    jvalid = sp_idx < nvalid
    jc = torch.clamp(sp_idx, max=x.shape[0] - 1).long()
    sdx = minimum_image(xr[:, 0:1] - x[:, 0][jc], L[0])
    sdy = minimum_image(xr[:, 1:2] - x[:, 1][jc], L[1])
    sdz = minimum_image(xr[:, 2:3] - x[:, 2][jc], L[2])
    srsq = torch.where(jvalid, sdx * sdx + sdy * sdy + sdz * sdz, 1.0)
    sr2inv = 1.0 / srsq
    ti, tj = tr.long()[:, None], type_.long()[jc]
    lj3, lj4, off, cut_ljsq, cutsq = (t[ti, tj] for t in tabs)
    flj = special_lj[sp_lvl] - lj_counted
    fcl = special_coul[sp_lvl]
    in_rng = jvalid & (srsq < cutsq)
    if row_mask is not None:
        in_rng = in_rng & row_mask[:, None]
    lj_m = in_rng & (srsq < cut_ljsq)
    r6inv = sr2inv * sr2inv * sr2inv
    forcelj = r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4)
    evdwl_full = r6inv * (lj3 * r6inv - lj4) - off
    dflj = torch.where(lj_m, flj * forcelj, 0.0)
    devd = torch.where(lj_m, flj * evdwl_full, 0.0)
    cm = in_rng & (srsq < cut_coulsq)
    prefac = qqrd2e * qr[:, None] * q[jc] / torch.sqrt(srsq)
    dfc = torch.where(cm, -(1.0 - fcl) * prefac, 0.0)
    fpair_c = (dflj + dfc) * sr2inv
    df = torch.stack([torch.sum(fpair_c * sdx, dim=1),
                      torch.sum(fpair_c * sdy, dim=1),
                      torch.sum(fpair_c * sdz, dim=1)], dim=-1)
    wks = 0.5 * fpair_c
    dvir = torch.stack([
        torch.sum(wks * sdx * sdx), torch.sum(wks * sdy * sdy),
        torch.sum(wks * sdz * sdz), torch.sum(wks * sdx * sdy),
        torch.sum(wks * sdx * sdz), torch.sum(wks * sdy * sdz)])
    return df, 0.5 * torch.sum(devd), 0.5 * torch.sum(dfc), dvir


# the kinds whose special pairs the correction below takes as the dense
# route does (tests/test_torch_pair_generic.py measures the others, ROADMAP
# queue 3 item 34): the LJ form r^-6 (12 lj3 r^-6 - 6 lj4) of lj/cut (and
# lj/long's plain share), nothing of the coulomb-only tables, and a
# coulomb kind that subtracts (1 - f) qq/r
CORRECTED_KINDS = ("lj", "lj/long", "none")
CORRECTED_COUL_KINDS = ("long", "charmm", "msm", "dsf", "wolf")
# the rest of the CHARMM family (ROADMAP queue 3 item 38, measured in the
# same test): the force switch's energy is the plain LJ energy less a
# constant per pair inside the inner cutoff, and the coulomb kinds below
# scale their terms by the factor where the correction subtracts (1 - f)
# qq/r
FSW_COUL_KINDS = ("charmm/implicit", "charmmfsh")


def _charmm_family_gap(p) -> bool:
    """Whether JAX's cell route parts from its dense route on p's special
    pairs (ROADMAP queue 3 item 38): the force switch (charmm_fsw) under
    a special LJ factor other than 1, or a coulomb kind of FSW_COUL_KINDS
    under a special coulomb factor other than 1."""
    def below_one(t):
        return bool((t[1:] != 1.0).any())

    return ((p.charmm_fsw and below_one(p.special_lj))
            or (p.coul and p.coul_kind in FSW_COUL_KINDS
                and below_one(p.special_coul)))


def special_correction_sparse(x, q, type_, sp_idx, sp_lvl, mask, box, p):
    """The correction of a pair pass that took every pair at factor 1.0
    (the cell grid's cell_pair_forces), for the special pairs of sp_idx,
    sp_lvl (N,S) (topology.special_lists, the fill at x.shape[0]); p is
    a PairParams, without coulomb when p.coul is false.  The LJ term is the
    unswitched one under the charmm switch too, as in the JAX package
    (ROADMAP queue 3).  The CHARMM force switch and the charmm/implicit
    and charmmfsh coulomb kinds raise under special factors below 1: the
    JAX function parts from its dense route there (ROADMAP queue 3 item
    38).  The lj/long table takes the same plain LJ share,
    the k-space sum running over every pair, as the JAX function forms it;
    a buck/long table raises: the JAX function forms the LJ share of its
    A, 1/rho and C tables there (ROADMAP queue 3 item 30).  The msm
    coulomb takes (1 - factor) prefactor like the erfc form.  Returns
    (f_corr, devdwl, decoul, dvir6), as the JAX function."""
    if _charmm_family_gap(p):
        raise NotImplementedError(
            "lj/charmmfsw or coul/charmmfsh|charmm/implicit with special "
            "bonds on the cell grid: the JAX package's special correction "
            "takes the plain LJ energy and an unscreened (1 - f) qq/r there, "
            "off its dense route's terms (ROADMAP queue 3 item 38)")
    if p.kind == "buck/long":
        raise NotImplementedError(
            "buck/long/coul/long with special bonds on the cell grid: the "
            "JAX package's special correction takes the LJ form of the "
            "Buckingham tables there (ROADMAP queue 3 item 30)")
    if p.kind not in CORRECTED_KINDS or (
            p.coul and p.coul_kind not in CORRECTED_COUL_KINDS
            + FSW_COUL_KINDS):
        raise NotImplementedError(
            f"pair kind {p.kind} (coulomb {p.coul_kind if p.coul else 'none'}"
            ") with special bonds on the cell grid: the JAX package's "
            "special correction takes the LJ form of the tables and an "
            "unscreened (1 - f) qq/r there, not this kind's terms (ROADMAP "
            "queue 3 item 34)")
    cut_coulsq = p.cut_coulsq if p.coul else 0.0
    return special_pair_sums(
        x, q, type_, x, q, type_, sp_idx, sp_lvl, box.lengths,
        (p.lj3, p.lj4, p.offset, p.cut_ljsq, p.cutsq), p.special_lj,
        p.special_coul, cut_coulsq, p.qqrd2e, nvalid=x.shape[0],
        lj_counted=1.0, row_mask=mask)
