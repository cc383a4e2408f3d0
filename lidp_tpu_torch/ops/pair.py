"""LJ + real-space Ewald pair parameters and the dense all-pairs pass
(lidp_tpu/ops/pair.py, the lj/cut, lj/cut/coul/long and lj/charmm/coul/long
and lj/charmm/coul/charmm parts: the CHARMM energy switch of the LJ term
between the inner and outer cutoffs, pair_lj_charmm_coul_long.cpp:110-125,
and the switched coulomb of coul/charmm, pair_lj_charmm_coul_charmm.cpp:
123-130; the long-range dispersion kinds lj/long and buck/long, the
g6-damped r^-6 complement of the ewald/disp and pppm/disp dispersion sums,
pair_lj_long_coul_long.cpp:520-533 and pair_buck_long_coul_long.cpp; and
the msm coulomb, the gamma-softened complement of the MSM grid,
pair_coul_msm.cpp:115-117).

The erfc of the real-space coulomb term is the reference's 5-term
Abramowitz-Stegun polynomial (pair_lj_cut_coul_long_polarization.cpp:43-49),
not `torch.special.erfc`, so the port matches the JAX package and the
reference bit-close.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# Abramowitz & Stegun 7.1.26 erfc approximation, constants identical to the
# reference (pair_lj_cut_coul_long_polarization.cpp:43-49).
EWALD_F = 1.12837917
EWALD_P = 0.3275911
A1 = 0.254829592
A2 = -0.284496736
A3 = 1.421413741
A4 = -1.453152027
A5 = 1.061405429


def erfc_as(grij, expm2):
    """A&S erfc(g r) given g r and exp(-(g r)^2)."""
    t = 1.0 / (1.0 + EWALD_P * grij)
    return t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * expm2


@dataclasses.dataclass(frozen=True)
class PairParams:
    """Type-pair tables, index [type_i, type_j], row/col 0 unused (LAMMPS
    1-based).  lj3 = 4 eps sigma^12, lj4 = 4 eps sigma^6 (the force
    coefficients 12*lj3 and 6*lj4 are formed where used), offset = energy
    shift at cutoff.  Scalars are Python floats: they are fixed per build
    and ride into the kernels as launch arguments."""

    lj3: torch.Tensor
    lj4: torch.Tensor
    offset: torch.Tensor
    cut_ljsq: torch.Tensor     # (T+1,T+1)
    cutsq: torch.Tensor        # (T+1,T+1) max(cut_lj, cut_coul)^2
    special_lj: torch.Tensor   # (4,) [1.0, s12, s13, s14]
    special_coul: torch.Tensor
    cut_coulsq: float
    qqrd2e: float
    g_ewald: float
    coul: bool = True
    # neigh_modify exclude molecule all: same-molecule pairs take no pair
    # term (read by dense_pair_forces and cell_pair_forces with mol=; the
    # panel engine refuses it)
    excl_mol: bool = False
    # neigh_modify exclude type I J: (T+1,T+1) bool, the excluded type
    # pairs take no pair term (neighbor.cpp exclusion lists); None for none
    excl: Optional[torch.Tensor] = None
    # CHARMM energy switching of the LJ term between the inner and outer
    # cutoffs (lj/charmm/*): the inner cutoff^2 and (cut_lj^2 -
    # cut_lj_inner^2)^3 of the largest LJ cutoff
    charmm: bool = False
    cut_lj_innersq: float = 0.0
    denom_lj: float = 1.0
    # the coulomb form: "long" (erfc-damped; g_ewald 0 gives the plain 1/r)
    # or "charmm" (lj/charmm/coul/charmm: 1/r scaled by the switch between
    # the inner and outer coulomb cutoffs, the special factor
    # multiplicative)
    coul_kind: str = "long"
    cut_coul_innersq: float = 0.0
    denom_coul: float = 1.0
    # the van der Waals form: "lj" (lj3, lj4 as above), "lj/long" (the
    # same tables; the r^-6 term g6-damped, its k-space part in the
    # dispersion sum, lj4 = B_i B_j under geometric mixing) or "buck/long"
    # (lj3 = A, lj4 = C and rhoinv = 1/rho: A exp(-r/rho) in full and the
    # g6-damped C r^-6 complement)
    kind: str = "lj"
    g6: float = 1.0          # the global g_ewald_6 of the long kinds
    rhoinv: Optional[torch.Tensor] = None   # (T+1,T+1), buck/long only
    msm_order: int = 10      # the MSM interpolation order, coul_kind msm


LONG_KINDS = ("lj/long", "buck/long")


def make_pair_params(epsilon, sigma, cut_lj, *, cut_coul=0.0, qqrd2e=1.0,
                     g_ewald=0.0, coul=True, shift=False,
                     special_lj=(1.0, 0.0, 0.0, 0.0),
                     special_coul=(1.0, 0.0, 0.0, 0.0), excl_types=None,
                     cut_lj_inner=0.0, charmm=False, coul_kind="long",
                     cut_coul_inner=0.0, msm_order=10, dtype=torch.float64,
                     device="cpu"):
    """PairParams of lj/cut/coul/long (coul=True) or lj/cut alone
    (coul=False: cutsq = cut_lj^2, no coulomb term) from per-type-pair
    (T+1,T+1) epsilon/sigma/cut arrays.  special_lj / special_coul: the
    special_bonds factors [1, s12, s13, s14], by default LAMMPS's (0 for
    LJ and coulomb).  shift=True fills the offset table with the LJ energy
    at the cutoff (pair_modify shift yes).  excl_types: the (T+1,T+1) bool
    table of neigh_modify exclude type, or None.  charmm=True switches the
    LJ term between cut_lj_inner and the outer cutoff; coul_kind "charmm"
    the coulomb term between cut_coul_inner and cut_coul; coul_kind "msm"
    the MSM complement of order msm_order.  The same tables as lidp_tpu
    make_pair_params."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    epsilon, sigma, cut_lj = t(epsilon), t(sigma), t(cut_lj)
    s6 = sigma**6
    if shift:
        live = cut_lj > 0
        ratio6 = torch.where(
            live, (sigma / torch.where(live, cut_lj, 1.0)) ** 6, 0.0)
        offset = 4.0 * epsilon * (ratio6**2 - ratio6)
    else:
        offset = torch.zeros_like(epsilon)
    if coul_kind not in ("long", "charmm", "msm"):
        raise NotImplementedError(
            f"coul_kind {coul_kind} is not ported (ROADMAP queue 1 item "
            "6.9, the other pair styles)")
    ccsq, cisq = float(cut_coul) ** 2, float(cut_coul_inner) ** 2
    return PairParams(
        lj3=4.0 * epsilon * s6 * s6, lj4=4.0 * epsilon * s6,
        offset=offset, cut_ljsq=cut_lj**2,
        cutsq=torch.clamp(cut_lj, min=cut_coul if coul else 0.0) ** 2,
        special_lj=t(list(special_lj)),
        special_coul=t(list(special_coul)),
        cut_coulsq=float(cut_coul) ** 2, qqrd2e=float(qqrd2e),
        g_ewald=float(g_ewald), coul=bool(coul),
        excl=(None if excl_types is None else torch.as_tensor(
            excl_types, dtype=torch.bool, device=device)),
        charmm=bool(charmm), cut_lj_innersq=float(cut_lj_inner) ** 2,
        denom_lj=((float(cut_lj.max()) ** 2 - float(cut_lj_inner) ** 2) ** 3
                  if charmm else 1.0),
        coul_kind=coul_kind if coul else "long",
        cut_coul_innersq=cisq if coul and coul_kind == "charmm" else 0.0,
        denom_coul=((ccsq - cisq) ** 3 if coul and coul_kind == "charmm"
                    and ccsq > cisq else 1.0),
        msm_order=int(msm_order))


def make_long_pair_params(kind, t_rep, t_disp, cut_lj, *, rhoinv=None,
                          g6=1.0, cut_coul=0.0, qqrd2e=1.0, g_ewald=0.0,
                          coul=True, special_lj=(1.0, 0.0, 0.0, 0.0),
                          special_coul=(1.0, 0.0, 0.0, 0.0),
                          excl_types=None, dtype=torch.float64,
                          device="cpu"):
    """PairParams of the long-range dispersion kinds (lidp_tpu
    make_generic_pair_params for "lj/long" and "buck/long", the offset
    zero as there): kind "lj/long" with t_rep = 4 eps sigma^12 and t_disp
    = 4 eps sigma^6; kind "buck/long" with t_rep = A, t_disp = C and
    rhoinv = 1/rho; all (T+1,T+1).  g6 is the global g_ewald_6 the
    k-space setup fixes."""
    if kind not in LONG_KINDS:
        raise ValueError(kind)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    cut_lj = t(cut_lj)
    return PairParams(
        lj3=t(t_rep), lj4=t(t_disp), offset=torch.zeros_like(cut_lj),
        cut_ljsq=cut_lj**2,
        cutsq=torch.clamp(cut_lj, min=cut_coul if coul else 0.0) ** 2,
        special_lj=t(list(special_lj)), special_coul=t(list(special_coul)),
        cut_coulsq=float(cut_coul) ** 2, qqrd2e=float(qqrd2e),
        g_ewald=float(g_ewald), coul=bool(coul),
        excl=(None if excl_types is None else torch.as_tensor(
            excl_types, dtype=torch.bool, device=device)),
        kind=kind, g6=float(g6),
        rhoinv=None if rhoinv is None else t(rhoinv))


def plain_vdw(p: PairParams, rsq, r2inv, lj3, lj4, rhoinv=None):
    """(forcelj, philj) of the bare van der Waals form, forcelj the
    LAMMPS force * r: lj/cut for "lj" and "lj/long", buck for
    "buck/long"."""
    r6inv = r2inv * r2inv * r2inv
    if p.kind == "buck/long":
        r = torch.sqrt(rsq)
        rexp = torch.exp(-r * rhoinv)
        return (lj3 * rhoinv) * r * rexp - 6.0 * lj4 * r6inv, \
            lj3 * rexp - lj4 * r6inv
    return r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4), r6inv * (lj3 * r6inv
                                                              - lj4)


def long_vdw(p: PairParams, rsq, r2inv, lj3, lj4, rhoinv=None):
    """(forcelj, philj) of the long kinds at full weight (lidp_tpu
    _vdw_terms "lj/long", pair_lj_long_coul_long.cpp:520-533, and
    "buck/long", pair_buck_long_coul_long.cpp's order6 series branch):
    the repulsion in full, the r^-6 term less its g6-damped k-space
    part."""
    g2 = p.g6 * p.g6
    x2v = g2 * rsq
    a2 = 1.0 / x2v
    x2e = a2 * torch.exp(-x2v) * lj4
    g6c = g2 * g2 * g2
    g8c = g6c * g2
    damp_f = g8c * (((6.0 * a2 + 6.0) * a2 + 3.0) * a2 + 1.0) * x2e * rsq
    damp_e = g6c * ((a2 + 1.0) * a2 + 0.5) * x2e
    if p.kind == "buck/long":
        r = torch.sqrt(rsq)
        rexp = torch.exp(-r * rhoinv)
        return (lj3 * rhoinv) * r * rexp - damp_f, lj3 * rexp - damp_e
    rn = r2inv * r2inv * r2inv
    return rn * rn * (12.0 * lj3) - damp_f, rn * rn * lj3 - damp_e


def msm_coul(prefactor, r, rsq, cut_coulsq: float, order: int):
    """(ecoul, forcecoul) of the MSM complement, egamma = 1 - rho
    gamma(rho), fgamma = 1 + rho^2 dgamma(rho), rho = r / r_c
    (pair_coul_msm.cpp:115-117; lidp_tpu _msm_coul_terms), inside the
    coulomb cutoff."""
    from lidp_tpu_torch.ops.msm import DGCONS, GCONS

    s = order // 2
    rho = r / math.sqrt(cut_coulsq)
    rho2 = rho * rho
    g = GCONS[s][0]
    rn = rho2
    for nn in range(1, s + 1):
        g = g + GCONS[s][nn] * rn
        rn = rn * rho2
    dg = DGCONS[s][0] * rho
    rn = rho * rho2
    for nn in range(1, s):
        dg = dg + DGCONS[s][nn] * rn
        rn = rn * rho2
    return prefactor * (1.0 - rho * g), \
        prefactor * (1.0 + (rsq / cut_coulsq) * dg)


def charmm_switch(p: PairParams, cut_ljsq, rsq, forcelj, philj):
    """The CHARMM energy switch of the LJ term between the inner and outer
    cutoffs (pair_lj_charmm_coul_long.cpp:110-125): (forcelj, philj)
    switched beyond the inner cutoff."""
    switch1 = ((cut_ljsq - rsq) ** 2
               * (cut_ljsq + 2.0 * rsq - 3.0 * p.cut_lj_innersq)
               / p.denom_lj)
    switch2 = (12.0 * rsq * (cut_ljsq - rsq)
               * (rsq - p.cut_lj_innersq) / p.denom_lj)
    outer = rsq > p.cut_lj_innersq
    return (torch.where(outer, forcelj * switch1 + philj * switch2, forcelj),
            torch.where(outer, philj * switch1, philj))


def charmm_coul(p: PairParams, prefactor, rsq, factor_coul):
    """(ecoul, forcecoul) of coul/charmm (pair_lj_charmm_coul_charmm.cpp:
    123-130): the force and the energy both scaled by switch1 beyond the
    inner coulomb cutoff (the reference's own convention), the special
    factor multiplicative."""
    ccsq = p.cut_coulsq
    sw1 = ((ccsq - rsq) ** 2 * (ccsq + 2.0 * rsq - 3.0 * p.cut_coul_innersq)
           / p.denom_coul)
    fac = torch.where(rsq > p.cut_coul_innersq, sw1, 1.0)
    e = prefactor * fac * factor_coul
    return e, e


def _coul_terms(p: PairParams, prefactor, r, rsq, factor_coul):
    """(ecoul, forcecoul) of the coulomb kinds at a pair's special
    factor: coul/charmm's switch (the factor multiplicative), the msm
    complement or the erfc form (g_ewald 0: the exact 1/r of coul/cut),
    the last two less (1 - factor) prefactor, the kspace-present
    convention."""
    if p.coul_kind == "charmm":
        return charmm_coul(p, prefactor, rsq, factor_coul)
    if p.coul_kind == "msm":
        ec, fc = msm_coul(prefactor, r, rsq, p.cut_coulsq, p.msm_order)
    else:
        grij = p.g_ewald * r
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_as(grij, expm2) if p.g_ewald > 0 else 1.0
        ec = prefactor * erfc
        fc = prefactor * (erfc + EWALD_F * grij * expm2)
    return (ec - (1.0 - factor_coul) * prefactor,
            fc - (1.0 - factor_coul) * prefactor)


def _tab(t, ti, tj):
    return None if t is None else t[ti, tj]


def pair_single(rsq, itype, jtype, qi, qj, p: PairParams, factor_coul=1.0,
                factor_lj=1.0):
    """Pair::single (lidp_tpu/ops/pair.py pair_single): (eng, fforce) of one
    pair at distance^2 rsq (tensors broadcast), fforce the force/r factor;
    the CHARMM switches as in _pair_terms.  The long dispersion kinds
    take factor_lj on their whole term here, as the JAX function does (not
    _pair_terms' special algebra: ROADMAP queue 3)."""
    rsq = torch.as_tensor(rsq, dtype=p.lj3.dtype, device=p.lj3.device)
    r2inv = 1.0 / rsq
    forcecoul = phicoul = torch.zeros_like(rsq)
    if p.coul:
        r = torch.sqrt(rsq)
        prefactor = p.qqrd2e * qi * qj / r
        phicoul, forcecoul = _coul_terms(p, prefactor, r, rsq, factor_coul)
        incoul = rsq < p.cut_coulsq
        forcecoul = torch.where(incoul, forcecoul, 0.0)
        phicoul = torch.where(incoul, phicoul, 0.0)
    lj3, lj4 = p.lj3[itype, jtype], p.lj4[itype, jtype]
    cut_ljsq = p.cut_ljsq[itype, jtype]
    if p.kind in LONG_KINDS:
        forcelj, philj_raw = long_vdw(p, rsq, r2inv, lj3, lj4,
                                      _tab(p.rhoinv, itype, jtype))
    else:
        forcelj, philj_raw = plain_vdw(p, rsq, r2inv, lj3, lj4)
    philj = philj_raw - p.offset[itype, jtype]
    if p.charmm:
        # the JAX function switches the unshifted energy
        forcelj, switched = charmm_switch(p, cut_ljsq, rsq, forcelj,
                                          philj_raw)
        philj = torch.where(rsq > p.cut_lj_innersq, switched, philj)
    inlj = rsq < cut_ljsq
    forcelj = torch.where(inlj, forcelj, 0.0)
    philj = torch.where(inlj, philj, 0.0)
    return (phicoul + factor_lj * philj,
            (forcecoul + factor_lj * forcelj) * r2inv)


def _pair_terms(rsq, qi, qj, ti, tj, sp_code, p: PairParams, pair_mask):
    """Per-pair van der Waals + coulomb force factor (F = fpair * d) and
    energies (lidp_tpu/ops/pair.py _pair_terms, its lj, lj/long and
    buck/long kinds with the CHARMM switch and the erfc, coul/charmm and
    msm coulomb).  The long kinds take the reference's special algebra,
    terms(f) = terms(1) - (1 - f) plain terms, their energy not scaled by
    f (pair_lj_long_coul_long.cpp:529-533): the k-space sum runs over
    every pair.  Shapes broadcast; rsq must be masked nonzero.  g_ewald
    == 0 is the exact coul/cut form (erfc = 1)."""
    r2inv = 1.0 / rsq
    factor_lj = p.special_lj[sp_code]
    in_range = (rsq < p.cutsq[ti, tj]) & pair_mask
    if p.excl is not None:
        in_range = in_range & ~p.excl[ti, tj]
    cut_ljsq = p.cut_ljsq[ti, tj]
    lj_mask = in_range & (rsq < cut_ljsq)

    lj3, lj4 = p.lj3[ti, tj], p.lj4[ti, tj]
    if p.kind in LONG_KINDS:
        rhoinv = _tab(p.rhoinv, ti, tj)
        forcelj, philj = long_vdw(p, rsq, r2inv, lj3, lj4, rhoinv)
        f0, e0 = plain_vdw(p, rsq, r2inv, lj3, lj4, rhoinv)
        forcelj = forcelj - (1.0 - factor_lj) * f0
        evdwl = philj - (1.0 - factor_lj) * e0 - p.offset[ti, tj]
    else:
        forcelj, philj = plain_vdw(p, rsq, r2inv, lj3, lj4)
        if p.charmm:
            forcelj, philj = charmm_switch(p, cut_ljsq, rsq, forcelj, philj)
        evdwl = (philj - p.offset[ti, tj]) * factor_lj
        forcelj = forcelj * factor_lj
    forcelj = torch.where(lj_mask, forcelj, 0.0)
    evdwl = torch.where(lj_mask, evdwl, 0.0)

    if p.coul:
        factor_coul = p.special_coul[sp_code]
        coul_mask = in_range & (rsq < p.cut_coulsq)
        r = torch.sqrt(rsq)
        prefactor = p.qqrd2e * qi * qj / r
        ecoul, forcecoul = _coul_terms(p, prefactor, r, rsq, factor_coul)
        forcecoul = torch.where(coul_mask, forcecoul, 0.0)
        ecoul = torch.where(coul_mask, ecoul, 0.0)
    else:
        forcecoul = torch.zeros_like(forcelj)
        ecoul = torch.zeros_like(evdwl)
    return (forcecoul + forcelj) * r2inv, evdwl, ecoul


def dense_pair_forces(x, q, type_, sp_code, mask, box, p: PairParams,
                      mol=None):
    """All-pairs (N,N) evaluation (lidp_tpu/ops/pair.py dense_pair_forces).
    sp_code: the (N,N) special-bond codes of topology.special_codes_dense
    (a tensor) or 0.  Returns (f, evdwl, ecoul, virial6), the virial in
    the order xx yy zz xy xz yz, energies and virial half-sums over the
    ordered pairs."""
    from lidp_tpu_torch.box import minimum_image

    n = x.shape[0]
    delta = minimum_image(x[:, None, :] - x[None, :, :], box.img_lengths)
    rsq = torch.sum(delta * delta, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    pair_mask = (~eye) & mask[:, None] & mask[None, :]
    if p.excl_mol and mol is not None:
        pair_mask = pair_mask & (mol[:, None] != mol[None, :])
    rsq = torch.where(pair_mask, rsq, 1.0)
    if isinstance(sp_code, torch.Tensor):
        sp_code = sp_code.long()
    ti, tj = type_.long()[:, None], type_.long()[None, :]
    fpair, evdwl, ecoul = _pair_terms(rsq, q[:, None], q[None, :], ti, tj,
                                      sp_code, p, pair_mask)
    f = torch.sum(fpair[:, :, None] * delta, dim=1)
    w = 0.5 * fpair
    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    virial = torch.stack([
        torch.sum(w * dx * dx), torch.sum(w * dy * dy),
        torch.sum(w * dz * dz), torch.sum(w * dx * dy),
        torch.sum(w * dx * dz), torch.sum(w * dy * dz)])
    return f, 0.5 * torch.sum(evdwl), 0.5 * torch.sum(ecoul), virial
