"""Pair parameters and the dense all-pairs pass (lidp_tpu/ops/pair.py):
one van der Waals kind x coulomb kind dispatch.

The van der Waals kinds: lj (lj/cut, with the CHARMM energy switch of the
lj/charmm styles between the inner and outer cutoffs,
pair_lj_charmm_coul_long.cpp:110-125), the long-range dispersion kinds
lj/long and buck/long (the g6-damped r^-6 complement of the ewald/disp and
pppm/disp sums, pair_lj_long_coul_long.cpp:520-533 and
pair_buck_long_coul_long.cpp), the generic kinds of the JAX package's
_vdw_terms (morse, buck, yukawa, gauss, soft, born, lj/expand, mie, lj96,
lj/smooth/linear, lj/smooth, zbl, beck, ufm, lj/cubic, lj/gromacs and none,
each on the JAX package's coefficient tables t1..t5, generic_vdw) and
pair_style table's linear interpolation (table_terms).  The coulomb kinds:
long (erfc-damped; g_ewald 0 is the exact 1/r of coul/cut), charmm
(pair_lj_charmm_coul_charmm.cpp:123-130), charmm/implicit (its 1/r^2
dielectric, pair_lj_charmm_coul_charmm_implicit.cpp:87-94,122-129),
charmmfsh (the CHARMM force-shifted coulomb,
pair_lj_charmmfsw_coul_charmmfsh.cpp:154-184), msm (the gamma-softened
complement of the MSM grid, pair_coul_msm.cpp:115-117), debye (exp(-kappa
r)/r, pair_coul_debye.cpp:87-89), dsf and wolf (pair_coul_dsf.cpp:115-137,
pair_coul_wolf.cpp:117-141, with their self energy) and gromacs
(pair_lj_gromacs_coul_gromacs.cpp:120-130,156-164).  The lj/charmmfsw
styles' CHARMM force switch of the LJ term (charmm_fsw_terms,
pair_lj_charmmfsw_coul_long.cpp:194-242) takes the place of the energy
switch.

The erfc of the real-space coulomb term is the reference's 5-term
Abramowitz-Stegun polynomial (pair_lj_cut_coul_long_polarization.cpp:43-49),
not `torch.special.erfc`, so the port matches the JAX package and the
reference bit-close; coul/wolf takes the exact erfc, as the reference
does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
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
    # CHARMM force switching (lj/charmmfsw/*; with charmm True): switch1
    # on the force, the energy the integrated split 12/6 form
    # (charmm_fsw_terms) in place of the energy switch
    charmm_fsw: bool = False
    # the coulomb form: "long" (erfc-damped; g_ewald 0 gives the plain 1/r)
    # or "charmm" (lj/charmm/coul/charmm: 1/r scaled by the switch between
    # the inner and outer coulomb cutoffs, the special factor
    # multiplicative), "charmm/implicit" (the same switch on 1/r^2) or
    # "charmmfsh" (the force-shifted 1/r of lj/charmmfsw/coul/charmmfsh,
    # the factor multiplicative); the rest in COUL_KINDS
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
    # the generic kinds (GENERIC_KINDS): the JAX package's coefficient
    # tables t1..t5 (generic_vdw's table), lj1 = t1 and lj2 = t2 beside
    # lj3 = t3 and lj4 = t4; lj5 (T+1,T+1) or stacked (T+1,T+1,K)
    lj1: Optional[torch.Tensor] = None
    lj2: Optional[torch.Tensor] = None
    lj5: Optional[torch.Tensor] = None
    # pair_style table: energy and force magnitude (T+1,T+1,NT) on the
    # common linear grid from tab_rlo in steps of tab_dr
    tab_e: Optional[torch.Tensor] = None
    tab_f: Optional[torch.Tensor] = None
    tab_rlo: float = 0.0
    tab_dr: float = 1.0
    # dsf and wolf: the energy and force shifts at the cutoff (alpha
    # rides in g_ewald, as debye's kappa does)
    coul_eshift: float = 0.0
    coul_fshift: float = 0.0
    # gromacs: (a1, b1, -a1/3, -b1/4, sw5, inner cutoff)
    coulsw: Optional[tuple] = None


LONG_KINDS = ("lj/long", "buck/long")
# the kinds generic_vdw computes from the JAX package's tables t1..t5
GENERIC_KINDS = ("morse", "buck", "yukawa", "gauss", "soft", "born",
                 "lj/expand", "mie", "lj96", "lj/smooth/linear", "lj/smooth",
                 "zbl", "beck", "ufm", "lj/cubic", "lj/gromacs", "none")
KINDS = ("lj",) + LONG_KINDS + GENERIC_KINDS + ("table",)
COUL_KINDS = ("long", "charmm", "charmm/implicit", "charmmfsh", "msm",
              "debye", "dsf", "wolf", "gromacs")
# the coulomb kinds switched between an inner and the outer cutoff
SWITCHED_COUL_KINDS = ("charmm", "charmm/implicit")


def make_pair_params(epsilon, sigma, cut_lj, *, cut_coul=0.0, qqrd2e=1.0,
                     g_ewald=0.0, coul=True, shift=False,
                     special_lj=(1.0, 0.0, 0.0, 0.0),
                     special_coul=(1.0, 0.0, 0.0, 0.0), excl_types=None,
                     cut_lj_inner=0.0, charmm=False, coul_kind="long",
                     cut_coul_inner=0.0, msm_order=10, charmm_fsw=False,
                     dtype=torch.float64, device="cpu"):
    """PairParams of lj/cut/coul/long (coul=True) or lj/cut alone
    (coul=False: cutsq = cut_lj^2, no coulomb term) from per-type-pair
    (T+1,T+1) epsilon/sigma/cut arrays.  special_lj / special_coul: the
    special_bonds factors [1, s12, s13, s14], by default LAMMPS's (0 for
    LJ and coulomb).  shift=True fills the offset table with the LJ energy
    at the cutoff (pair_modify shift yes).  excl_types: the (T+1,T+1) bool
    table of neigh_modify exclude type, or None.  charmm=True switches the
    LJ term between cut_lj_inner and the outer cutoff, by the energy or,
    with charmm_fsw=True, by the force (lj/charmmfsw); coul_kind "charmm"
    and "charmm/implicit" the coulomb term between cut_coul_inner and
    cut_coul; "charmmfsh" shifts the coulomb force to 0 at cut_coul;
    coul_kind "msm"
    the MSM complement of order msm_order; "debye" (kappa in g_ewald),
    "dsf" and "wolf" (alpha in g_ewald) the lj/cut/coul/debye|dsf|wolf
    styles.  The same tables as lidp_tpu make_pair_params."""
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
    if coul_kind not in COUL_KINDS or coul_kind == "gromacs":
        raise ValueError(f"coul_kind {coul_kind} of the lj/cut tables")
    ccsq, cisq = float(cut_coul) ** 2, float(cut_coul_inner) ** 2
    switched = coul and coul_kind in SWITCHED_COUL_KINDS
    esh, fsh = dsf_wolf_shifts(coul_kind, g_ewald, cut_coul)
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
        charmm_fsw=bool(charmm_fsw),
        coul_kind=coul_kind if coul else "long",
        cut_coul_innersq=cisq if switched else 0.0,
        denom_coul=((ccsq - cisq) ** 3 if switched and ccsq > cisq
                    else 1.0),
        msm_order=int(msm_order), coul_eshift=esh, coul_fshift=fsh)


def dsf_wolf_shifts(coul_kind, alpha, cut_coul):
    """(e_shift, f_shift) of the dsf and wolf coulomb kinds
    (pair_coul_dsf.cpp:214-217, pair_coul_wolf.cpp:82-84; lidp_tpu
    _dsf_wolf_shifts), Python floats; (0, 0) for the other kinds."""
    if coul_kind not in ("dsf", "wolf"):
        return 0.0, 0.0
    a_, rc = float(alpha), float(cut_coul)
    erfcc = math.erfc(a_ * rc)
    erfcd = math.exp(-a_ * a_ * rc * rc)
    rpis = 2.0 / math.sqrt(math.pi)
    if coul_kind == "dsf":
        fsh = -(erfcc / (rc * rc) + rpis * a_ * erfcd / rc)
        return erfcc / rc - fsh * rc, fsh
    esh = erfcc / rc
    return esh, -(esh + rpis * a_ * erfcd) / rc


def gromacs_coul_switch(cut_coul, cut_coul_inner):
    """The coulsw constants of coul/gromacs
    (pair_lj_gromacs_coul_gromacs.cpp:332; lidp_tpu _coul_switch_fields):
    (a1, b1, -a1/3, -b1/4, sw5, inner cutoff)."""
    rc, ri = float(cut_coul), float(cut_coul_inner)
    r3inv = 1.0 / rc ** 3
    t = rc - ri if rc > ri else 1.0
    a1 = (2.0 * ri - 5.0 * rc) * r3inv / (t * t)
    b1 = (4.0 * rc - 2.0 * ri) * r3inv / (t * t * t)
    sw5 = 1.0 / rc - t ** 3 * (a1 / 3.0 + b1 * t / 4.0)
    return (a1, b1, -a1 / 3.0, -b1 / 4.0, sw5, ri)


def make_generic_pair_params(kind, t1, t2, t3=None, t4=None, t5=None, *,
                             cut_lj, cut_coul=0.0, coul=False, qqrd2e=1.0,
                             g_ewald=0.0, special_lj=(1.0, 0.0, 0.0, 0.0),
                             special_coul=(1.0, 0.0, 0.0, 0.0), shift=False,
                             excl_types=None, coul_kind="long",
                             cut_coul_inner=0.0, dtype=torch.float64,
                             device="cpu"):
    """PairParams of a generic kind (lidp_tpu make_generic_pair_params):
    t1..t5 the (T+1,T+1) coefficient tables of generic_vdw (t5 stacked
    (T+1,T+1,K) for the kinds that read several), cut_lj likewise; shift
    fills the offset with the kind's own energy at its cutoff (pair_modify
    shift yes).  coul_kind long (g_ewald 0: coul/cut), debye (kappa in
    g_ewald), dsf and wolf (alpha in g_ewald), msm or gromacs (between
    cut_coul_inner and cut_coul)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if kind not in GENERIC_KINDS:
        raise ValueError(f"kind {kind} is not a generic kind")
    zeros = torch.zeros_like(t(t1))
    tabs = [t(a) if a is not None else zeros for a in (t1, t2, t3, t4)]
    t5t = None if t5 is None else t(t5)
    cut_lj = t(cut_lj)
    if shift:
        live = cut_lj > 0
        rc = torch.where(live, cut_lj, 1.0)
        _, phirc = generic_vdw(kind, rc * rc, 1.0 / (rc * rc), *tabs, t5t,
                               rc)
        offset = torch.where(live, phirc, 0.0)
    else:
        offset = torch.zeros_like(cut_lj)
    esh, fsh = dsf_wolf_shifts(coul_kind, g_ewald, cut_coul)
    return PairParams(
        lj1=tabs[0], lj2=tabs[1], lj3=tabs[2], lj4=tabs[3], lj5=t5t,
        offset=offset, cut_ljsq=cut_lj**2,
        cutsq=torch.clamp(cut_lj, min=cut_coul if coul else 0.0) ** 2,
        special_lj=t(list(special_lj)), special_coul=t(list(special_coul)),
        cut_coulsq=float(cut_coul) ** 2, qqrd2e=float(qqrd2e),
        g_ewald=float(g_ewald), coul=bool(coul),
        excl=(None if excl_types is None else torch.as_tensor(
            np.asarray(excl_types), dtype=torch.bool, device=device)),
        kind=kind, coul_kind=coul_kind if coul else "long",
        coul_eshift=esh, coul_fshift=fsh,
        cut_coul_innersq=(float(cut_coul_inner) ** 2
                          if coul and coul_kind == "gromacs" else 0.0),
        coulsw=(gromacs_coul_switch(cut_coul, cut_coul_inner)
                if coul and coul_kind == "gromacs" else None))


def make_table_pair_params(tab_e, tab_f, rlo, dr, cut, *,
                           special_lj=(1.0, 0.0, 0.0, 0.0),
                           special_coul=(1.0, 0.0, 0.0, 0.0),
                           excl_types=None, dtype=torch.float64,
                           device="cpu"):
    """PairParams of pair_style table linear (lidp_tpu/sim.py
    _build_table_pair's): tab_e, tab_f the (T+1,T+1,NT) energy and force
    magnitude on the grid rlo + k dr, cut the (T+1,T+1) cutoffs."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    cut = t(cut)
    z = torch.zeros_like(cut)
    return PairParams(
        lj3=z, lj4=z, offset=z, cut_ljsq=cut**2, cutsq=cut**2,
        special_lj=t(list(special_lj)), special_coul=t(list(special_coul)),
        cut_coulsq=0.0, qqrd2e=1.0, g_ewald=0.0, coul=False,
        excl=(None if excl_types is None else torch.as_tensor(
            np.asarray(excl_types), dtype=torch.bool, device=device)),
        kind="table", tab_e=t(tab_e), tab_f=t(tab_f), tab_rlo=float(rlo),
        tab_dr=float(dr))


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


def charmm_fsw_terms(p: PairParams, lj3, lj4, cut_ljsq, rsq, r2inv,
                     forcelj):
    """(forcelj, philj) of the CHARMM force switch (lj/charmmfsw/*,
    pair_lj_charmmfsw_coul_long.cpp:194-242 with the setup constants of
    :785-803; lidp_tpu _charmm_fsw_terms): switch1 on the force beyond
    the inner cutoff, the energy the analytically integrated split 12/6
    form (inside the inner cutoff the plain energy less a constant per
    type pair)."""
    r6inv = r2inv * r2inv * r2inv
    r3inv = torch.sqrt(r6inv)
    cisq = p.cut_lj_innersq
    outer = rsq > cisq
    switch1 = ((cut_ljsq - rsq) ** 2 * (cut_ljsq + 2.0 * rsq - 3.0 * cisq)
               / p.denom_lj)
    f = torch.where(outer, forcelj * switch1, forcelj)
    clj6 = cut_ljsq * cut_ljsq * cut_ljsq
    clj3 = cut_ljsq * torch.sqrt(cut_ljsq)
    ci6 = cisq * cisq * cisq
    ci3 = cisq * math.sqrt(cisq)
    e12o = lj3 * clj6 / (clj6 - ci6) * (r6inv - 1.0 / clj6) ** 2
    e6o = -lj4 * clj3 / (clj3 - ci3) * (r3inv - 1.0 / clj3) ** 2
    e12i = lj3 * (r6inv * r6inv - 1.0 / (ci6 * clj6))
    e6i = -lj4 * (r6inv - 1.0 / (ci3 * clj3))
    return f, torch.where(outer, e12o + e6o, e12i + e6i)


def charmm_coul(p: PairParams, prefactor, r, rsq, factor_coul):
    """(ecoul, forcecoul) of the CHARMM coulomb kinds, the special factor
    multiplicative (the reference subtracts no 1/r complement for these
    short-range forms; lidp_tpu _charmm_gromacs_coul_terms):
    coul/charmm (pair_lj_charmm_coul_charmm.cpp:123-130), the force and
    the energy both scaled by switch1 beyond the inner coulomb cutoff (the
    reference's own convention); coul/charmm/implicit
    (pair_lj_charmm_coul_charmm_implicit.cpp:87-94,122-129), the same
    switch on qq/r^2 with switch2 in the force; coul/charmmfsh
    (pair_lj_charmmfsw_coul_charmmfsh.cpp:154-184), the force shifted to
    0 at the cutoff."""
    ccsq = p.cut_coulsq
    if p.coul_kind == "charmmfsh":
        rc2inv = 1.0 / ccsq
        rcinv = math.sqrt(rc2inv)
        return (prefactor * (1.0 + rsq * rc2inv - 2.0 * r * rcinv)
                * factor_coul,
                prefactor * (1.0 - rsq * rc2inv) * factor_coul)
    cisq = p.cut_coul_innersq
    outer = rsq > cisq
    sw1 = (ccsq - rsq) ** 2 * (ccsq + 2.0 * rsq - 3.0 * cisq) / p.denom_coul
    if p.coul_kind == "charmm":
        e = prefactor * torch.where(outer, sw1, 1.0) * factor_coul
        return e, e
    sw2 = 12.0 * rsq * (ccsq - rsq) * (rsq - cisq) / p.denom_coul
    base = prefactor / r                    # qqrd2e q q / r^2
    return (base * torch.where(outer, sw1, 1.0) * factor_coul,
            2.0 * base * torch.where(outer, sw1 + 0.5 * sw2, 1.0)
            * factor_coul)


def generic_vdw(kind, rsq, r2inv, t1, t2, t3, t4, t5=None, cut_pair=None):
    """(forcelj, philj) of a generic kind (lidp_tpu/ops/pair.py _vdw_terms),
    forcelj in the LAMMPS convention fpair = forcelj * r2inv, from the
    coefficient tables already gathered at [ti, tj]:

      morse:  t1=D0 t2=alpha t3=r0 t4=2*D0*alpha    pair_morse.cpp:102
      buck:   t1=A t2=1/rho t3=C                      pair_buck.cpp:111
      yukawa: t1=A t2=kappa                           pair_yukawa.cpp:100
      gauss:  t1=A t2=B                               pair_gauss.cpp:113
      soft:   t1=A, cut_pair the cutoff               pair_soft.cpp:100
      born:   t1=A t2=1/rho t3=C t4=sigma t5=D        pair_born.cpp:116
      lj/expand: LJ tables, t5=delta           pair_lj_expand.cpp:109-114
      mie:    t1..t4=mie1..mie4, t5=[gamR, gamA]  pair_mie_cut.cpp:117-133
      lj96:   t1..t4 = 36,24,4,4 eps sig^9|6      pair_lj96_cut.cpp:96-99
      lj/smooth/linear: LJ tables, t5=[ljcut, dljcut, cut]
      lj/smooth: LJ tables, t5=[ljsw0..ljsw4, inner]
                                               pair_lj_smooth.cpp:82-120
      zbl:    t5=[d1a..d4a, zze, sw1..sw5, inner]    pair_zbl.cpp:118-145
      beck:   t1..t5 = AA, BB, aa, alpha, beta      pair_beck.cpp:91-120
      ufm:    t1=2 eps/sig^2 t2=1/sig^2 t3=eps       pair_ufm.cpp:87-101
      lj/cubic: LJ tables, t5=[eps, sigma, inner] pair_lj_cubic.cpp:66-98
      lj/gromacs: LJ tables, t5=[ljsw1..ljsw5, inner]
                                              pair_lj_gromacs.cpp:95-125
      none:   zero (the coulomb-only styles)"""
    if kind == "none":
        z = torch.zeros_like(rsq)
        return z, z
    r6inv = r2inv * r2inv * r2inv
    if kind in ("lj/smooth/linear", "lj/smooth", "lj/cubic", "lj/gromacs"):
        flj = r6inv * (t1 * r6inv - t2)
        elj = r6inv * (t3 * r6inv - t4)
    if kind == "lj96":
        r3inv = torch.sqrt(r6inv)
        return r6inv * (t1 * r3inv - t2), r6inv * (t3 * r3inv - t4)
    if kind == "gauss":
        e = torch.exp(-t2 * rsq)
        return -2.0 * t1 * t2 * rsq * e, -t1 * e
    if kind == "ufm":
        expuf = torch.exp(-rsq * t2)
        denom = 1.0 - expuf
        return t1 * expuf / denom * rsq, -t3 * torch.log(denom)
    if kind == "mie":
        rgam_r = r2inv ** (t5[..., 0] / 2.0)
        rgam_a = r2inv ** (t5[..., 1] / 2.0)
        return t1 * rgam_r - t2 * rgam_a, t3 * rgam_r - t4 * rgam_a
    if kind == "lj/gromacs":
        inner = t5[..., 5]
        beyond = rsq > inner * inner
        tt = torch.sqrt(rsq) - inner
        fsw = torch.sqrt(rsq) * tt * tt * (t5[..., 0] + t5[..., 1] * tt)
        esw = tt * tt * tt * (t5[..., 2] + t5[..., 3] * tt)
        return (flj + torch.where(beyond, fsw, 0.0),
                elj + t5[..., 4] + torch.where(beyond, esw, 0.0))
    r = torch.sqrt(rsq)
    if kind == "morse":
        dexp = torch.exp(-t2 * (r - t3))
        return t4 * (dexp * dexp - dexp) * r, t1 * (dexp * dexp - 2.0 * dexp)
    if kind == "buck":
        rexp = torch.exp(-r * t2)
        return (t1 * t2) * r * rexp - 6.0 * t3 * r6inv, t1 * rexp - t3 * r6inv
    if kind == "yukawa":
        rinv = 1.0 / r
        screening = torch.exp(-t2 * r)
        return t1 * screening * (t2 + rinv), t1 * screening * rinv
    if kind == "soft":
        arg = math.pi * r / cut_pair
        return (t1 * math.pi / cut_pair * torch.sin(arg) * r,
                t1 * (1.0 + torch.cos(arg)))
    if kind == "born":
        rexp = torch.exp((t4 - r) * t2)
        return ((t1 * t2) * r * rexp - 6.0 * t3 * r6inv
                + 8.0 * t5 * r2inv * r6inv,
                t1 * rexp - t3 * r6inv + t5 * r2inv * r6inv)
    if kind == "lj/expand":
        # LJ at r - delta; fpair = forcelj / (rshift r)
        rs = r - t5
        rs = torch.where(rs > 1e-6, rs, 1e-6)
        rs2inv = 1.0 / (rs * rs)
        r6s = rs2inv * rs2inv * rs2inv
        return (r6s * (t1 * r6s - t2) * r / rs, r6s * (t3 * r6s - t4))
    if kind == "lj/smooth/linear":
        return (flj - r * t5[..., 1],
                elj - t5[..., 0] + (r - t5[..., 2]) * t5[..., 1])
    if kind == "lj/smooth":
        inner = t5[..., 5]
        tt = r - inner
        tsq = tt * tt
        fskin = (t5[..., 1] + t5[..., 2] * tt + t5[..., 3] * tsq
                 + t5[..., 4] * tsq * tt)
        phi_out = (t5[..., 0] - t5[..., 1] * tt - t5[..., 2] * tsq / 2.0
                   - t5[..., 3] * tsq * tt / 3.0
                   - t5[..., 4] * tsq * tsq / 4.0)
        use_in = rsq < inner * inner
        return (torch.where(use_in, flj, fskin * r),
                torch.where(use_in, elj, phi_out))
    if kind == "zbl":
        c1, c2, c3, c4 = 0.02817, 0.28022, 0.50986, 0.18175
        rinv = 1.0 / r
        e1 = torch.exp(-t5[..., 0] * r)
        e2 = torch.exp(-t5[..., 1] * r)
        e3 = torch.exp(-t5[..., 2] * r)
        e4 = torch.exp(-t5[..., 3] * r)
        ssum = c1 * e1 + c2 * e2 + c3 * e3 + c4 * e4
        ssum_p = -(c1 * t5[..., 0] * e1 + c2 * t5[..., 1] * e2
                   + c3 * t5[..., 2] * e3 + c4 * t5[..., 3] * e4)
        zze = t5[..., 4]
        ezbl = zze * ssum * rinv
        dzbl = zze * (ssum_p - ssum * rinv) * rinv
        inner = t5[..., 10]
        tt = torch.where(r > inner, r - inner, 0.0)
        fsw = tt * tt * (t5[..., 5] + t5[..., 6] * tt)
        esw = tt * tt * tt * (t5[..., 7] + t5[..., 8] * tt)
        return -(dzbl + fsw) * r, ezbl + t5[..., 9] + esw
    if kind == "beck":
        r5 = rsq * rsq * r
        term1 = t3 * t3 + rsq
        t1inv = 1.0 / term1
        term2 = t1inv ** 5
        term3 = 21.672 + 30.0 * t3 * t3 + 6.0 * rsq
        term4 = t4 + r5 * t5
        term5 = t4 + 6.0 * r5 * t5
        expb = torch.exp(-r * term4)
        force_beck = t1 * expb * term5 - t2 * r * term2 * term3
        phi = (t1 * expb
               - t2 * (t1inv ** 3) * (1.0 + (2.709 + 3.0 * t3 * t3) * t1inv))
        return force_beck * r, phi
    if kind == "lj/cubic":
        rt6two, phis, dphids, a3c = 1.1224621, -0.7869823, 2.6899009, 27.93357
        eps_ = t5[..., 0]
        rmin = t5[..., 1] * rt6two
        inner = t5[..., 2]
        rmin_s = torch.where(rmin > 0, rmin, 1.0)
        tt = (r - inner) / rmin_s
        f_out = eps_ * (-dphids + a3c * tt * tt / 2.0) * r / rmin_s
        phi_out = eps_ * (phis + dphids * tt - a3c * tt * tt * tt / 6.0)
        use_in = rsq <= inner * inner
        return (torch.where(use_in, flj, f_out),
                torch.where(use_in, elj, phi_out))
    raise ValueError(f"unknown pair kind {kind}")


def table_terms(p: PairParams, rsq, ti, tj):
    """(forcelj, philj) of pair_style table linear (pair_table.cpp's LINEAR
    branch; lidp_tpu _table_terms): the tabulated E and |F| interpolated
    on the common grid, the segment index truncated before it is clipped
    (r below the first point takes segment 0)."""
    r = torch.sqrt(rsq)
    nt = p.tab_e.shape[-1]
    u = (r - p.tab_rlo) / p.tab_dr
    i0 = torch.clamp(u.to(torch.int32), 0, nt - 2).long()
    frac = torch.clamp(u - i0, 0.0, 1.0)
    e0, e1 = p.tab_e[ti, tj, i0], p.tab_e[ti, tj, i0 + 1]
    f0, f1 = p.tab_f[ti, tj, i0], p.tab_f[ti, tj, i0 + 1]
    return (f0 + frac * (f1 - f0)) * r, e0 + frac * (e1 - e0)


def dsf_wolf_coul(p: PairParams, prefactor, r, rsq):
    """(ecoul, forcecoul) of the dsf and wolf kinds at factor_coul 1
    (pair_coul_dsf.cpp:115-137 with the A&S erfc, pair_coul_wolf.cpp
    :117-141 with the exact one; lidp_tpu _dsf_wolf_pair_terms)."""
    if p.coul_kind == "dsf":
        grij = p.g_ewald * r
        expm2 = torch.exp(-grij * grij)
        erfcc = erfc_as(grij, expm2)
        return (prefactor * (erfcc - r * p.coul_eshift
                             - rsq * p.coul_fshift),
                prefactor * (erfcc + EWALD_F * grij * expm2
                             + rsq * p.coul_fshift))
    ar = p.g_ewald * r
    erfcc = torch.special.erfc(ar)
    erfcd = torch.exp(-ar * ar)
    return ((erfcc - p.coul_eshift * r) * prefactor,
            ((erfcc / rsq + EWALD_F * p.g_ewald * erfcd / r)
             + p.coul_fshift) * rsq * prefactor)


def dsf_wolf_self_energy(p: PairParams, q, mask):
    """The self energy both kinds tally into E_coul (pair_coul_dsf.cpp:99,
    pair_coul_wolf.cpp:102): -(e_shift/2 + alpha/sqrt(pi)) qqrd2e sum q^2
    over the live atoms, a 0-d tensor."""
    pref = -(p.coul_eshift / 2.0 + p.g_ewald / math.sqrt(math.pi))
    return pref * p.qqrd2e * torch.sum(torch.where(mask, q * q, 0.0))


def gromacs_coul(p: PairParams, prefactor, r, rsq, factor_coul):
    """(ecoul, forcecoul) of coul/gromacs (pair_lj_gromacs_coul_gromacs
    .cpp:120-130,156-164), the special factor multiplicative."""
    sw = p.coulsw
    outer = rsq > p.cut_coul_innersq
    qq = prefactor * r
    tc = r - sw[5]
    fc = prefactor + torch.where(outer, qq * r * tc * tc * (sw[0]
                                                            + sw[1] * tc),
                                 0.0)
    ec = qq * (1.0 / r - sw[4]) + torch.where(
        outer, qq * tc * tc * tc * (sw[2] + sw[3] * tc), 0.0)
    return ec * factor_coul, fc * factor_coul


def _coul_terms(p: PairParams, prefactor, r, rsq, factor_coul):
    """(ecoul, forcecoul) of the coulomb kinds at a pair's special
    factor: the CHARMM kinds (charmm_coul), coul/gromacs's and debye's
    screening with the factor multiplicative; the msm complement, dsf,
    wolf or the erfc form (g_ewald 0: the exact 1/r of coul/cut) less (1 -
    factor) prefactor, the kspace-present convention."""
    if p.coul_kind in ("charmm", "charmm/implicit", "charmmfsh"):
        return charmm_coul(p, prefactor, r, rsq, factor_coul)
    if p.coul_kind == "gromacs":
        return gromacs_coul(p, prefactor, r, rsq, factor_coul)
    if p.coul_kind == "debye":
        screening = torch.exp(-p.g_ewald * r)
        return (prefactor * screening * factor_coul,
                prefactor * screening * (p.g_ewald * r + 1.0) * factor_coul)
    if p.coul_kind == "msm":
        ec, fc = msm_coul(prefactor, r, rsq, p.cut_coulsq, p.msm_order)
    elif p.coul_kind in ("dsf", "wolf"):
        ec, fc = dsf_wolf_coul(p, prefactor, r, rsq)
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


def vdw_terms(p: PairParams, rsq, r2inv, ti, tj, cut_ljsq):
    """(forcelj, philj) of p's van der Waals kind on the pairs of types
    (ti, tj), unshifted and at full weight: lj/cut (12 lj3, 6 lj4), the
    long kinds at full weight (long_vdw), the generic kinds on their
    tables (generic_vdw; soft reads its cutoff), or the table."""
    if p.kind == "table":
        return table_terms(p, rsq, ti, tj)
    lj3, lj4 = p.lj3[ti, tj], p.lj4[ti, tj]
    if p.kind in LONG_KINDS:
        return long_vdw(p, rsq, r2inv, lj3, lj4, _tab(p.rhoinv, ti, tj))
    if p.kind == "lj":
        return plain_vdw(p, rsq, r2inv, lj3, lj4)
    return generic_vdw(p.kind, rsq, r2inv, p.lj1[ti, tj], p.lj2[ti, tj],
                       lj3, lj4, _tab(p.lj5, ti, tj),
                       torch.sqrt(cut_ljsq) if p.kind == "soft" else None)


def pair_single(rsq, itype, jtype, qi, qj, p: PairParams, factor_coul=1.0,
                factor_lj=1.0):
    """Pair::single (lidp_tpu/ops/pair.py pair_single): (eng, fforce) of one
    pair at distance^2 rsq (tensors broadcast), fforce the force/r factor;
    every kind and coulomb kind as in _pair_terms, the CHARMM switch on
    the unshifted energy.  The long dispersion kinds take factor_lj on
    their whole term here, as the JAX function does (not _pair_terms'
    special algebra: ROADMAP queue 3)."""
    dev = (p.lj3 if p.tab_e is None else p.tab_e).device
    rsq = torch.as_tensor(rsq, dtype=p.lj3.dtype, device=dev)
    itype = torch.as_tensor(itype, device=dev).long()
    jtype = torch.as_tensor(jtype, device=dev).long()
    r2inv = 1.0 / rsq
    forcecoul = phicoul = torch.zeros_like(rsq)
    if p.coul:
        r = torch.sqrt(rsq)
        prefactor = p.qqrd2e * qi * qj / r
        phicoul, forcecoul = _coul_terms(p, prefactor, r, rsq, factor_coul)
        incoul = rsq < p.cut_coulsq
        forcecoul = torch.where(incoul, forcecoul, 0.0)
        phicoul = torch.where(incoul, phicoul, 0.0)
    cut_ljsq = p.cut_ljsq[itype, jtype]
    forcelj, philj_raw = vdw_terms(p, rsq, r2inv, itype, jtype, cut_ljsq)
    philj = philj_raw - p.offset[itype, jtype]
    if p.charmm_fsw:
        # the JAX function puts the integrated energy in place of the
        # shifted one
        forcelj, philj = charmm_fsw_terms(
            p, p.lj3[itype, jtype], p.lj4[itype, jtype], cut_ljsq, rsq,
            r2inv, forcelj)
    elif p.charmm:
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
    energies (lidp_tpu/ops/pair.py _pair_terms): every kind (vdw_terms)
    with the CHARMM energy or force switch, every coulomb kind
    (_coul_terms); the special factor multiplies the switched terms.  The long
    kinds take the reference's special algebra, terms(f) = terms(1) -
    (1 - f) plain terms, their energy not scaled by f
    (pair_lj_long_coul_long.cpp:529-533): the k-space sum runs over every
    pair.  Shapes broadcast; rsq must be masked nonzero."""
    r2inv = 1.0 / rsq
    factor_lj = p.special_lj[sp_code]
    in_range = (rsq < p.cutsq[ti, tj]) & pair_mask
    if p.excl is not None:
        in_range = in_range & ~p.excl[ti, tj]
    cut_ljsq = p.cut_ljsq[ti, tj]
    lj_mask = in_range & (rsq < cut_ljsq)

    forcelj, philj = vdw_terms(p, rsq, r2inv, ti, tj, cut_ljsq)
    if p.kind in LONG_KINDS:
        f0, e0 = plain_vdw(p, rsq, r2inv, p.lj3[ti, tj], p.lj4[ti, tj],
                           _tab(p.rhoinv, ti, tj))
        forcelj = forcelj - (1.0 - factor_lj) * f0
        evdwl = philj - (1.0 - factor_lj) * e0 - p.offset[ti, tj]
    else:
        if p.charmm_fsw:
            forcelj, philj = charmm_fsw_terms(p, p.lj3[ti, tj], p.lj4[ti, tj],
                                              cut_ljsq, rsq, r2inv, forcelj)
        elif p.charmm:
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
