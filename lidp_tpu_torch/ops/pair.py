"""LJ + real-space Ewald pair parameters (lidp_tpu/ops/pair.py, the
lj/cut/coul/long and lj/cut parts).

The erfc of the real-space coulomb term is the reference's 5-term
Abramowitz-Stegun polynomial (pair_lj_cut_coul_long_polarization.cpp:43-49),
not `torch.special.erfc`, so the port matches the JAX package and the
reference bit-close.
"""

from __future__ import annotations

import dataclasses

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


def make_pair_params(epsilon, sigma, cut_lj, *, cut_coul=0.0, qqrd2e=1.0,
                     g_ewald=0.0, coul=True, shift=False,
                     special_lj=(1.0, 0.0, 0.0, 0.0),
                     special_coul=(1.0, 0.0, 0.0, 0.0),
                     dtype=torch.float64, device="cpu"):
    """PairParams of lj/cut/coul/long (coul=True) or lj/cut alone
    (coul=False: cutsq = cut_lj^2, no coulomb term) from per-type-pair
    (T+1,T+1) epsilon/sigma/cut arrays.  special_lj / special_coul: the
    special_bonds factors [1, s12, s13, s14], by default LAMMPS's (0 for
    LJ and coulomb).  shift=True fills the offset table with the LJ energy
    at the cutoff (pair_modify shift yes).  The same tables as lidp_tpu
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
    return PairParams(
        lj3=4.0 * epsilon * s6 * s6, lj4=4.0 * epsilon * s6,
        offset=offset, cut_ljsq=cut_lj**2,
        cutsq=torch.clamp(cut_lj, min=cut_coul if coul else 0.0) ** 2,
        special_lj=t(list(special_lj)),
        special_coul=t(list(special_coul)),
        cut_coulsq=float(cut_coul) ** 2, qqrd2e=float(qqrd2e),
        g_ewald=float(g_ewald), coul=bool(coul))
