"""LJ + real-space Ewald pair parameters and the dense all-pairs pass
(lidp_tpu/ops/pair.py, the lj/cut/coul/long and lj/cut parts).

The erfc of the real-space coulomb term is the reference's 5-term
Abramowitz-Stegun polynomial (pair_lj_cut_coul_long_polarization.cpp:43-49),
not `torch.special.erfc`, so the port matches the JAX package and the
reference bit-close.
"""

from __future__ import annotations

import dataclasses
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


def make_pair_params(epsilon, sigma, cut_lj, *, cut_coul=0.0, qqrd2e=1.0,
                     g_ewald=0.0, coul=True, shift=False,
                     special_lj=(1.0, 0.0, 0.0, 0.0),
                     special_coul=(1.0, 0.0, 0.0, 0.0), excl_types=None,
                     dtype=torch.float64, device="cpu"):
    """PairParams of lj/cut/coul/long (coul=True) or lj/cut alone
    (coul=False: cutsq = cut_lj^2, no coulomb term) from per-type-pair
    (T+1,T+1) epsilon/sigma/cut arrays.  special_lj / special_coul: the
    special_bonds factors [1, s12, s13, s14], by default LAMMPS's (0 for
    LJ and coulomb).  shift=True fills the offset table with the LJ energy
    at the cutoff (pair_modify shift yes).  excl_types: the (T+1,T+1) bool
    table of neigh_modify exclude type, or None.  The same tables as
    lidp_tpu make_pair_params."""
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
        g_ewald=float(g_ewald), coul=bool(coul),
        excl=(None if excl_types is None else torch.as_tensor(
            excl_types, dtype=torch.bool, device=device)))


def _pair_terms(rsq, qi, qj, ti, tj, sp_code, p: PairParams, pair_mask):
    """Per-pair LJ + coulomb force factor (F = fpair * d) and energies of
    lj/cut/coul/long (lidp_tpu/ops/pair.py _pair_terms, its `kind == "lj"`
    branch with the erfc coulomb).  Shapes broadcast; rsq must be masked
    nonzero.  g_ewald == 0 is the exact coul/cut form (erfc = 1)."""
    r2inv = 1.0 / rsq
    factor_lj = p.special_lj[sp_code]
    in_range = (rsq < p.cutsq[ti, tj]) & pair_mask
    if p.excl is not None:
        in_range = in_range & ~p.excl[ti, tj]
    lj_mask = in_range & (rsq < p.cut_ljsq[ti, tj])

    r6inv = r2inv * r2inv * r2inv
    lj3, lj4 = p.lj3[ti, tj], p.lj4[ti, tj]
    forcelj = r6inv * (12.0 * lj3 * r6inv - 6.0 * lj4)
    philj = r6inv * (lj3 * r6inv - lj4)
    evdwl = (philj - p.offset[ti, tj]) * factor_lj
    forcelj = torch.where(lj_mask, forcelj * factor_lj, 0.0)
    evdwl = torch.where(lj_mask, evdwl, 0.0)

    if p.coul:
        factor_coul = p.special_coul[sp_code]
        coul_mask = in_range & (rsq < p.cut_coulsq)
        r = torch.sqrt(rsq)
        prefactor = p.qqrd2e * qi * qj / r
        grij = p.g_ewald * r
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_as(grij, expm2) if p.g_ewald > 0 else 1.0
        forcecoul = prefactor * (erfc + EWALD_F * grij * expm2)
        forcecoul = forcecoul - (1.0 - factor_coul) * prefactor
        ecoul = prefactor * erfc - (1.0 - factor_coul) * prefactor
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
