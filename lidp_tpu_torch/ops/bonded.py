"""The special-bond correction of the list-free pair passes
(lidp_tpu/ops/bonded.py special_correction_sparse; the bonded force terms
of that module are not ported, ROADMAP queue 1 item 6).

A pair pass that takes no special codes (the cell grid at full weight, the
panel kernels with the special pairs' LJ term left out) is corrected over
the O(N*S) pairs of the special lists: the LJ term to factor_lj times its
full value, the coulomb term by the kspace-present convention forcecoul -=
(1 - factor_coul) * prefactor (pair_lj_cut_coul_long.cpp compute()).
Plain PyTorch, as XLA runs it in the JAX package: no kernel.
"""

from __future__ import annotations

import torch

from lidp_tpu_torch.box import minimum_image


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


def special_correction_sparse(x, q, type_, sp_idx, sp_lvl, mask, box, p):
    """The correction of a pair pass that took every pair at factor 1.0
    (the cell grid's cell_pair_forces), for the special pairs of sp_idx,
    sp_lvl (N,S) (topology.special_lists, the fill at x.shape[0]); p is
    a PairParams, without coulomb when p.coul is false.  Returns (f_corr,
    devdwl, decoul, dvir6), as the JAX function."""
    cut_coulsq = p.cut_coulsq if p.coul else 0.0
    return special_pair_sums(
        x, q, type_, x, q, type_, sp_idx, sp_lvl, box.lengths,
        (p.lj3, p.lj4, p.offset, p.cut_ljsq, p.cutsq), p.special_lj,
        p.special_coul, cut_coulsq, p.qqrd2e, nvalid=x.shape[0],
        lj_counted=1.0, row_mask=mask)
