"""pair hbond/dreiding/lj and hbond/dreiding/morse: the DREIDING
directional hydrogen bonds (lidp_tpu/ops/hbond.py;
pair_hbond_dreiding_lj.cpp::compute :79-297,
pair_hbond_dreiding_morse.cpp :54-230).

The reference loops donors x full-neighbour acceptors x the hydrogens of
the donor's 1-2 special list.  Here the (donor, hydrogen) rows are a
static (M,2) table from the bond topology, built at setup, and the term is
one dense [M, N] pass, every row against every atom as a candidate
acceptor, with the (itype, jtype, ktype) -> parameter row lookup a gathered
int table: the 12-10 LJ or Morse radial form, the cos^ap(theta) angle gate
(theta = D-H...A from delr1 = x_D - x_H and delr2 = x_A - x_H), LAMMPS's
switch between the inner and outer cutoff, the special factor
special_lj[level(D, A)] of the dense special codes (the sbmask factor of
:137), and ev_tally3's virial with the hydrogen as the reference body.

The pass runs in fixed blocks of rows (HBOND_BLOCK_PAIRS pairs a block),
so its peak memory stays bounded at any size; the per-row forces reach
the donors and hydrogens by a gather over each atom's rows in a fixed
order (d_rows, h_rows), and every sum runs in a fixed order, so repeats
give the same bits on the GPU too.  Plain PyTorch, as XLA runs it in the
JAX package: no kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lidp_tpu_torch.box import minimum_image

# the [rows, N] pairs of one block: ~40 (B, N) float64 intermediates of
# 16 MiB each at this size
HBOND_BLOCK_PAIRS = 1 << 21
# the sine's floor (pair_hbond_dreiding_lj.cpp:40 SMALL)
SMALL = 0.001


@dataclasses.dataclass(frozen=True)
class HbondParams:
    """The JAX HbondParams: dh (M,2) donor and hydrogen atom rows, dh_valid
    (M,); type2param (T+1,T+1,T+1) the parameter row of (donor type,
    acceptor type, hydrogen type) or -1; per parameter row pcoef (P,4)
    (LJ: 60 eps sigma^12, 60 eps sigma^10, 5 eps sigma^12, 6 eps sigma^10;
    Morse: D0, alpha, r0, 2 D0 alpha), p_ap (the power, integer-valued),
    the inner and outer cutoffs squared, the angle cutoff in radians and
    (outer^2 - inner^2)^3; sp_factor (M,N) the special LJ factor of
    (donor, acceptor); type_idx (N,) the atom types.  d_rows, h_rows (N,K)
    each atom's rows as donor and as hydrogen, filled with M (the zero
    row the gathers append)."""

    dh: torch.Tensor
    dh_valid: torch.Tensor
    type2param: torch.Tensor
    pcoef: torch.Tensor
    p_ap: torch.Tensor
    p_cut_innersq: torch.Tensor
    p_cut_outersq: torch.Tensor
    p_cut_angle: torch.Tensor
    p_denom_vdw: torch.Tensor
    sp_factor: torch.Tensor
    type_idx: torch.Tensor
    d_rows: torch.Tensor
    h_rows: torch.Tensor
    morse: bool = False


def _type_range(tok: str, ntypes: int):
    """force->bounds of a pair_coeff type token: N, *, N*, *M, N*M."""
    if tok == "*":
        return range(1, ntypes + 1)
    if "*" in tok:
        lo, _, hi = tok.partition("*")
        return range(int(lo) if lo else 1, (int(hi) if hi else ntypes) + 1)
    return [int(tok)]


def _rows_of(atoms, rows, n: int, fill: int) -> np.ndarray:
    """(n, K) each atom's rows (row m of `rows` at atom `atoms[m]`), in
    row order, filled with `fill`."""
    per = [[] for _ in range(n)]
    for m, a in zip(rows, atoms):
        per[a].append(m)
    k = max(1, max((len(r) for r in per), default=1))
    out = np.full((n, k), fill, np.int64)
    for a, rows in enumerate(per):
        out[a, :len(rows)] = rows
    return out


def make_hbond_params(coeff_rows, ntypes, ap_global, cut_inner_global,
                      cut_outer_global, cut_angle_global_deg, bonds, natoms,
                      type_arr, special_lj, special_code=None,
                      dtype=torch.float64, device="cpu",
                      morse=False) -> HbondParams:
    """HbondParams of the raw pair_coeff rows (lidp_tpu make_hbond_params;
    PairHbondDreidingLJ::coeff :317-384): each row [i, j, k, 'i'|'j',
    eps|D0, sigma|alpha, (r0,) [ap [inner outer [angle]]]] with the type
    tokens' `*` ranges, the flag naming which of i and j is the donor,
    and the pair_style settings (ap, inner and outer cutoffs, angle in
    degrees) where a row leaves them out.  The (donor, hydrogen) rows:
    each atom of a donor type with each of its 1-2 neighbours of `bonds`
    ((NB,2), 1-based; the k loop over special[i][0..nspecial[i][0]],
    :119-124; a hydrogen of another type falls out through type2param).
    special_code: the dense (n,n) special levels, or None for factor 1."""
    T = ntypes
    t2p = np.full((T + 1, T + 1, T + 1), -1, np.int32)
    rows = []
    nrad = 3 if morse else 2
    for toks in coeff_rows:
        ilo, jlo, klo = (_type_range(toks[q], T) for q in range(3))
        donor_flag = toks[3]
        vals = [float(v) for v in toks[4:4 + nrad]]
        rest = toks[4 + nrad:]
        ap = int(rest[0]) if len(rest) > 0 else ap_global
        ci = float(rest[1]) if len(rest) > 2 else cut_inner_global
        co = float(rest[2]) if len(rest) > 2 else cut_outer_global
        ang = (float(rest[3]) if len(rest) > 3
               else cut_angle_global_deg) * np.pi / 180.0
        if ci > co:
            raise ValueError("Pair inner cutoff >= Pair outer cutoff")
        m = len(rows)
        if morse:
            d0, alpha, r0 = vals
            pc = [d0, alpha, r0, 2.0 * d0 * alpha]
        else:
            eps, sig = vals
            pc = [60.0 * eps * sig ** 12, 60.0 * eps * sig ** 10,
                  5.0 * eps * sig ** 12, 6.0 * eps * sig ** 10]
        rows.append((pc, float(ap), ci * ci, co * co, ang,
                     (co * co - ci * ci) ** 3))
        for i in ilo:
            for j in jlo:
                if j < i:
                    continue
                for k in klo:
                    if donor_flag == "i":
                        t2p[i, j, k] = m
                    else:
                        t2p[j, i, k] = m
    donor_types = {i for i in range(1, T + 1)
                   if (t2p[i, 1:, 1:] >= 0).any()}
    adj = [[] for _ in range(natoms)]
    for a, b in np.asarray(bonds, int):
        adj[a - 1].append(b - 1)
        adj[b - 1].append(a - 1)
    dh = [(i, k) for i in range(natoms) if int(type_arr[i]) in donor_types
          for k in adj[i]]
    M = max(len(dh), 1)
    dh_arr = np.zeros((M, 2), np.int64)
    dh_valid = np.zeros(M, bool)
    for m_, (d, h) in enumerate(dh):
        dh_arr[m_] = (d, h)
        dh_valid[m_] = True
    spf = np.ones((M, natoms))
    if special_code is not None and len(dh):
        lj_tab = np.asarray([1.0] + list(special_lj[1:4]))
        spf = lj_tab[np.asarray(special_code)[dh_arr[:, 0], :natoms]]
    P = max(len(rows), 1)
    # per row: ap, inner^2, outer^2, angle, denominator (1 unused)
    cols = np.zeros((5, P))
    cols[4] = 1.0
    pcoef = np.zeros((P, 4))
    for m_, (pc, *scal) in enumerate(rows):
        pcoef[m_] = pc
        cols[:, m_] = scal
    live = np.flatnonzero(dh_valid)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=device)

    d_rows = _rows_of(dh_arr[live, 0], live, natoms, M)
    h_rows = _rows_of(dh_arr[live, 1], live, natoms, M)
    return HbondParams(
        dh=idx(dh_arr), dh_valid=torch.as_tensor(dh_valid, device=device),
        type2param=idx(t2p), pcoef=t(pcoef), p_ap=t(cols[0]),
        p_cut_innersq=t(cols[1]), p_cut_outersq=t(cols[2]),
        p_cut_angle=t(cols[3]), p_denom_vdw=t(cols[4]), sp_factor=t(spf),
        type_idx=idx(np.asarray(type_arr)[:natoms]), d_rows=idx(d_rows),
        h_rows=idx(h_rows), morse=morse)


def _signed_pow(absc, c, ap):
    """powint(c, ap) with the integer power carried as a float: |c|^ap,
    negative for an odd power of a negative c."""
    odd = torch.remainder(torch.round(ap), 2.0) != 0.0
    return torch.pow(absc, ap) * torch.where(odd & (c < 0.0), -1.0, 1.0)


def _block(x, mask, L, p: HbondParams, rows, need_ev):
    """The [B, N] pass of the rows `rows`: (fi (B,3) on the donors, fk
    (B,3) on the hydrogens, fj (N,3) on the acceptors, evdwl, virial6)."""
    n = x.shape[0]
    D, H = p.dh[rows, 0], p.dh[rows, 1]
    xD, xH = x[D], x[H]
    tD, tH = p.type_idx[D], p.type_idx[H]
    pm = p.type2param[tD[:, None], p.type_idx[None, :], tH[:, None]]
    cols = torch.arange(n, device=x.device)
    valid = (p.dh_valid[rows][:, None] & (pm >= 0) & mask[None, :]
             & (cols[None, :] != D[:, None]) & (cols[None, :] != H[:, None]))
    pm = torch.clamp(pm, min=0)

    delx = minimum_image(xD[:, None, :] - x[None, :, :], L)
    rsq = torch.sum(delx * delx, dim=-1)
    co2 = p.p_cut_outersq[pm]
    valid = valid & (rsq < co2)
    rsq = torch.where(valid, rsq, 1.0)

    delr1 = minimum_image(xD - xH, L)
    rsq1 = torch.sum(delr1 * delr1, dim=-1)
    rsq1 = torch.where(rsq1 > 0, rsq1, 1.0)
    r1 = torch.sqrt(rsq1)
    delr2 = minimum_image(x[None, :, :] - xH[:, None, :], L)
    rsq2 = torch.where(valid, torch.sum(delr2 * delr2, dim=-1), 1.0)
    r2 = torch.sqrt(rsq2)

    c = torch.sum(delr1[:, None, :] * delr2, dim=-1) / (r1[:, None] * r2)
    c = torch.clamp(c, -1.0, 1.0)
    ac = torch.arccos(c)
    cut_ang = p.p_cut_angle[pm]
    valid = valid & (ac > cut_ang) & (ac < 2.0 * math.pi - cut_ang)
    s = torch.clamp(torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)),
                    min=SMALL)

    apf = p.p_ap[pm]
    absc = torch.abs(c)
    powc = _signed_pow(absc, c, apf)
    powc1 = _signed_pow(absc, c, apf - 1.0)

    r2inv = 1.0 / rsq
    cf = p.pcoef[pm]                                         # (B,N,4)
    if p.morse:
        r = torch.sqrt(rsq)
        dexp = torch.exp(-cf[..., 1] * (r - cf[..., 2]))
        eng_rad = cf[..., 0] * (dexp * dexp - 2.0 * dexp)
        force_kernel = (cf[..., 3] * (dexp * dexp - dexp) / r) * powc
    else:
        r10inv = r2inv * r2inv * r2inv * r2inv * r2inv
        eng_rad = r10inv * (cf[..., 2] * r2inv - cf[..., 3])
        force_kernel = (r10inv * (cf[..., 0] * r2inv - cf[..., 1])
                        * r2inv) * powc
    force_angle = apf * eng_rad * powc1 * s

    ci2 = p.p_cut_innersq[pm]
    den = p.p_denom_vdw[pm]
    in_switch = rsq > ci2
    switch1 = (co2 - rsq) ** 2 * (co2 + 2.0 * rsq - 3.0 * ci2) / den
    switch2 = 12.0 * rsq * (co2 - rsq) * (rsq - ci2) / den
    force_switch = torch.where(in_switch, eng_rad * switch2 / rsq, 0.0)
    force_kernel = torch.where(in_switch, force_kernel * switch1,
                               force_kernel)
    force_angle = torch.where(in_switch, force_angle * switch1, force_angle)
    eng_rad = torch.where(in_switch, eng_rad * switch1, eng_rad)

    fac = p.sp_factor[rows] * valid.to(x.dtype)
    evdwl = torch.sum(eng_rad * powc * fac)
    a = fac * force_angle / s
    bd = (fac * (force_kernel + force_switch))[..., None] * delx
    a11 = a * c / rsq1[:, None]
    a12 = -a / (r1[:, None] * r2)
    a22 = a * c / rsq2
    d1 = delr1[:, None, :]
    v1 = a11[..., None] * d1 + a12[..., None] * delr2
    v2 = a22[..., None] * delr2 + a12[..., None] * d1
    fi = v1 + bd                                             # on D
    fj = v2 - bd                                             # on A
    fk = -(v1 + v2)                                          # on H
    if need_ev:
        # ev_tally3 with the hydrogen as the reference body (:256)
        vir = torch.stack([
            torch.sum(d1[..., a] * fi[..., b] + delr2[..., a] * fj[..., b])
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])
    else:
        vir = x.new_zeros(6)
    return fi.sum(1), fk.sum(1), fj.sum(0), evdwl, vir


def hbond_forces(x, mask, box, p: HbondParams, need_ev=True):
    """(f (N,3), evdwl, virial6) of the hydrogen bonds (lidp_tpu
    hbond_forces): the [M, N] pass in blocks of rows, in a fixed order;
    the virial zero without need_ev, as the JAX function gives it."""
    n = x.shape[0]
    M = p.dh.shape[0]
    L = box.img_lengths
    step = max(1, HBOND_BLOCK_PAIRS // max(n, 1))
    fi_all, fk_all = [], []
    fj = torch.zeros_like(x)
    evdwl = x.new_zeros(())
    vir = x.new_zeros(6)
    for lo in range(0, M, step):
        rows = torch.arange(lo, min(M, lo + step), device=x.device)
        fi, fk, fjb, ev, vb = _block(x, mask, L, p, rows, need_ev)
        fi_all.append(fi)
        fk_all.append(fk)
        fj, evdwl, vir = fj + fjb, evdwl + ev, vir + vb
    zero = x.new_zeros((1, 3))
    fi = torch.cat(fi_all + [zero])
    fk = torch.cat(fk_all + [zero])
    f = fj + fi[p.d_rows].sum(1) + fk[p.h_rows].sum(1)
    return f, evdwl, vir
