"""fix shake and fix rattle: the batched SHAKE constraint solver and the
RATTLE velocity projection (lidp_tpu/ops/shake.py; RIGID/fix_shake.cpp,
fix_rattle.cpp).

The reference solves each 2/3/4-atom cluster with a hand-unrolled routine
(shake :1398, shake3 :1499, shake4 :1672, shake3angle :1924).  All of them
are one structure: C <= 3 distance constraints c between cluster atoms
(p_c, q_c) with targets bond_c, corrections
dx_i = dtfsq/m_i * sum_c lambda_c r_c (delta_{i,p_c} - delta_{i,q_c}),
solved by iterating   lambda <- A^{-1} (bond^2 - s^2 - Q(lambda))
with A_cd = 2 c_cd (s_c . r_d),  Q_c = sum_de c_cd c_ce (r_d . r_e) l_d l_e,
c_cd = 1/m_{p_c} (d_{p_c p_d} - d_{p_c q_d}) - 1/m_{q_c} (d_{q_c p_d} -
d_{q_c q_d}).  All clusters solve at once as (M, 3) batches; the
fixed-point loop runs max_iter trips with a done mask for each cluster and
reads nothing back to the host, as the JAX package's fori_loop.

The constraint forces are applied in post_force (:564): f += lambda/dtfsq
* r_c on p_c, minus on q_c, so that the next Verlet position update lands
on the constraint manifold; the constraint virial is the lambda r (x) r
tally.  find_clusters runs on the host at setup.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from lidp_tpu_torch.box import minimum_image


@dataclasses.dataclass(frozen=True)
class ShakeParams:
    atoms: torch.Tensor     # (M,4) long atom ids, -1 pad (slot 0 = central)
    cpairs: torch.Tensor    # (M,3,2) long local constraint pairs, -1 pad
    bond2: torch.Tensor     # (M,3) target distance^2 (0 pad)
    cmask: torch.Tensor     # (M,3) bool active constraints
    invmass: torch.Tensor   # (N,) 1/m per atom
    dtv: float
    dtfsq: float            # dt^2*ftm2v (fix_shake.cpp:458)
    nconstraints: int = 0
    max_iter: int = 25
    tolerance: float = 1e-4


def _inv3(A):
    """Batched explicit 3x3 inverse through the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f_ = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f_ * h, c * h - b * i, b * f_ - c * e], -1),
        torch.stack([f_ * g - d * i, a * i - c * g, c * d - a * f_], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * (e * i - f_ * h) - b * (d * i - f_ * g) + c * (d * h - e * g)
    return co / det[..., None, None]


def _cluster_geometry(x, L, p: ShakeParams):
    """(pa, qa (M,3) atom indices of each constraint's ends, r (M,3,3)
    their minimum-image separation, act (M,3) float, ccd (M,3,3) the
    coupling c_cd of the active constraints)."""
    dtype = x.dtype
    ai = torch.clamp(p.atoms, min=0)
    pc, qc = p.cpairs[:, :, 0], p.cpairs[:, :, 1]
    pa = torch.gather(ai, 1, torch.clamp(pc, min=0))
    qa = torch.gather(ai, 1, torch.clamp(qc, min=0))
    r = minimum_image(x[pa] - x[qa], L)
    im_p, im_q = p.invmass[pa], p.invmass[qa]

    def delta(u, v):
        return (u[:, :, None] == v[:, None, :]).to(dtype)

    ccd = (im_p[:, :, None] * (delta(pc, pc) - delta(pc, qc))
           - im_q[:, :, None] * (delta(qc, pc) - delta(qc, qc)))
    act = p.cmask.to(dtype)
    ccd = ccd * act[:, :, None] * act[:, None, :]
    return pa, qa, r, act, ccd


def _padded_inverse(A, act):
    """The inverse of A with the inactive constraints' rows and columns
    replaced by the identity's, so that the 3x3 inverse exists."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    pairact = act[:, :, None] * act[:, None, :]
    A = A + (1.0 - pairact) * eye
    A = torch.where((pairact + eye) > 0, A, 0.0)
    return _inv3(A)


def shake_post_force(sys, f, p: ShakeParams):
    """The constraint force correction (FixShake::post_force): (f with the
    constraint forces, the constraint virial (6,))."""
    x, v = sys.x, sys.v
    L = sys.box.img_lengths
    # the unconstrained prediction (unconstrained_update, :1314)
    xs = x + p.dtv * v + (p.dtfsq * p.invmass)[:, None] * f
    pa, qa, r, act, ccd = _cluster_geometry(x, L, p)
    s = minimum_image(xs[pa] - xs[qa], L)
    sr = torch.einsum("mcx,mdx->mcd", s, r)             # s_c . r_d
    rr = torch.einsum("mcx,mdx->mcd", r, r)             # r_c . r_d
    Ainv = _padded_inverse(2.0 * ccd * sr, act)
    s2 = torch.sum(s * s, dim=-1)
    rhs0 = (p.bond2 - s2) * act

    lam = torch.zeros_like(s2)
    done = torch.zeros(s2.shape[:1] + (1,), dtype=torch.bool,
                       device=x.device)
    for _ in range(p.max_iter):
        cl = ccd * lam[:, None, :]                      # c_cd l_d
        quad = torch.einsum("mcd,mde,mce->mc", cl, rr, cl)
        lam_new = torch.einsum("mcd,md->mc", Ainv, rhs0 - quad * act) * act
        step_done = torch.all(torch.abs(lam_new - lam) <= p.tolerance,
                              dim=-1, keepdim=True)
        lam = torch.where(done, lam, lam_new)
        done = done | step_done

    lam = lam / p.dtfsq * act
    contrib = lam[:, :, None] * r
    f = f.index_add(0, pa.reshape(-1), contrib.reshape(-1, 3))
    f = f.index_add(0, qa.reshape(-1), -contrib.reshape(-1, 3))
    # the constraint virial (v_tally in shake/shake3/...: lambda_c r_c (x)
    # r_c)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    vir = torch.stack([torch.sum(lam * rx * rx), torch.sum(lam * ry * ry),
                       torch.sum(lam * rz * rz), torch.sum(lam * rx * ry),
                       torch.sum(lam * rx * rz), torch.sum(lam * ry * rz)])
    return f, vir.to(f.dtype)


def rattle_velocity(sys, p: ShakeParams):
    """The RATTLE velocity-stage constraint (fix_rattle.cpp vrattle2/3/4/
    3angle, :240-524): project the velocities so that r_c . (v_p - v_q) =
    0 for every constraint; one batched linear solve A mu = -b with A_cd =
    c_cd (r_c . r_d) and b_c = r_c . (v_p - v_q), v_i += invm_i sum_c mu_c
    r_c (delta_{i,p_c} - delta_{i,q_c})."""
    x, v = sys.x, sys.v
    pa, qa, r, act, ccd = _cluster_geometry(x, sys.box.img_lengths, p)
    b = torch.sum(r * (v[pa] - v[qa]), dim=-1) * act
    rr = torch.einsum("mcx,mdx->mcd", r, r)
    mu = -torch.einsum("mcd,md->mc", _padded_inverse(ccd * rr, act), b) * act
    contrib = mu[:, :, None] * r
    im_p, im_q = p.invmass[pa], p.invmass[qa]
    v = v.index_add(0, pa.reshape(-1),
                    (im_p[:, :, None] * contrib).reshape(-1, 3))
    v = v.index_add(0, qa.reshape(-1),
                    (-im_q[:, :, None] * contrib).reshape(-1, 3))
    v = torch.where(sys.mask[:, None], v, 0.0)
    return sys.replace(v=v)


def find_clusters(n, bonds, bond_types, angles, angle_types, mass_atom,
                  *, b_types=(), a_types=(), masses=(), t_types=(),
                  type_atom=None, bond_r0=None, angle_theta0=None,
                  tol=0.1):
    """FixShake::find_clusters (host numpy): select the constrained bonds
    (by bond type `b`, by an atom's mass `m` within 0.1, MASSDELTA, or by
    an atom's type `t`), group them into star clusters around a central
    atom, and add the 1-3 constraint of an `a`-type angle to a two-bond
    cluster.  bond_r0 / angle_theta0: the equilibrium tables by type.
    Returns (atoms, cpairs, bond2, cmask, nconstraints, the constrained
    bond rows, the constrained angle rows), or None without a constraint."""
    bonds = np.asarray(bonds)
    sel = np.zeros(len(bonds), bool)
    for bt in b_types:
        sel |= bond_types == bt
    for m in masses:
        sel |= ((np.abs(mass_atom[bonds[:, 0]] - m) <= tol)
                | (np.abs(mass_atom[bonds[:, 1]] - m) <= tol))
    if t_types and type_atom is not None:
        for tt in t_types:
            sel |= (type_atom[bonds[:, 0]] == tt) | (type_atom[bonds[:, 1]]
                                                      == tt)
    cb = bonds[sel]
    cbt = np.asarray(bond_types)[sel]
    if len(cb) == 0:
        return None
    sel_rows = np.nonzero(sel)[0]
    used_angle_rows = []

    # star grouping: the central atom is the one in more than one
    # constrained bond, or the heavier atom of a lone bond
    deg = defaultdict(list)
    for ib, (a, b) in enumerate(cb):
        deg[a].append(ib)
        deg[b].append(ib)
    multi = {a for a, ibs in deg.items() if len(ibs) > 1}
    clusters = {}
    for ib, (a, b) in enumerate(cb):
        if a in multi and b in multi:
            raise ValueError("SHAKE cluster of connected centrals "
                             "(ring/chain) — not a star")
        if a in multi:
            c = a
        elif b in multi:
            c = b
        else:
            c = a if mass_atom[a] >= mass_atom[b] else b
        clusters.setdefault(c, []).append(ib)

    angle_by_pair = {}
    if len(a_types) and angles is not None and len(angles):
        for row, ((i, j, k), at) in enumerate(
                zip(np.asarray(angles), np.asarray(angle_types))):
            if at in a_types:
                angle_by_pair[(j, frozenset((i, k)))] = (at, row)

    rows_atoms, rows_pairs, rows_b2, rows_mask = [], [], [], []
    ncons = 0
    for c, ibs in clusters.items():
        if len(ibs) > 3:
            raise ValueError(f"SHAKE cluster with {len(ibs)} bonds at atom "
                             f"{c}")
        others = [cb[ib][1] if cb[ib][0] == c else cb[ib][0] for ib in ibs]
        atoms = [c] + others + [-1] * (3 - len(others))
        cpairs, b2 = [], []
        for loc, ib in enumerate(ibs):
            r0 = bond_r0[cbt[ib]]
            cpairs.append((0, loc + 1))
            b2.append(r0 * r0)
        if len(ibs) == 2:
            hit = angle_by_pair.get((c, frozenset(others)))
            if hit is not None:
                at, arow = hit
                used_angle_rows.append(arow)
                b1r, b2r = np.sqrt(b2[0]), np.sqrt(b2[1])
                th = angle_theta0[at]
                cpairs.append((1, 2))
                b2.append(b1r * b1r + b2r * b2r
                          - 2.0 * b1r * b2r * np.cos(th))
        mask = [True] * len(cpairs) + [False] * (3 - len(cpairs))
        ncons += len(cpairs)
        cpairs += [(-1, -1)] * (3 - len(cpairs))
        b2 += [0.0] * (3 - len(b2))
        rows_atoms.append(atoms)
        rows_pairs.append(cpairs)
        rows_b2.append(b2)
        rows_mask.append(mask)

    return (np.asarray(rows_atoms, np.int32), np.asarray(rows_pairs, np.int32),
            np.asarray(rows_b2), np.asarray(rows_mask), ncons,
            sel_rows, np.asarray(used_angle_rows, int))


def build_shake_params(n, dt, ftm2v, mass_atom, found, *, tolerance=1e-4,
                       max_iter=25, dtype=torch.float64, device="cpu"):
    """ShakeParams of find_clusters' result.  dtfsq is dt^2*ftm2v without
    the 0.5: the prediction covers a full kick (two half-kicks with the
    same corrected f) plus the drift (fix_shake.cpp:458)."""
    atoms, cpairs, b2, cmask, ncons = found[:5]

    def idx(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=device)

    return ShakeParams(
        atoms=idx(atoms), cpairs=idx(cpairs),
        bond2=torch.as_tensor(np.asarray(b2), dtype=dtype, device=device),
        cmask=torch.as_tensor(np.asarray(cmask), dtype=torch.bool,
                              device=device),
        invmass=torch.as_tensor(1.0 / np.asarray(mass_atom), dtype=dtype,
                                device=device),
        dtv=float(dt), dtfsq=float(dt * dt * ftm2v),
        nconstraints=int(ncons), max_iter=int(max_iter),
        tolerance=float(tolerance))
