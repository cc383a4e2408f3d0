"""Induced-dipole polarization (lidp_tpu/ops/polarization.py): the
settings, the CG dipole solve, and the dense route's (N,N) tensor forms
of the reference's physics (pair_lj_cut_coul_long_polarization.cpp):
the Wolf static field E0, the damped (N,3,N,3) dipole tensor T, the SCF
solve in its three modes, the serial Gauss-Seidel reference sweep, the
polar_gs_ranked metric, and the charge-dipole and dipole-dipole forces
with the three-term energy.

The JAX solvers' `lax.while_loop` becomes a Python loop that reads the
convergence measure `change` to the host once per iteration; the CG's
static-trip variant (`cg_static_trips`) runs a fixed number of trips with
the update masked on the device once converged, and reads the host once at
the end.  The Gauss-Seidel sweep is a Python loop over the atoms, as
serial as the reference's: validation only.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lidp_tpu_torch.box import minimum_image

DAMPING_NONE = 0
DAMPING_EXPONENTIAL = 1


@dataclasses.dataclass(frozen=True)
class PolarizationSettings:
    """Keyword settings of the pair style (settings(), :678-766; defaults
    :63-79)."""

    iterations_max: int = 50
    damping_type: int = DAMPING_NONE
    polar_damp: float = 2.1304
    zodid: bool = False
    polar_precision: float = 1e-11
    fixed_iteration: bool = False
    polar_gs: bool = False
    polar_gs_ranked: bool = True
    polar_gamma: float = 1.03
    use_previous: bool = False
    # >0: run exactly this many CG trips with the update masked once
    # converged (same math and stopping criterion as the loop)
    cg_static_trips: int = 0


def _damping_terms(r, rsq, damp, damping_type):
    """Thole exponential damping lambdas (build_dipole_field_matrix
    :1293-1296)."""
    if damping_type == DAMPING_EXPONENTIAL:
        e = torch.exp(-damp * r)
        l1 = 1.0 - e * (0.5 * damp * damp * rsq + damp * r + 1.0)
        l2 = 1.0 - e * (damp**3 * rsq * r / 6.0 + 0.5 * damp * damp * rsq
                        + damp * r + 1.0)
        return l1, l2
    one = torch.ones_like(r)
    return one, one


def scf_solve_cg(e0, alpha, apply_T, s: PolarizationSettings, mu_init=None,
                 n_total=None):
    """Conjugate-gradient dipole solve of (diag(1/alpha) + T) mu = E0.

    Symmetrized with y = mu/sqrt(alpha): B = I + sqrt(a) T sqrt(a), so
    zero-polarizability sites decouple exactly.  Stops on the reference's
    criterion, mean-square dipole change per component <= precision^2.
    Each B product is one `apply_T`, so a solve of k iterations makes k+1.
    Returns (mu, iterations (int), diverged (0-d bool tensor)).
    """
    n3 = 3.0 * (n_total if n_total is not None else e0.shape[0])
    sa = torch.sqrt(alpha)[:, None]

    def B(y):
        return y + sa * apply_T(sa * y)

    def safe(v):
        return torch.where(v != 0, v, torch.ones_like(v))

    b = sa * e0
    if mu_init is not None:
        y = torch.where(sa > 0, mu_init / torch.where(sa > 0, sa, 1.0), 0.0)
    else:
        y = s.polar_gamma * sa * e0        # = mu0 / sqrt(alpha)
    r = b - B(y)
    p = r
    rs = torch.sum(r * r)
    rs0 = torch.sum(b * b) + 1e-30
    # compared in the working dtype, as the JAX loop condition does
    prec2 = torch.tensor(s.polar_precision**2, dtype=e0.dtype,
                         device=e0.device)
    # only a genuinely large relative residual (divergence or NaN) falls
    # back to mu = alpha*E0; a CG that stagnates just above the change
    # criterion keeps its far better iterate
    res_accept = 1e-5

    if s.cg_static_trips:
        change = torch.full((), float("inf"), dtype=e0.dtype,
                            device=e0.device)
        it = torch.zeros((), dtype=torch.int64, device=e0.device)
        for _ in range(int(s.cg_static_trips)):
            done = change <= prec2
            Bp = B(p)
            a = torch.where(done, 0.0, rs / safe(torch.sum(p * Bp)))
            y = y + a * p
            r2 = r - a * Bp
            rs2 = torch.sum(r2 * r2)
            beta = rs2 / safe(rs)
            change = torch.where(done, change,
                                 torch.sum((a * p * sa) ** 2) / n3)
            p = r2 + beta * p
            r, rs = r2, rs2
            it = it + (~done).to(it.dtype)
        iters = int(it)
    else:
        change = torch.full((), float("inf"), dtype=e0.dtype,
                            device=e0.device)
        iters = 0
        done = False
        # NaN-safe: NaN <= prec2 is False, so a poisoned solve iterates to
        # iterations_max and then takes the divergence fallback
        while not done and iters < s.iterations_max:
            Bp = B(p)
            a = rs / safe(torch.sum(p * Bp))
            y = y + a * p
            r2 = r - a * Bp
            rs2 = torch.sum(r2 * r2)
            beta = rs2 / safe(rs)
            change = torch.sum((a * p * sa) ** 2) / n3
            p = r2 + beta * p
            r, rs = r2, rs2
            iters += 1
            done = bool(change <= prec2)      # the one host read per trip
    converged = (change <= prec2) | (rs <= res_accept * rs0)
    diverged = ~converged
    mu = torch.where(diverged, alpha[:, None] * e0, sa * y)
    return mu, iters, diverged


def _pair_geometry(x, box, mask):
    """Minimum-image pair displacements (N,N,3), rsq masked to 1 and the
    pair mask (off the diagonal, both atoms real)."""
    n = x.shape[0]
    delta = minimum_image(x[:, None, :] - x[None, :, :], box.img_lengths)
    rsq = torch.sum(delta * delta, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    pm = (~eye) & mask[:, None] & mask[None, :]
    return delta, torch.where(pm, rsq, 1.0), pm


def _other_mol(mol):
    return (mol[:, None] != mol[None, :]) | (mol[:, None] == 0)


def static_field_wolf(x, q, mol, mask, box, cut_coulsq, qqrd2e):
    """Shifted-force (Wolf, undamped) static field folded by sqrt(qqrd2e):
    E0_i = sqrt(qqrd2e) sum_j (1/r^2 - 1/rc^2) (1/r) q_j d_ij over pairs
    with rsq <= cut_coulsq in different molecules (or mol_i == 0)
    (reference :329-374)."""
    delta, rsq, pm = _pair_geometry(x, box, mask)
    cut_coul = math.sqrt(cut_coulsq)
    f_shift = -1.0 / (cut_coul * cut_coul)
    r = torch.sqrt(rsq)
    include = pm & (rsq <= cut_coulsq) & _other_mol(mol)
    ef_temp = torch.where(include, (1.0 / rsq + f_shift) / r, 0.0)
    e0 = torch.einsum("ij,j,ijp->ip", ef_temp, q, delta)
    return e0 * math.sqrt(qqrd2e)


def dipole_field_tensor(x, alpha, mask, box, s: PolarizationSettings):
    """Dense T, shape (N,3,N,3), the diagonal blocks zero:
    T_ij^pq = -3 d_p d_q l2 / r^5 + delta_pq l1 / r^3
    (build_dipole_field_matrix :1243-1316).  alpha is not read: the
    reference's tensor spans every pair."""
    delta, rsq, pm = _pair_geometry(x, box, mask)
    r = torch.sqrt(rsq)
    l1, l2 = _damping_terms(r, rsq, s.polar_damp, s.damping_type)
    r3inv = 1.0 / (rsq * r)
    r5inv = r3inv / rsq
    outer = delta[:, :, :, None] * delta[:, :, None, :]       # (N,N,3,3)
    t = -3.0 * outer * (l2 * r5inv)[:, :, None, None]
    t = t + torch.eye(3, dtype=x.dtype, device=x.device) * (
        l1 * r3inv)[:, :, None, None]
    t = torch.where(pm[:, :, None, None], t, 0.0)
    return t.permute(0, 2, 1, 3).contiguous()                 # (N,3,N,3)


def _apply_tensor(tensor, mu):
    """T . mu as one (3N,3N) by (3N,) product."""
    n = mu.shape[0]
    return (tensor.reshape(3 * n, 3 * n) @ mu.reshape(3 * n)).reshape(n, 3)


def induced_field(tensor, mu):
    """E_ind = -T . mu (the sweep contraction, reference :1158-1168)."""
    return -_apply_tensor(tensor, mu)


def scf_solve(e0, alpha, tensor, s: PolarizationSettings, mu_init=None):
    """Self-consistent dipole solve on the dense tensor: zodid keeps the
    gamma-preconditioned first-order guess (:389-390), fixed_iteration
    runs iterations_max Jacobi updates (:1211-1215), the precision mode is
    scf_solve_cg.  Returns (mu, iterations (int), diverged (0-d bool))."""
    a = alpha[:, None]
    mu = s.polar_gamma * a * e0 if mu_init is None else mu_init
    no = torch.zeros((), dtype=torch.bool, device=e0.device)
    if s.zodid:
        return mu, 0, no
    if s.fixed_iteration:
        for _ in range(s.iterations_max):
            mu = a * (e0 + induced_field(tensor, mu))
        return mu, s.iterations_max, no
    return scf_solve_cg(e0, alpha, lambda m: _apply_tensor(tensor, m), s,
                        mu_init=mu_init)


def scf_solve_gauss_seidel(e0, alpha, tensor, s: PolarizationSettings,
                           rank_metric=None, mu_init=None):
    """The reference's rank-ordered Gauss-Seidel sweeps
    (DipoleSolverIterative :1113-1238) for polar_gs / polar_gs_ranked,
    one atom at a time in a Python loop: validation only.  The order is
    the stable descending sort of rank_metric (the reference's bubble
    sort, :1130-1143); fixed_iteration returns after the last sweep's
    in-place updates; a solve that does not converge falls back to
    mu = alpha E0.  Returns (mu, iterations (int), diverged (0-d bool))."""
    n = e0.shape[0]
    a = alpha[:, None]
    mu = s.polar_gamma * a * e0 if mu_init is None else mu_init
    no = torch.zeros((), dtype=torch.bool, device=e0.device)
    if s.zodid:
        return mu, 0, no
    if rank_metric is not None and s.polar_gs_ranked:
        order = torch.argsort(-rank_metric, stable=True).tolist()
    else:
        order = range(n)
    in_place = s.polar_gs or s.polar_gs_ranked

    def sweep(mu):
        mu = mu.clone()
        mu_new = torch.zeros_like(mu)
        for i in order:
            ef = (-torch.einsum("pjq,jq->p", tensor[i], mu)
                  + tensor[i, :, i, :] @ mu[i])
            mu_i = alpha[i] * (e0[i] + ef)
            if in_place:
                mu[i] = mu_i
            mu_new[i] = mu_i
        return mu, mu_new

    if s.fixed_iteration:
        for it in range(s.iterations_max + 1):
            mu_after, mu_new = sweep(mu)
            # the reference returns before the mu = mu_new copy on the last
            # sweep; the in-sweep updates of GS are already applied
            mu = (mu_after if in_place else mu) \
                if it == s.iterations_max else mu_new
        return mu, s.iterations_max, no

    n3 = 3.0 * n
    prec2 = s.polar_precision * s.polar_precision
    change = torch.full((), float("inf"), dtype=e0.dtype, device=e0.device)
    it = 0
    while bool(change > prec2) and it <= s.iterations_max:
        mu_old = mu
        _, mu = sweep(mu)
        change = torch.sum((mu - mu_old) ** 2) / n3
        it += 1
    diverged = change > prec2
    return torch.where(diverged, a * e0, mu), it, diverged


def rank_metric_compute(x, alpha, mol, mask, box):
    """The polar_gs_ranked ordering metric (reference :192-227): rmin is
    the least distance between polarizable atoms of different molecules;
    rank_i sums alpha_i alpha_j over the atoms j of other molecules within
    1.5 rmin."""
    _, rsq, pm = _pair_geometry(x, box, mask)
    r = torch.sqrt(rsq)
    diff_mol = _other_mol(mol)
    polar_pair = (alpha[:, None] > 0) & (alpha[None, :] > 0)
    rmin = torch.min(torch.where(pm & diff_mol & polar_pair, r,
                                 float("inf")))
    close = pm & diff_mol & (r < 1.5 * rmin)
    return torch.sum(torch.where(close, alpha[:, None] * alpha[None, :],
                                 0.0), dim=1)


def dipole_forces_energy(x, q, mol, alpha, mu, mask, box, cut_coulsq,
                         qqrd2e, s: PolarizationSettings, xshift=None):
    """Charge-dipole and dipole-dipole forces, the three-term energy
    u_self + u_ef + u_dd and the F.r virial (reference :406-641): returns
    (f (N,3), u_polar (), virial6).  xshift: the (N,3) shift onto the
    reference's stored positions for the virial; without it x is wrapped
    into the box."""
    delta, rsq, pm = _pair_geometry(x, box, mask)
    r2inv = 1.0 / rsq
    r = torch.sqrt(rsq)
    rinv = 1.0 / r
    r3inv = r2inv * rinv
    sqrt_q = math.sqrt(qqrd2e)
    cut_coul = math.sqrt(cut_coulsq)
    f_shift = -1.0 / (cut_coul * cut_coul)

    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    xsq, ysq, zsq = dx * dx, dy * dy, dz * dz

    # charge-dipole: within cut_coul, different molecules
    cd_mask = pm & (rsq < cut_coulsq) & _other_mol(mol)
    # the symmetric field-gradient matrix (reference :467-476)
    mxx = (-2.0 * xsq + ysq + zsq) * r2inv + f_shift * (ysq + zsq)
    myy = (-2.0 * ysq + xsq + zsq) * r2inv + f_shift * (xsq + zsq)
    mzz = (-2.0 * zsq + xsq + ysq) * r2inv + f_shift * (xsq + ysq)
    mxy = -3.0 * dx * dy * r2inv - f_shift * dx * dy
    mxz = -3.0 * dx * dz * r2inv - f_shift * dx * dz
    myz = -3.0 * dy * dz * r2inv - f_shift * dy * dz

    def matvec(m):
        return torch.stack([
            mxx * m[..., 0] + mxy * m[..., 1] + mxz * m[..., 2],
            mxy * m[..., 0] + myy * m[..., 1] + myz * m[..., 2],
            mxz * m[..., 0] + myz * m[..., 1] + mzz * m[..., 2]], dim=-1)

    cf_j = torch.where(cd_mask, q[None, :] * sqrt_q * r3inv, 0.0)
    cf_i = torch.where(cd_mask, q[:, None] * sqrt_q * r3inv, 0.0)
    f_cd = (cf_j[..., None] * matvec(mu[:, None, :])
            - cf_i[..., None] * matvec(mu[None, :, :]))       # (N,N,3)

    # u_ef = -sum over ordered pairs of mu_i . E_ij (reference :477-508)
    ef_temp = torch.where(cd_mask, (r2inv + f_shift) * rinv * sqrt_q, 0.0)
    e_ij = ef_temp[..., None] * q[None, :, None] * delta
    u_ef = -torch.sum(mu[:, None, :] * e_ij)

    # dipole-dipole: every pair of polarizable atoms, no cutoff
    dd_mask = pm & (alpha[:, None] != 0.0) & (alpha[None, :] != 0.0)
    r5inv = r3inv * r2inv
    r7inv = r5inv * r2inv
    pdotp = torch.einsum("ip,jp->ij", mu, mu)
    pidotr = torch.einsum("ip,ijp->ij", mu, delta)
    pjdotr = torch.einsum("jp,ijp->ij", mu, delta)
    if s.damping_type == DAMPING_EXPONENTIAL:
        pd = s.polar_damp
        t1 = torch.exp(-pd * r)
        t2 = 1.0 + pd * r + 0.5 * pd * pd * rsq
        t3 = t2 + pd**3 * rsq * r / 6.0
        pre1 = (3.0 * r5inv * pdotp * (1.0 - t1 * t2)
                - 15.0 * r7inv * pidotr * pjdotr * (1.0 - t1 * t3))
        pre2 = 3.0 * r5inv * pjdotr * (1.0 - t1 * t3)
        pre3 = 3.0 * r5inv * pidotr * (1.0 - t1 * t3)
        pre4 = -pdotp * r3inv * (-t1 * (pd * rinv + pd * pd)
                                 + t1 * pd * t2 * rinv)
        pre5 = 3.0 * pidotr * pjdotr * r5inv * (
            -t1 * (pd * rinv + pd * pd + 0.5 * r * pd**3)
            + t1 * pd * t3 * rinv)
        u_dd_pair = (r3inv * pdotp * (1.0 - t1 * t2)
                     - 3.0 * r5inv * pidotr * pjdotr * (1.0 - t1 * t3))
        pre1 = pre1 + (pre4 + pre5)
    else:
        pre1 = 3.0 * r5inv * pdotp - 15.0 * r7inv * pidotr * pjdotr
        pre2 = 3.0 * r5inv * pjdotr
        pre3 = 3.0 * r5inv * pidotr
        u_dd_pair = r3inv * pdotp - 3.0 * r5inv * pidotr * pjdotr
    pre1 = torch.where(dd_mask, pre1, 0.0)
    pre2 = torch.where(dd_mask, pre2, 0.0)
    pre3 = torch.where(dd_mask, pre3, 0.0)
    f_dd = (pre1[..., None] * delta + pre2[..., None] * mu[:, None, :]
            + pre3[..., None] * mu[None, :, :])
    u_dd = 0.5 * torch.sum(torch.where(dd_mask, u_dd_pair, 0.0))
    f = torch.sum(f_cd + f_dd, dim=1)

    # self energy (reference :431-433)
    polar = alpha != 0.0
    u_self = 0.5 * torch.sum(torch.where(
        polar, torch.sum(mu * mu, dim=1) / torch.where(polar, alpha, 1.0),
        0.0))
    u_polar = u_self + u_ef + u_dd

    # the reference tallies the whole pair virial by F.r over the stored
    # (box-wrapped) positions (virial_fdotr_compute, pair.cpp:810-816),
    # which for these minimum-image O(N^2) loops picks up image terms
    if xshift is not None:
        xw = x + xshift
    else:
        per = torch.tensor(box.periodic, device=x.device)
        L = box.lengths
        xw = torch.where(per[None, :],
                         x - torch.floor((x - box.lo) / L) * L, x)
    fm = torch.where(mask[:, None], f, 0.0)
    virial = torch.stack([
        torch.sum(xw[:, 0] * fm[:, 0]), torch.sum(xw[:, 1] * fm[:, 1]),
        torch.sum(xw[:, 2] * fm[:, 2]), torch.sum(xw[:, 0] * fm[:, 1]),
        torch.sum(xw[:, 0] * fm[:, 2]), torch.sum(xw[:, 1] * fm[:, 2])])
    return f, u_polar, virial
