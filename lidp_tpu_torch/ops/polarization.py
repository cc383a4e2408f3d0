"""Induced-dipole polarization settings and the CG dipole solve
(lidp_tpu/ops/polarization.py: PolarizationSettings, _damping_terms,
scf_solve_cg).

The JAX solver's `lax.while_loop` becomes a Python loop that reads the
convergence measure `change` to the host once per iteration; the
static-trip variant (`cg_static_trips`) runs a fixed number of trips with
the update masked on the device once converged, and reads the host once at
the end.
"""

from __future__ import annotations

import dataclasses

import torch

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
