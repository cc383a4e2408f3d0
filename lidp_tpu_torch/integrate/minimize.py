"""Energy minimization (lidp_tpu/integrate/minimize.py; the reference's
Min::run, min.cpp:406).

The JAX package's five min styles, each a Python loop over device work
that gives the JAX loop's iterates:
  * fire (min_fire.cpp): vector updates, no line search;
  * cg (min_cg.cpp): Polak-Ribiere conjugate gradient with the JAX
    package's backtracking line search and secant refinement;
  * sd (min_sd.cpp): cg with beta = 0;
  * quickmin (min_quickmin.cpp): the velocity projected onto the force,
    an Euler step capped at dmax;
  * hftn (min_hftn.cpp): truncated Newton, H p = f by CG with the exact
    Hessian-vector product, the forward-mode derivative of the force
    function (torch.autograd.forward_ad, where the JAX package takes
    jax.jvp).
`compute(sys) -> (f, energy)` evaluates the force field; each function
returns (sys, energy, iterations, converged), the energy a 0-d tensor.

The stopping tests (etol's relative energy change, ftol's force norm,
maxiter) are those of the JAX loops, in their order, with e_prev = inf at
the start.  Every scalar of an update stays on the device; each
iteration reads its stopping test to the host once, and cg's line search
and hftn's inner loops read theirs once a trip.  Where the JAX loop
evaluates the force field again at a point it has just evaluated (cg after
its line search, hftn after its backtracking), the port keeps the forces
of that evaluation, which are the same bits.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FireConfig:
    dt0: float
    dtmax: float
    alpha0: float = 0.1
    f_inc: float = 1.1
    f_dec: float = 0.5
    f_alpha: float = 0.99
    n_min: int = 5


def _scalar(v, like):
    # a fill on the device, not a copy from the host
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _inv_mass(mass_atom, like):
    m = torch.as_tensor(mass_atom, dtype=like.dtype, device=like.device)
    live = m > 0
    return torch.where(live, 1.0 / torch.where(live, m, 1.0), 0.0)[:, None]


def _go_on(f, e_prev, e, it, etol, ftol, maxiter, squared=False) -> bool:
    """The JAX loops' cond: neither the relative energy change under etol
    nor the force norm under ftol (its square under ftol^2 for cg), and
    fewer than maxiter iterations; one host read."""
    if it >= maxiter:
        return False
    fsq = torch.sum(f * f)
    stop = torch.zeros((), dtype=torch.bool, device=f.device)
    if etol > 0.0:
        de = torch.abs(e - e_prev)
        stop = stop | (de < etol * 0.5 * (torch.abs(e) + torch.abs(e_prev)
                                          + 1e-30))
    if ftol > 0.0:
        stop = stop | ((fsq < ftol * ftol) if squared
                       else (torch.sqrt(fsq) < ftol))
    return not bool(stop)


def _converged(f, it, ftol, maxiter) -> bool:
    return bool(torch.sqrt(torch.sum(f * f)) < ftol) or it < maxiter


def fire_minimize(sys, compute, mass_atom, *, etol=0.0, ftol=1e-6,
                  maxiter=1000, dt0=None, dtmax=None):
    """Minimize with FIRE: dt0 0.002 and dtmax 10 dt0 unless given (the
    JAX package's, whatever the timestep)."""
    dt0 = dt0 if dt0 is not None else 0.002
    dtmax = dtmax if dtmax is not None else 10 * dt0
    cfg = FireConfig(dt0=dt0, dtmax=dtmax)
    x0 = sys.x
    minv = _inv_mass(mass_atom, x0)
    dtmax_t = _scalar(cfg.dtmax, x0)
    alpha0 = _scalar(cfg.alpha0, x0)

    f, e = compute(sys)
    e_prev = _scalar(float("inf"), x0)
    v = torch.zeros_like(x0)
    dt = _scalar(cfg.dt0, x0)
    alpha = alpha0
    npos = torch.zeros((), dtype=torch.int32, device=x0.device)
    it = 0
    while _go_on(f, e_prev, e, it, etol, ftol, maxiter):
        p = torch.sum(f * v)
        fnorm = torch.sqrt(torch.sum(f * f)) + 1e-30
        vnorm = torch.sqrt(torch.sum(v * v))
        v = torch.where(p > 0, (1.0 - alpha) * v + alpha * f / fnorm * vnorm,
                        torch.zeros_like(v))
        uphill = p <= 0
        grow = (p > 0) & (npos > cfg.n_min)
        dt = torch.where(grow, torch.minimum(dt * cfg.f_inc, dtmax_t),
                         torch.where(uphill, dt * cfg.f_dec, dt))
        alpha = torch.where(grow, alpha * cfg.f_alpha,
                            torch.where(uphill, alpha0, alpha))
        npos = torch.where(uphill, torch.zeros_like(npos), npos + 1)
        v = v + dt * f * minv
        sys = sys.replace(x=sys.x + dt * v)
        f2, e2 = compute(sys)
        f, e_prev, e, it = f2, e, e2, it + 1
    return sys, e, it, _converged(f, it, ftol, maxiter)


ALPHA_RED = 0.5
MAX_BACKTRACK = 40


def _linemin(sys, compute, h, f_cur, e_cur, dmax):
    """cg's line search (the JAX package's linemin): from alpha =
    min(1, dmax / max|h|), each trip evaluates at alpha and at the secant
    estimate of the 1-d minimum from the directional derivatives at 0 and
    alpha (clipped to [0, alpha]), keeps the lower of the two, accepts it
    when it is below e_cur and else halves alpha, for up to MAX_BACKTRACK
    trips.  Returns (sys, f, e, moved)."""
    x = sys.x
    hmax = torch.max(torch.abs(h)) + 1e-30
    alpha = torch.minimum(_scalar(1.0, x), dmax / hmax)
    fh0 = torch.sum(f_cur * h)

    def eval_at(a):
        s = sys.replace(x=x + a * h)
        f_t, e_t = compute(s)
        return s, f_t, e_t

    for _ in range(MAX_BACKTRACK):
        sys_t, f_t, e_t = eval_at(alpha)
        fh_t = torch.sum(f_t * h)
        denom = fh0 - fh_t
        alpha_q = torch.where(
            denom > 1e-30 * torch.abs(fh0),
            alpha * fh0 / torch.where(denom > 0, denom, 1.0), alpha)
        alpha_q = torch.minimum(torch.clamp(alpha_q, min=0.0), alpha)
        sys_q, f_q, e_q = eval_at(alpha_q)
        q_better = e_q < e_t
        e_t = torch.where(q_better, e_q, e_t)
        if bool(e_t < e_cur):
            return (sys.replace(x=torch.where(q_better, sys_q.x, sys_t.x)),
                    torch.where(q_better, f_q, f_t), e_t, True)
        alpha = alpha * ALPHA_RED
    return sys, f_cur, e_cur, False


def cg_minimize(sys, compute, *, etol=0.0, ftol=1e-6, maxiter=1000,
                dmax=0.1, style="cg"):
    """Polak-Ribiere CG (PR+: beta = max(0, f'.(f' - f)/f.f), steepest
    descent again when the new direction is uphill) or, for style "sd",
    steepest descent, on _linemin's steps; stops also when a line search
    did not move."""
    f, e = compute(sys)
    h = f
    e_prev = _scalar(float("inf"), sys.x)
    it = 0
    stalled = False
    while not stalled and _go_on(f, e_prev, e, it, etol, ftol, maxiter,
                                 squared=True):
        sys2, f2, e2, moved = _linemin(sys, compute, h, f, e, dmax)
        fsq_old = torch.sum(f * f) + 1e-30
        if style == "sd":
            h2 = f2
        else:
            beta = torch.clamp(torch.sum(f2 * (f2 - f)) / fsq_old, min=0.0)
            h2 = f2 + beta * h
        h2 = torch.where(torch.sum(h2 * f2) > 0, h2, f2)
        sys, f, h, e_prev, e, it = sys2, f2, h2, e, e2, it + 1
        stalled = not moved
    return sys, e, it, _converged(f, it, ftol, maxiter)


def quickmin_minimize(sys, compute, mass_atom, *, etol=0.0, ftol=1e-6,
                      maxiter=1000, dt=0.005, dmax=0.1, ftm2v=1.0):
    """min_style quickmin: the velocity projected onto the force (zero
    when anti-parallel), the Euler step capped so that no component moves
    more than dmax, then x and v advanced."""
    x0 = sys.x
    minv = _inv_mass(mass_atom, x0)
    dt_t = _scalar(dt, x0)
    f, e = compute(sys)
    e_prev = _scalar(float("inf"), x0)
    v = torch.zeros_like(x0)
    it = 0
    while _go_on(f, e_prev, e, it, etol, ftol, maxiter):
        vdotf = torch.sum(v * f)
        fdotf = torch.sum(f * f)
        scale = torch.where(fdotf > 0,
                            vdotf / torch.where(fdotf > 0, fdotf, 1.0), 0.0)
        v = torch.where(vdotf < 0, torch.zeros_like(v), scale * f)
        vmax = torch.max(torch.abs(v))
        dtv = torch.minimum(dt_t, torch.where(
            vmax > 0, dmax / torch.where(vmax > 0, vmax, 1.0), dt_t))
        dtf = dtv * ftm2v
        sys = sys.replace(x=sys.x + dtv * v)
        v = v + dtf * minv * f
        f2, e2 = compute(sys)
        f, e_prev, e, it = f2, e, e2, it + 1
    return sys, e, it, _converged(f, it, ftol, maxiter)


def hvp(sys, compute, x, d):
    """H d, the forward-mode derivative of the energy's gradient -f at x
    along d (the JAX package's jax.jvp of grad_e)."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        f, _ = compute(sys.replace(x=fwAD.make_dual(x, d)))
        tangent = fwAD.unpack_dual(-f).tangent
    return torch.zeros_like(x) if tangent is None else tangent


def hftn_minimize(sys, compute, *, etol=0.0, ftol=1e-6, maxiter=100,
                  dmax=0.1, cg_iters=20):
    """min_style hftn: each iteration solves H p = f by CG (cg_iters at
    most) inside a trust region of radius dmax sqrt(3N), stopping at
    negative curvature or the region's edge, falls back to steepest
    descent when CG made no step, and backtracks on the step until the
    Armijo test holds (20 halvings at most)."""
    x0 = sys.x
    radius = dmax * torch.sqrt(_scalar(float(x0.numel()), x0))

    def cg_solve(x, g):
        r = -g
        rho0 = torch.sum(r * r)
        p, d, rho = torch.zeros_like(g), r, rho0
        for _ in range(cg_iters):
            hd = hvp(sys, compute, x, d)
            dhd = torch.sum(d * hd)
            neg = dhd <= 0
            alpha = torch.where(neg, 0.0,
                                rho / torch.where(dhd == 0, 1.0, dhd))
            p_new = p + alpha * d
            over = torch.sqrt(torch.sum(p_new * p_new)) > radius
            p = torch.where(over | neg, p, p_new)
            r = r - alpha * hd
            rho_new = torch.sum(r * r)
            beta = rho_new / torch.where(rho == 0, 1.0, rho)
            d = r + beta * d
            rho = rho_new
            if bool(neg | over
                    | (torch.sqrt(rho_new) < 1e-10 * torch.sqrt(rho0))):
                break
        return torch.where(torch.sqrt(torch.sum(p * p)) > 0, p, -g)

    f, e = compute(sys)
    e_prev = _scalar(float("inf"), x0)
    it = 0
    while _go_on(f, e_prev, e, it, etol, ftol, maxiter):
        g = -f
        p = cg_solve(sys.x, g)
        step = _scalar(1.0, x0)
        slope = torch.sum(g * p)
        found = None
        for _ in range(20):
            s_try = sys.replace(x=sys.x + step * p)
            f_try, e_try = compute(s_try)
            if bool(e_try <= e + 1e-4 * step * slope):
                found = (s_try, f_try, e_try)
                break
            step = step * 0.5
        if found is None:
            s_try = sys.replace(x=sys.x + step * p)
            f_try, e_try = compute(s_try)
            found = (s_try, f_try, e_try)
        sys, f2, e2 = found
        f, e_prev, e, it = f2, e, e2, it + 1
    return sys, e, it, _converged(f, it, ftol, maxiter)
