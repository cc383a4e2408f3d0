"""Modifier fix styles (lidp_tpu/styles/fix_modifiers.py): each builder
appends its hooks to the FixBuildCtx sinks.
  * post_force, fn(sys, f) -> (f, virial6), with the same hook for the
    setup pass unless noted: the constraint fixes shake and rattle (their
    setup variant takes dtfsq/2; rattle's velocity stage goes to
    ctx.rattle_params), setforce, langevin, addforce, aveforce,
    spring/self, viscous, efield, spring (tether and couple), planeforce
    and lineforce;
  * end_of_step, fn(sys, res) -> sys: momentum, recenter and temp/csld;
  * temp/rescale and temp/berendsen, which Simulation.from_script builds
    after the fix loop from ctx.pending_temp_fix (their dof needs every
    constraint).
fix langevin and temp/csld draw from jax.random's stream (threefry.py),
keyed on the seed and sys.step as the JAX builders key theirs.  Where a
JAX builder reads fewer arguments than LAMMPS takes, the port raises on
the rest (ROADMAP queue 3 item 11).  The JAX module's other styles are
not ported (ROADMAP queue 1 item 6.1): io/script.py refuses them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lidp_tpu_torch.styles import fix_style


@fix_style("shake", "rattle")
def build_shake(ctx, spec):
    """fix shake / rattle: the clusters Simulation.from_script's pre-pass
    found (ctx.shake_found; None without a constraint).  The setup pass
    takes dtfsq/2 (its first step is a half kick, fix_shake.cpp:2734), and
    the data file's geometry is projected onto the constraints once
    (correct_coordinates, :2769, with v = f = 0)."""
    from lidp_tpu_torch.ops import shake as shake_mod

    if ctx.shake_found is None:
        return
    script = ctx.script
    shakep = shake_mod.build_shake_params(
        ctx.mass_atom.shape[0], script.dt, ctx.u.ftm2v, ctx.mass_atom,
        ctx.shake_found, tolerance=ctx.shake_cfg[0],
        max_iter=ctx.shake_cfg[1], dtype=ctx.dtype, device=ctx.device)
    shakep_half = dataclasses.replace(shakep, dtfsq=shakep.dtfsq * 0.5)
    sys = ctx.sys
    fc, _ = shake_mod.shake_post_force(
        sys.replace(v=torch.zeros_like(sys.v)), torch.zeros_like(sys.x),
        shakep_half)
    dx = shakep_half.dtfsq * shakep_half.invmass[:, None] * fc
    ctx.sys = sys.replace(x=sys.x + dx)
    ctx.dof_removed += shakep.nconstraints
    ctx.shake_dof_removed = shakep.nconstraints
    at, cp, _, cm = ctx.shake_found[:4]
    ctx.shake_pairs = tuple(
        np.take_along_axis(np.maximum(at, 0), np.maximum(cp[:, :, k], 0),
                           1)[cm] for k in (0, 1))
    ctx.pf_hooks.append(
        lambda sys_, f_, _p=shakep: shake_mod.shake_post_force(sys_, f_, _p))
    ctx.pf_hooks_setup.append(
        lambda sys_, f_, _p=shakep_half: shake_mod.shake_post_force(
            sys_, f_, _p))
    if spec.style == "rattle":
        # the velocity-stage constraint after final_integrate
        # (FixRattle::final_integrate -> vrattle*)
        ctx.rattle_params = shakep


def _group(ctx, spec, name=None):
    """The (npad,) bool tensor of a group (padding False)."""
    return torch.as_tensor(ctx.groups[name or spec.group], device=ctx.device)


def _vec(vals, ctx):
    return torch.tensor(vals, dtype=ctx.dtype, device=ctx.device)


def _masses(ctx):
    return torch.as_tensor(np.asarray(ctx.mass_atom), dtype=ctx.dtype,
                           device=ctx.device)


def _nargs(spec, n):
    """Refuse the arguments past the first n, which the JAX builder does
    not read (ROADMAP queue 3 item 11)."""
    if len(spec.args) > n:
        raise NotImplementedError(
            f"fix {spec.style} keywords "
            f"{' '.join(spec.args[n:])} are not ported (ROADMAP queue 1 "
            "item 6.1, the modifier fixes; the JAX package skips them "
            "unread: ROADMAP queue 3 item 11)")


def _post_force(ctx, hook):
    """Add a post_force hook to the run and to its setup pass."""
    ctx.pf_hooks.append(hook)
    ctx.pf_hooks_setup.append(hook)


def _unwrapped(sys_):
    from lidp_tpu_torch.box import unwrap

    return unwrap(sys_.x, sys_.box, sys_.image)


@fix_style("setforce")
def build_setforce(ctx, spec):
    """fix setforce fx fy fz (fix_setforce.cpp): each non-NULL component of
    the group's forces set to its value."""
    _nargs(spec, 3)
    vals = [None if t == "NULL" else float(t) for t in spec.args[:3]]
    g = _group(ctx, spec)[:, None]
    keep = torch.tensor([v is None for v in vals], device=ctx.device)
    tgt = _vec([0.0 if v is None else v for v in vals], ctx)

    def setforce(sys_, f_):
        return (torch.where(g & ~keep[None, :], tgt[None, :], f_),
                f_.new_zeros(6))

    _post_force(ctx, setforce)


@fix_style("langevin")
def build_langevin(ctx, spec):
    """fix langevin Tstart Tstop damp seed (fix_langevin.cpp post_force):
    on the group, the friction gamma1 m v and the noise gamma2 (u - 1/2)
    with gamma1 = -m/damp/ftm2v and gamma2 = sqrt(24 kB T m / (damp dt
    mvv2e))/ftm2v at Tstart, u uniform on [0, 1) from jax.random's
    threefry stream keyed on fold_in(PRNGKey(seed), sys.step), as the JAX
    builder draws it (the reference's RanMars stream is not reproduced).
    The key is derived on the host; the bits on the device."""
    from lidp_tpu_torch import threefry

    _nargs(spec, 4)
    u, script = ctx.u, ctx.script
    t_l, damp_l = float(spec.args[0]), float(spec.args[2])
    key0 = threefry.prng_key(int(spec.args[3]) & threefry.MASK32)
    g = _group(ctx, spec)
    m = _masses(ctx)
    gamma1 = (-m / damp_l / u.ftm2v)[:, None]
    gamma2 = (torch.sqrt(24.0 * u.boltz * t_l * m
                         / (damp_l * script.dt * u.mvv2e)) / u.ftm2v)[:, None]

    def langevin(sys_, f_):
        key = threefry.fold_in(key0, sys_.step)
        u01 = threefry.uniform(key, sys_.v.shape, sys_.v.dtype,
                               sys_.v.device)
        fl = gamma1 * sys_.v + gamma2 * (u01 - 0.5)
        return (f_ + torch.where((g & sys_.mask)[:, None], fl, 0.0),
                f_.new_zeros(6))

    _post_force(ctx, langevin)


@fix_style("addforce")
def build_addforce(ctx, spec):
    """fix addforce fx fy fz (fix_addforce.cpp): a constant force added on
    the group."""
    _nargs(spec, 3)
    g = _group(ctx, spec)
    fadd = _vec([float(v) for v in spec.args[:3]], ctx)

    def addforce(sys_, f_):
        return (f_ + torch.where((g & sys_.mask)[:, None], fadd[None, :],
                                 0.0),
                f_.new_zeros(6))

    _post_force(ctx, addforce)


@fix_style("aveforce")
def build_aveforce(ctx, spec):
    """fix aveforce fx fy fz (fix_aveforce.cpp): each non-NULL component of
    the group's forces set to the group's average plus the value."""
    _nargs(spec, 3)
    vals = [None if t == "NULL" else float(t) for t in spec.args[:3]]
    g = _group(ctx, spec)
    keep = torch.tensor([v is None for v in vals], device=ctx.device)
    add = _vec([0.0 if v is None else v for v in vals], ctx)
    ng = max(1, int(np.count_nonzero(ctx.script.groups[spec.group])))

    def aveforce(sys_, f_):
        sel = (g & sys_.mask)[:, None]
        favg = torch.sum(torch.where(sel, f_, 0.0), dim=0) / ng
        return (torch.where(sel & ~keep[None, :], (favg + add)[None, :], f_),
                f_.new_zeros(6))

    _post_force(ctx, aveforce)


@fix_style("spring/self")
def build_spring_self(ctx, spec):
    """fix spring/self K (fix_spring_self.cpp): each atom of the group
    tethered to its unwrapped position at definition."""
    _nargs(spec, 1)
    script = ctx.script
    k = float(spec.args[0])
    g = _group(ctx, spec)[:, None]
    x0 = torch.as_tensor(
        ctx.padA(script.x + script.image * (script.box_hi - script.box_lo)),
        dtype=ctx.dtype, device=ctx.device)

    def spring_self(sys_, f_):
        d = _unwrapped(sys_) - x0
        return (f_ - torch.where(g & sys_.mask[:, None], k * d, 0.0),
                f_.new_zeros(6))

    _post_force(ctx, spring_self)


@fix_style("viscous")
def build_viscous(ctx, spec):
    """fix viscous gamma (fix_viscous.cpp): f -= gamma v on the group."""
    _nargs(spec, 1)
    gam = float(spec.args[0])
    g = _group(ctx, spec)[:, None]

    def viscous(sys_, f_):
        return (f_ - torch.where(g & sys_.mask[:, None], gam * sys_.v, 0.0),
                f_.new_zeros(6))

    _post_force(ctx, viscous)


@fix_style("efield")
def build_efield(ctx, spec):
    """fix efield ex ey ez (fix_efield.cpp): f += qe2f q E on the group."""
    _nargs(spec, 3)
    e = _vec([float(v) for v in spec.args[:3]], ctx)
    g = _group(ctx, spec)[:, None]
    qe2f = _vec(ctx.u.qe2f, ctx)

    def efield(sys_, f_):
        fe = (qe2f * sys_.q)[:, None] * e[None, :]
        return (f_ + torch.where(g & sys_.mask[:, None], fe, 0.0),
                f_.new_zeros(6))

    _post_force(ctx, efield)


@fix_style("spring")
def build_spring(ctx, spec):
    """fix spring tether K x y z R0 | couple group2 K x y z R0
    (fix_spring.cpp spring_tether / spring_couple): the restoring force
    k (r - R0) on the group's unwrapped centre of mass along its non-NULL
    components, spread over the group by mass (and the opposite force on
    group2 under couple)."""
    a = list(spec.args)
    couple = a[0] == "couple"
    if couple:
        g2 = _group(ctx, spec, a[1])
        a = a[2:]
    elif a[0] == "tether":
        a = a[1:]
    else:
        raise ValueError(f"fix spring {a[0]}: tether or couple")
    _nargs(spec, 7 if couple else 6)
    k = float(a[0])
    tgt = [None if t == "NULL" else float(t) for t in a[1:4]]
    r0 = float(a[4])
    g = _group(ctx, spec)
    m = _masses(ctx)
    flags = torch.tensor([t is not None for t in tgt], device=ctx.device)
    tvals = _vec([0.0 if t is None else t for t in tgt], ctx)

    def xcm(sys_, gm):
        mg = torch.where(gm & sys_.mask, m, 0.0)
        mtot = torch.sum(mg)
        return torch.sum(mg[:, None] * _unwrapped(sys_), dim=0) / mtot, mtot

    def spring(sys_, f_):
        com1, m1 = xcm(sys_, g)
        if couple:
            com2, m2 = xcm(sys_, g2)
            dxv = com2 - com1 - tvals
        else:
            dxv = com1 - tvals
        dxv = torch.where(flags, dxv, 0.0)
        r = torch.sqrt(torch.sum(dxv * dxv))
        fvec = k * dxv * (r - r0) / torch.clamp(r, min=1e-10)
        pa1 = torch.where(g & sys_.mask, m, 0.0) / m1
        if couple:
            f_ = f_ + pa1[:, None] * fvec[None, :]
            pa2 = torch.where(g2 & sys_.mask, m, 0.0) / m2
            f_ = f_ - pa2[:, None] * fvec[None, :]
        else:
            f_ = f_ - pa1[:, None] * fvec[None, :]
        return f_, f_.new_zeros(6)

    _post_force(ctx, spring)


@fix_style("planeforce", "lineforce")
def build_projection(ctx, spec):
    """fix planeforce / lineforce x y z (fix_planeforce.cpp,
    fix_lineforce.cpp): the group's forces projected onto the plane normal
    to the vector, or onto its line."""
    _nargs(spec, 3)
    nvec = np.array([float(v) for v in spec.args[:3]])
    nvec /= np.linalg.norm(nvec)
    nt = _vec(nvec.tolist(), ctx)
    g = _group(ctx, spec)[:, None]
    line = spec.style == "lineforce"

    def projection(sys_, f_):
        fn = (f_ @ nt)[:, None] * nt[None, :]
        f2 = fn if line else f_ - fn
        return torch.where(g & sys_.mask[:, None], f2, f_), f_.new_zeros(6)

    _post_force(ctx, projection)


@fix_style("momentum")
def build_momentum(ctx, spec):
    """fix momentum N [linear x y z] (fix_momentum.cpp): every N steps the
    selected components of the group's centre-of-mass velocity taken out,
    at the end of the step."""
    a = list(spec.args)
    nev = int(a[0])
    dims = [1.0, 1.0, 1.0]
    rest = a[1:]
    if rest[:1] == ["linear"]:
        dims = [float(t) for t in rest[1:4]]
        rest = rest[4:]
    if rest:
        _nargs(spec, len(a) - len(rest))
    g = _group(ctx, spec)
    m = _masses(ctx)
    dsel = _vec(dims, ctx)

    def momentum(sys_, res_=None):
        if sys_.step % nev:
            return sys_
        sel = g & sys_.mask
        msel = torch.where(sel, m, 0.0)
        vcm = torch.sum(msel[:, None] * sys_.v, dim=0) / torch.sum(msel)
        return sys_.replace(v=sys_.v - torch.where(
            sel[:, None], (vcm * dsel)[None, :], 0.0))

    ctx.eos_hooks.append(momentum)


@fix_style("recenter")
def build_recenter(ctx, spec):
    """fix recenter x y z (fix_recenter.cpp): the group shifted so that
    its unwrapped centre of mass sits at the target at the end of every
    step; INIT (and NULL, whose component is left alone) take the centre
    of mass at definition."""
    _nargs(spec, 3)
    script = ctx.script
    gm = script.groups[spec.group]
    m0 = np.asarray(ctx.mass_atom)[:ctx.n][gm]
    xu0 = (script.x + script.image * (script.box_hi - script.box_lo))[gm]
    com0 = (m0[:, None] * xu0).sum(0) / m0.sum()
    toks = spec.args[:3]
    tgt = _vec([com0[d] if t in ("INIT", "NULL") else float(t)
                for d, t in enumerate(toks)], ctx)
    keep = torch.tensor([t == "NULL" for t in toks], device=ctx.device)
    g = _group(ctx, spec)
    m = _masses(ctx)

    def recenter(sys_, res_=None):
        sel = g & sys_.mask
        msel = torch.where(sel, m, 0.0)
        com = (torch.sum(msel[:, None] * _unwrapped(sys_), dim=0)
               / torch.sum(msel))
        shift = torch.where(keep, 0.0, tgt - com)
        return sys_.replace(x=sys_.x + torch.where(sel[:, None],
                                                   shift[None, :], 0.0))

    ctx.eos_hooks.append(recenter)


@fix_style("temp/rescale", "temp/berendsen")
def build_temp_fix(ctx, spec):
    """Deferred: Simulation.from_script builds it after the fix loop, when
    every constraint's dof is known (temp_fix_end_of_step)."""
    _nargs(spec, 5 if spec.style == "temp/rescale" else 3)
    ctx.pending_temp_fix = spec


def temp_fix_end_of_step(ctx, spec):
    """fix temp/rescale N Tstart Tstop window fraction
    (fix_temp_rescale.cpp) and temp/berendsen Tstart Tstop damp
    (fix_temp_berendsen.cpp) at the end of the step, as the JAX package
    builds them (its sim.py:1833-1896): the temperature of the fix's group
    on dof = dim ng - dim less the shake constraints with both atoms in
    the group and the dof of a rigid fix whose bodies all lie in it; the
    target is Tstart (no ramp).  rescale scales the group's velocities by
    sqrt(1 + fraction (T/Tcur - 1)) every N steps when |Tcur - T| >
    window; berendsen by sqrt(1 + dt/damp (T/Tcur - 1)) every step."""
    u, a = ctx.u, spec.args
    tgrp = ctx.script.groups[spec.group]
    rm = 0.0
    if ctx.shake_pairs is not None:
        pa, qa = ctx.shake_pairs
        rm += int(np.count_nonzero(tgrp[pa] & tgrp[qa]))
    for _, rsetup in ctx.rigid_groups:
        if np.all(ctx.groups[spec.group][rsetup.body_of_atom >= 0]):
            rm += rsetup.dof_removed
    dof = ctx.dim * int(np.count_nonzero(tgrp)) - ctx.dim - rm
    g = _group(ctx, spec)
    m = _masses(ctx)

    def t_cur(sys_):
        mg = torch.where(sys_.mask & g, m, 0.0)
        return u.mvv2e * torch.sum(mg[:, None] * sys_.v * sys_.v) \
            / (dof * u.boltz)

    if spec.style == "temp/rescale":
        nev, t_tgt = int(a[0]), float(a[1])
        window, fraction = float(a[3]), float(a[4])

        def rescale(sys_, res_=None):
            if sys_.step % nev:
                return sys_
            t = t_cur(sys_)
            lam = torch.sqrt(1.0 + fraction * (t_tgt / t - 1.0))
            scale = torch.where((torch.abs(t - t_tgt) > window) & g, lam,
                                1.0)
            return sys_.replace(v=sys_.v * scale[:, None])

        return rescale
    t_tgt, t_damp = float(a[0]), float(a[2])
    dt = ctx.script.dt

    def berendsen(sys_, res_=None):
        lam = torch.sqrt(1.0 + dt / t_damp * (t_tgt / t_cur(sys_) - 1.0))
        return sys_.replace(v=sys_.v * torch.where(g, lam, 1.0)[:, None])

    return berendsen


@fix_style("temp/csld")
def build_temp_csld(ctx, spec):
    """fix temp/csld Tstart Tstop damp seed (fix_temp_csld.cpp, as the JAX
    package's build_temp_cs gives it): at the end of every step the group's
    velocities become c1 v + c2 sqrt(kB T/m/mvv2e) r, c1 = exp(-dt/damp),
    c2 = sqrt(1 - c1^2), r normal from jax.random's stream keyed on
    fold_in(PRNGKey(seed), sys.step); T is Tstart (no ramp)."""
    from lidp_tpu_torch import threefry

    _nargs(spec, 4)
    u = ctx.u
    t_tgt, damp = float(spec.args[0]), float(spec.args[2])
    key0 = threefry.prng_key(int(spec.args[3]) & threefry.MASK32)
    g = _group(ctx, spec)
    m = _masses(ctx)
    c1 = math.exp(-ctx.script.dt / damp)
    c2 = math.sqrt(1.0 - c1 * c1)
    sig = torch.sqrt(u.boltz * t_tgt / torch.clamp(m, min=1e-300)
                     / u.mvv2e)[:, None]

    def csld(sys_, res_=None):
        key = threefry.fold_in(key0, sys_.step)
        r = threefry.normal(key, sys_.v.shape, sys_.v.dtype, sys_.v.device)
        vnew = c1 * sys_.v + c2 * sig * r
        return sys_.replace(v=torch.where((g & sys_.mask)[:, None], vnew,
                                          sys_.v))

    ctx.eos_hooks.append(csld)


def shake_pre_pass(script, mass_atom):
    """Simulation.from_script's pre-pass of fix shake / rattle (the JAX
    package's sim.py:1520-1566): the clusters (find_clusters) and the
    config (tolerance, max_iter), and the masks of the bonds and angles
    left to the bonded terms (the reference negates the constrained ones'
    types, fix_shake.cpp:681).  (None, None, None, None) without the fix
    or a constraint."""
    from lidp_tpu_torch.ops import shake as shake_mod

    spec = next((f for f in script.fixes.values()
                 if f.style in ("shake", "rattle")), None)
    if spec is None or script._bonds is None or not len(script._bonds):
        return None, None, None, None
    a = spec.args
    cfg = (float(a[0]), int(a[1]))
    lists = {"b": [], "a": [], "m": [], "t": []}
    key = None
    for tok in a[3:]:
        if tok in lists:
            key = tok
        elif key == "m":
            lists[key].append(float(tok))
        elif key is not None:
            lists[key].append(int(tok))
    br0 = np.zeros(max(script.bond_coeffs.keys(), default=0) + 1)
    for bt, co in script.bond_coeffs.items():
        br0[bt] = co[1]
    ath0 = np.zeros(max(script.angle_coeffs.keys(), default=0) + 1)
    for at, co in script.angle_coeffs.items():
        ath0[at] = np.deg2rad(co[1])
    has_ang = script._angles is not None and len(script._angles)
    found = shake_mod.find_clusters(
        script.x.shape[0], script._bonds - 1, script._bond_types,
        script._angles - 1 if has_ang else None, script._angle_types,
        mass_atom, b_types=lists["b"], a_types=lists["a"],
        masses=lists["m"], t_types=lists["t"], type_atom=script.type,
        bond_r0=br0, angle_theta0=ath0)
    if found is None:
        return None, cfg, None, None
    bond_keep = np.ones(len(script._bonds), bool)
    bond_keep[found[5]] = False
    angle_keep = None
    if has_ang:
        angle_keep = np.ones(len(script._angles), bool)
        angle_keep[found[6]] = False
    return found, cfg, bond_keep, angle_keep
