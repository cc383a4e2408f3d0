"""Modifier fix styles (lidp_tpu/styles/fix_modifiers.py): each builder
appends its hooks to the FixBuildCtx sinks.
  * post_force, fn(sys, f) -> (f, virial6), with the same hook for the
    setup pass unless noted: the constraint fixes shake and rattle (their
    setup variant takes dtfsq/2; rattle's velocity stage goes to
    ctx.rattle_params), setforce, enforce2d, langevin, addforce, external
    (the library caller's forces), aveforce,
    spring/self, viscous, efield, spring (tether and couple), planeforce,
    lineforce, the flat walls wall/lj93, wall/lj126, wall/lj1043 and
    wall/harmonic, wall/region and indent;
  * post_integrate, fn(sys) -> sys: wall/reflect and move;
  * end_of_step, fn(sys, res) -> sys: momentum, recenter and temp/csld;
  * temp/rescale and temp/berendsen, which Simulation.from_script builds
    after the fix loop from ctx.pending_temp_fix (their dof needs every
    constraint);
  * box/relax, which adds no hook: `minimize` reads it.
fix langevin and temp/csld draw from jax.random's stream (threefry.py),
keyed on the seed and sys.step as the JAX builders key theirs.  Where a
JAX builder reads fewer arguments than LAMMPS takes, the port raises on
the rest (ROADMAP queue 3 item 11).  The JAX module's other styles are
not ported (ROADMAP queue 1 item 6.1): io/script.py refuses them.  The
walls, indent and move take their coordinates as the JAX builders read
them: the walls and move in box units, indent in lattice units (ROADMAP
queue 3 item 22).
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


@fix_style("enforce2d")
def build_enforce2d(ctx, spec):
    """fix enforce2d (fix_enforce2d.cpp): f_z zeroed, with no virial, in
    the run and its setup pass; v_z, zero from velocity create in 2d,
    stays so.  The JAX builder applies it to every atom whatever the
    group, and so does the port."""
    _nargs(spec, 0)

    def enforce2d(sys_, f_):
        return (f_ * torch.tensor([1.0, 1.0, 0.0], dtype=f_.dtype,
                                  device=f_.device), f_.new_zeros(6))

    _post_force(ctx, enforce2d)


def box_relax_spec(args):
    """fix box/relax iso|aniso|x|y|z P ... [vmax V] (the keywords the JAX
    package's _box_relax reads, its io/script.py:2595-2611): the target
    pressure of each dimension (None where unset), iso, and vmax (0.0001
    by default).  Its other keywords (couple, nreset, fixedpoint, ...)
    raise: the JAX package skips them unread."""
    p_t = [None, None, None]
    iso = False
    vmax = 0.0001
    for i in range(0, len(args), 2):
        k = args[i]
        if k in ("iso", "aniso"):
            iso = k == "iso"
            p_t = [float(args[i + 1])] * 3
        elif k in ("x", "y", "z"):
            p_t["xyz".index(k)] = float(args[i + 1])
        elif k == "vmax":
            vmax = float(args[i + 1])
        else:
            raise NotImplementedError(
                f"fix box/relax keyword {k} is not ported (ROADMAP queue 1 "
                "item 6.1, the modifier fixes; the JAX package skips it "
                "unread: ROADMAP queue 3 item 11)")
    return p_t, iso, vmax


@fix_style("box/relax")
def build_box_relax(ctx, spec):
    """fix box/relax: no hook in a run; `minimize` reads its spec
    (io/script.py _box_relax), as the JAX package's does.  Its keywords
    are checked here."""
    box_relax_spec(spec.args)


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


@fix_style("external")
def build_external(ctx, spec):
    """fix ID group external pf/callback Ncall Napply | pf/array Napply
    (fix_external.cpp; the JAX package's build_external): per-atom forces
    from the library's caller, added to the group's forces.  pf/callback
    calls the callback registered by api.lammps.set_fix_external_callback,
    func(caller, step, nlocal, ids, x, fexternal), with that step's
    positions on the steps of the Ncall grid (at setup and inside the
    run), and adds the forces it filled on the Napply grid; they persist
    between calls.  That is one host round trip a call, and none on the
    other steps.  pf/array, and pf/callback with no callback registered,
    add every step the array fix_external_set_force gave (zeros without
    one)."""
    mode = spec.args[0] if spec.args else None
    if mode not in ("pf/callback", "pf/array"):
        raise ValueError(f"Illegal fix external command: {mode}")
    _nargs(spec, 3 if mode == "pf/callback" else 2)
    g = _group(ctx, spec)[:, None]
    fext = getattr(spec, "_fexternal", None)
    cb = getattr(spec, "_callback", None)
    n = ctx.n

    def dev(a):
        return torch.as_tensor(ctx.padA(np.asarray(a, float), 0.0),
                               dtype=ctx.dtype, device=ctx.device)

    fe0 = dev(np.zeros((n, 3)) if fext is None else fext)
    if mode == "pf/array" and int(spec.args[1]) != 1:
        raise NotImplementedError(
            "fix external pf/array with Napply != 1: the JAX package adds "
            "the array every step (ROADMAP queue 3 item 48)")
    if mode == "pf/array" or cb is None:
        def external(sys_, f_):
            return (f_ + torch.where(g & sys_.mask[:, None], fe0, 0.0),
                    f_.new_zeros(6))

        _post_force(ctx, external)
        return
    ncall, napply = int(spec.args[1]), int(spec.args[2])
    caller = getattr(spec, "_caller", None)
    ids = np.arange(1, n + 1)
    state = {"fe": fe0}

    def external_cb(sys_, f_):
        step = int(sys_.step)
        if step % ncall == 0:
            fe = np.zeros((n, 3))
            cb(caller, step, n, ids, sys_.x[:n].double().cpu().numpy(), fe)
            state["fe"] = dev(fe)
            spec._fexternal = fe
        if step % napply:
            return f_, f_.new_zeros(6)
        return (f_ + torch.where(g & sys_.mask[:, None], state["fe"], 0.0),
                f_.new_zeros(6))

    _post_force(ctx, external_cb)


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
    builds them (its sim.py:1833-1896): the temperature of the fix's group,
    or of the temp compute's group that `fix_modify ID temp` names, on dof
    = dim ng - dim less the shake constraints with both atoms in that
    group and the dof of a rigid fix whose bodies all lie in it; the
    target is Tstart (no ramp).  rescale scales the fix group's velocities
    by sqrt(1 + fraction (T/Tcur - 1)) every N steps when |Tcur - T| >
    window; berendsen by sqrt(1 + dt/damp (T/Tcur - 1)) every step."""
    u, a, script = ctx.u, spec.args, ctx.script
    tmod = script._fix_modify.get(spec.fid, {}).get("temp")
    tname = script.computes[tmod][0] if tmod is not None else spec.group
    tgrp = script.groups[tname]
    rm = 0.0
    if ctx.shake_pairs is not None:
        pa, qa = ctx.shake_pairs
        rm += int(np.count_nonzero(tgrp[pa] & tgrp[qa]))
    for _, rsetup in ctx.rigid_groups:
        if np.all(ctx.groups[tname][rsetup.body_of_atom >= 0]):
            rm += rsetup.dof_removed
    dof = ctx.dim * int(np.count_nonzero(tgrp)) - ctx.dim - rm
    g = _group(ctx, spec)
    tg = _group(ctx, spec, tname)
    m = _masses(ctx)

    def t_cur(sys_):
        mg = torch.where(sys_.mask & tg, m, 0.0)
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


_FACES = ("xlo", "xhi", "ylo", "yhi", "zlo", "zhi")


def _wall_faces(spec, nvals):
    """The faces of a wall fix: (dim, +1 for a lo face or -1 for hi, and
    the face's nvals numbers, its coordinate first), read as the JAX
    builders read them, in box units.  `units box` is their reading too;
    a coordinate EDGE, CONSTANT or a variable and any other keyword raise,
    where the JAX builders fail or skip them."""
    a = spec.args
    faces = []
    i = 0
    while i < len(a):
        if a[i] in _FACES:
            vals = a[i + 1:i + 1 + nvals]
            try:
                nums = [float(v) for v in vals]
            except ValueError:
                raise NotImplementedError(
                    f"fix {spec.style} {a[i]} {' '.join(vals)}: a face takes "
                    "numbers only (EDGE, CONSTANT and variables are not "
                    "ported: ROADMAP queue 1 item 6.1, the modifier fixes)"
                ) from None
            faces.append(("xyz".index(a[i][0]),
                          1.0 if a[i].endswith("lo") else -1.0, *nums))
            i += 1 + nvals
        elif a[i:i + 2] == ["units", "box"]:
            i += 2
        else:
            _nargs(spec, i)
    if not faces:
        raise ValueError(f"Illegal fix {spec.style} command")
    return faces


def _column(d, x):
    """(1, 3) bool selecting column d."""
    return (torch.arange(3, device=x.device) == d)[None, :]


@fix_style("wall/reflect")
def build_wall_reflect(ctx, spec):
    """fix wall/reflect face coord ... (FixWallReflect::post_integrate,
    fix_wall_reflect.cpp:188): an atom of the group past a face is
    mirrored back across it and its velocity component flipped, after the
    position update."""
    faces = _wall_faces(spec, 1)
    g = _group(ctx, spec)

    def wall_reflect(sys_):
        x_, v_ = sys_.x, sys_.v
        for d, sgn, coord in faces:
            past = ((x_[:, d] - coord) * sgn < 0) & g & sys_.mask
            sel = past[:, None] & _column(d, x_)
            x_ = torch.where(sel, 2.0 * coord - x_, x_)
            v_ = torch.where(sel, -v_, v_)
        return sys_.replace(x=x_, v=v_)

    ctx.pi_hooks.append(wall_reflect)


def _flat_wall_force(kind, delta, eps, sig, cut):
    """The force on an atom at distance delta from a wall, along the
    wall's normal (fix_wall_lj93.cpp, fix_wall_lj126.cpp,
    fix_wall_lj1043.cpp, fix_wall_harmonic.cpp, in the JAX builders' form;
    fix_wall_region.cpp's kernels are the same functions)."""
    rinv = 1.0 / delta
    if kind == "lj93":
        c1 = 6.0 / 5.0 * eps * sig**9
        c2 = 3.0 * eps * sig**3
        r4 = rinv**4
        return c1 * r4 * r4 * rinv * rinv - c2 * r4
    if kind == "lj126":
        c1 = 48.0 * eps * sig**12
        c2 = 24.0 * eps * sig**6
        r6 = rinv**6
        return (c1 * r6 - c2) * r6 * rinv
    if kind == "lj1043":
        c5 = 8.0 * math.pi * eps * sig**10
        c6 = 8.0 * math.pi * eps * sig**4
        c7 = 2.0 * math.pi * math.sqrt(2.0) * eps * sig**3
        d0 = 0.61 / math.sqrt(2.0) * sig
        r4 = rinv**4
        r10 = r4 * r4 * rinv * rinv
        rs = 1.0 / (delta + d0)
        return c5 * r10 * rinv - c6 * r4 * rinv - c7 * rs**4
    # harmonic: E = eps (cut - d)^2, the force toward the interior
    return 2.0 * eps * (cut - delta)


@fix_style("wall/lj93", "wall/lj126", "wall/lj1043", "wall/harmonic")
def build_wall_flat(ctx, spec):
    """fix wall/lj93|lj126|lj1043|harmonic face coord eps sigma cutoff ...
    (fix_wall.cpp's children): on each atom of the group at a distance d
    from a face with 0 < d < cutoff, the wall's force along its normal,
    in the run and its setup pass; no energy or virial, as in the JAX
    builder."""
    faces = _wall_faces(spec, 4)
    g = _group(ctx, spec)
    kind = spec.style.split("/")[1]

    def wall_flat(sys_, f_):
        for d, sgn, coord, eps, sig, cut in faces:
            delta = (sys_.x[:, d] - coord) * sgn
            act = g & sys_.mask & (delta > 0) & (delta < cut)
            fmag = _flat_wall_force(kind, torch.where(act, delta, 1.0), eps,
                                    sig, cut)
            fw = torch.where(act, fmag, 0.0) * sgn
            f_ = f_ + torch.where(_column(d, f_), fw[:, None], 0.0)
        return f_, f_.new_zeros(6)

    _post_force(ctx, wall_flat)


@fix_style("wall/region")
def build_wall_region(ctx, spec):
    """fix wall/region region-ID lj93|lj126|lj1043|harmonic eps sigma
    cutoff (fix_wall_region.cpp, side in): on each atom of the group
    within cutoff of a surface of the region (Region::surface_interior of
    a block's finite faces, a sphere, a cylinder's side and caps), the
    wall's force along the contact, in the JAX builder's form.  side out
    and the other region styles raise, as there."""
    _nargs(spec, 5)
    a = spec.args
    rname, kind = a[0], a[1]
    if kind not in ("lj93", "lj126", "lj1043", "harmonic"):
        raise NotImplementedError(
            f"fix wall/region style {kind} is not ported (ROADMAP queue 1 "
            "item 6.1, the modifier fixes)")
    eps, sig, cut = float(a[2]), float(a[3]), float(a[4])
    script = ctx.script
    reg = script.regions[rname]
    if script._region_kw[rname]["side"] != "in":
        raise NotImplementedError(
            "fix wall/region with a side out region is not ported (the JAX "
            "package raises too: ROADMAP queue 1 item 6.1, the modifier "
            "fixes)")
    s3 = script._region_spacing(rname)
    g = _group(ctx, spec)

    def axis_contact(x, d, coord, sgn):
        # a flat face: its distance and the contact vector along d
        rf = (x[:, d] - coord) * sgn
        return rf, torch.where(_column(d, x), (rf * sgn)[:, None], 0.0), \
            torch.ones_like(rf, dtype=torch.bool)

    if isinstance(reg[0], str) and reg[0] == "sphere":
        c = torch.tensor(np.asarray(reg[1:4], float) * s3, dtype=ctx.dtype,
                         device=ctx.device)
        rad = float(reg[4]) * s3[0]

        def contacts(x):
            d = x - c
            dist = torch.sqrt(torch.sum(d * d, 1))
            scale = 1.0 - rad / torch.where(dist > 0, dist, 1.0)
            return [(rad - dist, d * scale[:, None], dist > 0)]
    elif isinstance(reg[0], str) and reg[0] == "cylinder":
        axis = "xyz".index(reg[1])
        o1, o2 = [d for d in range(3) if d != axis]
        c1v, c2v = float(reg[2]) * s3[o1], float(reg[3]) * s3[o2]
        rad = float(reg[4]) * s3[o1]
        lo_a, hi_a = float(reg[5]) * s3[axis], float(reg[6]) * s3[axis]
        if not (math.isfinite(lo_a) and math.isfinite(hi_a)):
            # the JAX builder's cap contact at an INF bound is inf, its
            # force 0 * inf: NaN on every atom
            raise NotImplementedError(
                f"fix wall/region on cylinder {rname} with an INF cap (the "
                "JAX builder's forces are NaN there: ROADMAP queue 3 item "
                "22)")

        def contacts(x):
            d1 = x[:, o1] - c1v
            d2 = x[:, o2] - c2v
            dist = torch.sqrt(d1 * d1 + d2 * d2)
            scale = 1.0 - rad / torch.where(dist > 0, dist, 1.0)
            dl = torch.where(_column(o1, x), (d1 * scale)[:, None],
                             torch.where(_column(o2, x),
                                         (d2 * scale)[:, None], 0.0))
            return [(rad - dist, dl, dist > 0),
                    axis_contact(x, axis, lo_a, 1.0),
                    axis_contact(x, axis, hi_a, -1.0)]
    elif not isinstance(reg[0], str):
        # a block: each finite face (an INF bound takes no wall)
        b = np.asarray(reg, float) * np.repeat(s3, 2)
        planes = [(d, float(b[2 * d + k]), (1.0, -1.0)[k])
                  for d in range(3) for k in (0, 1)
                  if np.isfinite(b[2 * d + k])]

        def contacts(x):
            return [axis_contact(x, d, coord, sgn)
                    for d, coord, sgn in planes]
    else:
        raise ValueError(f"fix wall/region: region {rname} is a {reg[0]}; "
                         "the walls take a block, a sphere or a cylinder, "
                         "as the JAX builder does")

    def wall_region(sys_, f_):
        for r, dl, ok in contacts(sys_.x):
            act = g & sys_.mask & ok & (r > 0) & (r < cut)
            rsafe = torch.where(act, r, 1.0)
            fw = torch.where(act, _flat_wall_force(kind, rsafe, eps, sig,
                                                   cut), 0.0)
            f_ = f_ + fw[:, None] * dl / rsafe[:, None]
        return f_, f_.new_zeros(6)

    _post_force(ctx, wall_region)


@fix_style("indent")
def build_indent(ctx, spec):
    """fix indent K sphere x y z R (fix_indent.cpp, the JAX builder's
    form): on each atom of the group inside the sphere, F = K (R - r)^2
    outward along r, in the run and its setup pass; the centre and R in
    lattice units (R by the x spacing).  Other geometries, a variable
    centre and the keywords the JAX builder does not read raise; `side
    out` and `units lattice` are its reading."""
    a = spec.args
    if len(a) < 2 or a[1] != "sphere":
        raise NotImplementedError(
            f"fix indent {' '.join(a[1:2])}: the sphere only is ported, as "
            "in the JAX package (ROADMAP queue 1 item 6.1, the modifier "
            "fixes)")
    if any(t.startswith("v_") for t in a[:6]):
        raise NotImplementedError(
            "fix indent with a variable is not ported (the JAX builder "
            "reads numbers: ROADMAP queue 3 item 22)")
    rest = a[6:]
    if rest not in ([], ["side", "out"], ["units", "lattice"],
                    ["side", "out", "units", "lattice"],
                    ["units", "lattice", "side", "out"]):
        _nargs(spec, 6)
    k = float(a[0])
    s3 = ctx.script._spacing3()
    ctr = _vec([float(a[2]) * s3[0], float(a[3]) * s3[1],
                float(a[4]) * s3[2]], ctx)
    rad = float(a[5]) * float(s3[0])
    g = _group(ctx, spec)

    def indent(sys_, f_):
        d = sys_.x - ctr[None, :]
        r = torch.sqrt(torch.sum(d * d, dim=1))
        inside = (r < rad) & g & sys_.mask & (r > 1e-10)
        dr = r - rad
        fmag = torch.where(inside, -k * dr * dr
                           / torch.where(r > 1e-10, r, 1.0), 0.0)
        return f_ - fmag[:, None] * d, f_.new_zeros(6)

    _post_force(ctx, indent)


@fix_style("move")
def build_move(ctx, spec):
    """fix move linear Vx Vy Vz | wiggle Ax Ay Az period (fix_move.cpp
    LINEAR and WIGGLE, the JAX builder's form): after the position
    update the group's x and v are set to the prescribed motion from their
    unwrapped positions when the Simulation is built, in box units.
    NULL components, the other styles and keywords but `units box` raise,
    as the JAX builder refuses or skips them."""
    a = list(spec.args)
    mode = a[0] if a else ""
    if mode not in ("linear", "wiggle"):
        raise NotImplementedError(
            f"fix move {mode} is not ported (ROADMAP queue 1 item 6.1, the "
            "modifier fixes)")
    if any(t == "NULL" for t in a[1:4]):
        raise NotImplementedError(
            "fix move with NULL components is not ported, as in the JAX "
            "package (ROADMAP queue 1 item 6.1, the modifier fixes)")
    nv = 5 if mode == "wiggle" else 4
    if a[nv:] not in ([], ["units", "box"]):
        _nargs(spec, nv)
    vals = _vec([float(t) for t in a[1:4]], ctx)
    period = float(a[4]) if mode == "wiggle" else 1.0
    g = _group(ctx, spec)[:, None]
    script = ctx.script
    x0 = torch.as_tensor(
        ctx.padA(script.x + script.image * (script.box_hi - script.box_lo)),
        dtype=ctx.dtype, device=ctx.device)
    t0 = int(script.step)
    dt = script.dt
    omega = 2.0 * math.pi / period

    def move(sys_):
        # post_integrate runs before the step counter's increment, where
        # FixMove::initial_integrate sees the step it produces
        delta = (sys_.step + 1 - t0) * dt
        if mode == "linear":
            xm = x0 + delta * vals[None, :]
            vm = vals[None, :]
        else:
            xm = x0 + vals[None, :] * math.sin(omega * delta)
            vm = vals[None, :] * omega * math.cos(omega * delta)
        upd = g & sys_.mask[:, None]
        return sys_.replace(x=torch.where(upd, xm, sys_.x),
                            v=torch.where(upd, vm, sys_.v))

    ctx.pi_hooks.append(move)
