"""Modifier fix styles (lidp_tpu/styles/fix_modifiers.py): each builder
appends its hooks to the FixBuildCtx sinks.
  * post_force, fn(sys, f) -> (f, virial6), with the same hook for the
    setup pass unless noted: the constraint fixes shake and rattle (their
    setup variant takes dtfsq/2; rattle's velocity stage goes to
    ctx.rattle_params), setforce, enforce2d, langevin, addforce, external
    (the library caller's forces), aveforce, spring/self, viscous, efield,
    spring (tether and couple), spring/rg, spring/chunk, drag, restrain
    (its K ramp a per-run factory), planeforce, lineforce, the flat walls
    wall/lj93, wall/lj126, wall/lj1043 and wall/harmonic, wall/region and
    indent;
  * post_integrate, fn(sys) -> sys: wall/reflect and move;
  * end_of_step, fn(sys, res) -> sys: momentum, recenter, temp/csld,
    temp/csvr, heat, ehex and press/berendsen;
  * temp/rescale and temp/berendsen, which Simulation.from_script builds
    after the fix loop from ctx.pending_temp_fix (their dof needs every
    constraint);
  * what Simulation.run applies per run or at its chunks' boundaries:
    deform, tmd (tmd_hook), adapt, halt and dt/reset; store/force's
    per-atom values (computes.peratom_column) and box/relax (which
    `minimize` reads) add no hook.
fix langevin, temp/csld and temp/csvr draw from jax.random's stream
(threefry.py), keyed on the seed and sys.step as the JAX builders key
theirs.  Where a JAX builder reads fewer arguments than LAMMPS takes, the
port raises on the rest (ROADMAP queue 3 item 11).  fix neb belongs to the
neb command (ROADMAP queue 1 item 6.12).  The walls, indent and move take
their coordinates as the JAX builders read them: the walls and move in
box units, indent in lattice units (ROADMAP queue 3 item 22).
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


def _skipped(what):
    """Refuse what a JAX builder skips unread or refuses (ROADMAP queue 3
    item 11)."""
    raise NotImplementedError(
        f"{what} is not ported (ROADMAP queue 1 item 6.1, the modifier "
        "fixes; the JAX package skips it unread or refuses it: ROADMAP "
        "queue 3 item 11)")


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


# ------------------- the rest of the modifier fixes -------------------


def _zero6(f_):
    return f_.new_zeros(6)


@fix_style("drag")
def build_drag(ctx, spec):
    """fix drag x y z fmag delta (fix_drag.cpp): a force of magnitude fmag
    toward the point (a NULL coordinate ignored) on each group atom
    farther than delta, the distance min-imaged."""
    from lidp_tpu_torch.box import minimum_image

    _nargs(spec, 5)
    a = spec.args
    tgt = [None if t == "NULL" else float(t) for t in a[:3]]
    fmag, delta = float(a[3]), float(a[4])
    g = _group(ctx, spec)
    flags = torch.tensor([t is not None for t in tgt], device=ctx.device)
    tvals = _vec([0.0 if t is None else t for t in tgt], ctx)

    def drag(sys_, f_):
        d = minimum_image(sys_.x - tvals, sys_.box.img_lengths)
        d = torch.where(flags, d, 0.0)
        r = torch.sqrt(torch.sum(d * d, dim=1))
        act = g & sys_.mask & (r > delta)
        pref = torch.where(act, fmag / torch.where(r > 0, r, 1.0), 0.0)
        return f_ - pref[:, None] * d, _zero6(f_)

    _post_force(ctx, drag)


@fix_style("spring/rg")
def build_spring_rg(ctx, spec):
    """fix spring/rg K RG0 (fix_spring_rg.cpp): f_i = -2K(1 - rg0/rg)
    (xu_i - xcm) m_i/M on the group's unwrapped positions; RG0 NULL takes
    the group's radius of gyration from the data (FixSpringRG::init), as
    the JAX package computes it on the host."""
    _nargs(spec, 2)
    k_rg = float(spec.args[0])
    if spec.args[1] == "NULL":
        script = ctx.script
        gmh = script.groups[spec.group]
        mh = np.asarray(ctx.mass_atom)[:len(gmh)][gmh]
        xuh = (script.x + script.image
               * (script.box_hi - script.box_lo))[gmh]
        comh = (mh[:, None] * xuh).sum(0) / mh.sum()
        rg0 = float(np.sqrt((mh * ((xuh - comh) ** 2).sum(1)).sum()
                            / mh.sum()))
    else:
        rg0 = float(spec.args[1])
    g = _group(ctx, spec)
    m_all = _masses(ctx)

    def spring_rg(sys_, f_):
        m = torch.where(g & sys_.mask, m_all, 0.0)
        xu = _unwrapped(sys_)
        M = torch.sum(m)
        com = torch.sum(m[:, None] * xu, dim=0) / M
        d = xu - com
        rg = torch.sqrt(torch.sum(m * torch.sum(d * d, dim=1)) / M)
        term = 2.0 * k_rg * (1.0 - rg0 / rg)
        return f_ - term * d * (m / M)[:, None], _zero6(f_)

    _post_force(ctx, spring_rg)


@fix_style("spring/chunk")
def build_spring_chunk(ctx, spec):
    """fix spring/chunk K chunkID comID (fix_spring_chunk.cpp, as the JAX
    package's sim.py:1716-1779 builds it): a spring on each chunk's centre
    of mass to where it stood at setup, f_i -= m_i K d/(|d| M) of the
    atom's chunk; the chunks are static (molecule or type, ID 0 in no
    chunk), as the reference locks them."""
    _nargs(spec, 3)
    script = ctx.script
    k_sp, cid = float(spec.args[0]), spec.args[1]
    if cid not in script.computes or script.computes[cid][1] \
            != "chunk/atom":
        raise ValueError(f"fix spring/chunk: {cid} is not a compute "
                         "chunk/atom")
    which = script.computes[cid][2]["which"]
    n = ctx.n
    if which == "molecule":
        raw = np.asarray(script.mol)[:n]
    elif which == "type":
        raw = np.asarray(script.type)[:n]
    else:
        raise NotImplementedError(
            "fix spring/chunk needs a molecule or type chunk/atom (bin "
            "chunks move with the atoms; the JAX package refuses them too)")
    valid = raw > 0
    _, inv = np.unique(raw[valid], return_inverse=True)
    nch = int(inv.max()) + 1 if len(inv) else 0
    ids_full = np.full(n, nch, np.int64)
    ids_full[valid] = inv
    ids = torch.as_tensor(ctx.padA(ids_full, nch), device=ctx.device)
    g = _group(ctx, spec) & torch.as_tensor(ctx.padA(valid, False),
                                            device=ctx.device)
    m_all = _masses(ctx)

    def coms(sys_):
        me = torch.where(g & sys_.mask, m_all, 0.0)
        xu = _unwrapped(sys_)
        M = me.new_zeros(nch + 1).index_add_(0, ids, me)
        s = xu.new_zeros((nch + 1, 3)).index_add_(0, ids, me[:, None] * xu)
        return me, M, s / torch.where(M > 0, M, 1.0)[:, None]

    com0 = coms(ctx.sys)[2]

    def spring_chunk(sys_, f_):
        me, M, com = coms(sys_)
        d = com - com0
        r = torch.clamp(torch.sqrt(torch.sum(d * d, dim=1)), min=1.0e-10)
        Msafe = torch.where(M > 0, M, 1.0)
        fcom = torch.where((M > 0)[:, None], k_sp * d / (r * Msafe)[:, None],
                           0.0)
        return f_ - me[:, None] * fcom[ids], _zero6(f_)

    _post_force(ctx, spring_chunk)


@fix_style("restrain")
def build_restrain(ctx, spec):
    """fix restrain bond i j Kstart Kstop r0 | angle i j k Kstart Kstop
    theta0 | dihedral i j k l Kstart Kstop phi0 (fix_restrain.cpp, the
    JAX package's terms): harmonic bond and angle restraints and the
    dihedral's K(1 + cos(phi - phi0)), min-imaged, their forces the
    negative gradient (autograd on the restrained atoms alone), K ramped
    over each run's window, which Simulation.run sets through
    ctx.restrain_factory; no energy or virial is tallied, as in the JAX
    package."""
    from lidp_tpu_torch.ops.bonded import _mi

    a = list(spec.args)
    terms = []
    i = 0
    while i < len(a):
        kind = a[i]
        nat = {"bond": 2, "angle": 3, "dihedral": 4}.get(kind)
        if nat is None:
            _skipped(f"fix restrain keyword {kind}")
        ids = tuple(int(t) - 1 for t in a[i + 1:i + 1 + nat])
        ks, kp, p0 = (float(t) for t in a[i + 1 + nat:i + 4 + nat])
        if kind != "bond":
            p0 = p0 * np.pi / 180.0
        terms.append((kind, ids, ks, kp, p0))
        i += 4 + nat
    atoms = sorted({j for t in terms for j in t[1]})
    pos = {j: k for k, j in enumerate(atoms)}
    idx = torch.as_tensor(atoms, device=ctx.device)

    def energy(xs, box, delta):
        e = xs.new_zeros(())
        for kind, ids, ks, kp, p0 in terms:
            k = ks + delta * (kp - ks)
            p = [xs[pos[j]] for j in ids]
            if kind == "bond":
                d = _mi(p[0] - p[1], box)
                e = e + k * (torch.sqrt(torch.sum(d * d)) - p0) ** 2
            elif kind == "angle":
                d1, d2 = _mi(p[0] - p[1], box), _mi(p[2] - p[1], box)
                c = torch.sum(d1 * d2) / torch.sqrt(
                    torch.sum(d1 * d1) * torch.sum(d2 * d2))
                c = torch.clamp(c, -1.0 + 1e-12, 1.0 - 1e-12)
                e = e + k * (torch.arccos(c) - p0) ** 2
            else:
                b1 = _mi(p[1] - p[0], box)
                b2 = _mi(p[2] - p[1], box)
                b3 = _mi(p[3] - p[2], box)
                n1 = torch.linalg.cross(b1, b2)
                n2 = torch.linalg.cross(b2, b3)
                phi = torch.atan2(torch.sqrt(torch.sum(b2 * b2))
                                  * torch.sum(b1 * n2), torch.sum(n1 * n2))
                e = e + k * (1.0 + torch.cos(phi - p0))
        return e

    def make_hook(window):
        w0, w1 = window

        def restrain(sys_, f_):
            delta = min(max((sys_.step - w0) / max(w1 - w0, 1), 0.0), 1.0)
            with torch.enable_grad():
                xs = sys_.x[idx].detach().requires_grad_(True)
                g, = torch.autograd.grad(energy(xs, sys_.box, delta), xs)
            return f_.index_add(0, idx, -g), _zero6(f_)

        return restrain

    hook = make_hook((0, 1))
    _post_force(ctx, hook)
    if any(t[2] != t[3] for t in terms):
        ctx.restrain_factory = (make_hook, hook)


@fix_style("store/force")
def build_store_force(ctx, spec):
    """fix store/force (fix_store_force.cpp): its f_ID per-atom columns
    are the force before any post_force fix, which computes.peratom_column
    evaluates from the current positions when a dump or compute reduce
    reads them, as the JAX package does; no hook."""
    _nargs(spec, 0)


@fix_style("heat")
def build_heat(ctx, spec):
    """fix heat N flux (fix_heat.cpp, constant flux): every N steps the
    group's velocities v' = s v - (s - 1) vcm with s = sqrt((ke + dE - kcm)
    / (ke - kcm)), dE = flux N dt in 0.5 m v^2 units (times ftm2v)."""
    _nargs(spec, 2)
    nevery, flux = int(spec.args[0]), float(spec.args[1])
    g = _group(ctx, spec)
    m_all = _masses(ctx)
    de = flux * nevery * ctx.script.dt * ctx.u.ftm2v

    def heat(sys_, res_=None):
        if sys_.step % nevery:
            return sys_
        sel = g & sys_.mask
        m = torch.where(sel, m_all, 0.0)
        M = torch.sum(m)
        vcm = torch.sum(m[:, None] * sys_.v, dim=0) / M
        ke = 0.5 * torch.sum(m[:, None] * sys_.v ** 2)
        kcm = 0.5 * torch.sum(vcm * vcm) * M
        s = torch.sqrt((ke + de - kcm) / (ke - kcm))
        vnew = s * sys_.v - (s - 1.0) * vcm[None, :]
        return sys_.replace(v=torch.where(sel[:, None], vnew, sys_.v))

    ctx.eos_hooks.append(heat)


def _region_matcher(ctx, rname):
    """Region::match on the device for a block or sphere region (the JAX
    package's _traced_region_match): each point wrapped into the current
    box on its periodic dimensions (Domain::remap, so a box that moves is
    followed), then the bounds tested inclusively, an INF lower bound
    unbounded, side out inverting."""
    script = ctx.script
    r = script.regions[rname]
    s3 = np.asarray(script._region_spacing(rname), float)
    per = torch.tensor(tuple(bool(p) for p in script.periodic),
                       device=ctx.device)
    side_out = script._region_kw[rname]["side"] == "out"

    def remap(x, box):
        L = box.lengths
        w = box.lo + torch.remainder(x - box.lo, L)
        return torch.where(per, w, x)

    if not isinstance(r[0], str):
        lo_hi = np.asarray(r, float) * np.repeat(s3, 2)
        lo = lo_hi[0::2].copy()
        lo[np.isinf(lo)] = -np.inf
        lo = _vec(np.clip(lo, -1e30, 1e30), ctx)
        hi = _vec(np.clip(lo_hi[1::2], -1e30, 1e30), ctx)

        def match(x, box):
            xw = remap(x, box)
            m = torch.all((xw >= lo) & (xw <= hi), dim=1)
            return ~m if side_out else m
    elif r[0] == "sphere":
        c = _vec(np.array(r[1:4]) * s3, ctx)
        rad2 = float(r[4] * s3[0]) ** 2

        def match(x, box):
            d = remap(x, box) - c
            m = torch.sum(d * d, dim=1) <= rad2
            return ~m if side_out else m
    else:
        raise NotImplementedError(
            f"fix ehex region {rname} of style {r[0]}: the JAX package "
            "matches block and sphere regions alone (ROADMAP queue 3 item "
            "22)")
    return match


@fix_style("ehex")
def build_ehex(ctx, spec):
    """fix ehex N F [region R] [hex] (RIGID/fix_ehex.cpp, eHEX/a of
    Wirnsberger et al.): every N steps the reservoir's velocities rescale
    about its centre of mass by sqrt(1 + F dt/Kr), F = heat ftm2v N, and,
    unless `hex`, the positions take the third-order correction x -= dt^3
    epsr (fix_ehex.cpp:283-300); the reservoir is the group within the
    region, matched on the device each step; an emptied reservoir skips
    the update and 1 + F dt/Kr is floored at 0, as in the JAX package."""
    a = list(spec.args)
    nevery, heat = int(a[0]), float(a[1])
    rname, hex_only = None, False
    i = 2
    while i < len(a):
        if a[i] == "region":
            rname = a[i + 1]
            i += 2
        elif a[i] == "hex":
            hex_only = True
            i += 1
        elif a[i] in ("constrain", "com"):
            _skipped(f"fix ehex keyword {a[i]}")
        else:
            raise ValueError(f"Illegal fix ehex keyword {a[i]}")
    g = _group(ctx, spec)
    m_all = _masses(ctx)
    F = heat * ctx.u.ftm2v * nevery
    dt = ctx.script.dt
    ftm2v = ctx.u.ftm2v
    match = None
    if rname is not None:
        match = _region_matcher(ctx, rname)
        sel0 = (np.asarray(ctx.script.groups[spec.group], bool)
                & np.asarray(ctx.script._region_mask(rname), bool))
        if not sel0.any():
            raise ValueError(f"fix ehex: region {rname} selects no atoms of "
                             f"group {spec.group} at setup")

    def ehex(sys_, res_=None):
        if sys_.step % nevery:
            return sys_
        sel = g & sys_.mask
        if match is not None:
            sel = sel & match(sys_.x, sys_.box)
        m = torch.where(sel, m_all, 0.0)
        mr = torch.sum(m)
        on = mr > 1e-14
        vcm = torch.sum(m[:, None] * sys_.v, dim=0) / torch.clamp(
            mr, min=1e-300)
        ke = 0.5 * torch.sum(m[:, None] * sys_.v ** 2)
        kr = torch.clamp(ke - 0.5 * mr * torch.sum(vcm * vcm), min=1e-300)
        f_ = res_.f
        fsel = torch.where(sel[:, None], f_, 0.0)
        sfr = torch.sum(fsel, dim=0)
        sfvr = torch.sum(fsel * sys_.v) - torch.dot(vcm, sfr)
        scale = torch.where(on, torch.sqrt(torch.clamp(1.0 + F * dt / kr,
                                                       min=0.0)), 1.0)
        vnew = torch.where(sel[:, None],
                           scale * sys_.v - (scale - 1.0) * vcm, sys_.v)
        if hex_only:
            return sys_.replace(v=vnew)
        eta = m_all[:, None] * F / (2.0 * kr) * (sys_.v - vcm)
        epsr = (eta / (m_all[:, None] * kr) * (F / 48.0 + sfvr / 6.0 * ftm2v)
                - F / (12.0 * kr) * (f_ / m_all[:, None] - sfr / mr) * ftm2v)
        corr = torch.where(sel[:, None] & on, dt ** 3 * epsr, 0.0)
        return sys_.replace(x=sys_.x - corr, v=vnew)

    ctx.eos_hooks.append(ehex)


@fix_style("temp/csvr")
def build_temp_csvr(ctx, spec):
    """fix temp/csvr Tstart Tstop damp seed (the Bussi-Donadio-Parrinello
    rescale, fix_temp_csvr.cpp, as the JAX package's build_temp_cs gives
    it): at the end of every step the group's velocities scale by
    sqrt(K'/K), K' = K + (1 - c)(Kt (r1^2 + R)/dof - K) + 2 r1 sqrt(c (1 -
    c) Kt K/dof), c = exp(-dt/damp), Kt = dof kB T/2 with T = Tstart (no
    ramp), r1 normal and R twice a Gamma((dof - 1)/2) draw from jax.random's
    stream keyed on fold_in(PRNGKey(seed), step) and split in two
    (threefry.normal_scalar, threefry.gamma_draw: the host draws the two
    scalars, bit for bit with the JAX package's on the CPU, and the
    device only scales)."""
    from lidp_tpu_torch import threefry

    _nargs(spec, 4)
    u, a = ctx.u, spec.args
    t_tgt, damp = float(a[0]), float(a[2])
    key0 = threefry.prng_key(int(a[3]) & threefry.MASK32)
    g = _group(ctx, spec)
    m_all = _masses(ctx)
    dof = ctx.dim * int(np.count_nonzero(ctx.script.groups[spec.group])) \
        - ctx.dim
    ke_t = 0.5 * dof * u.boltz * t_tgt
    c = math.exp(-ctx.script.dt / damp)
    dtype = ctx.dtype

    def csvr(sys_, res_=None):
        k1, k2 = threefry.split(threefry.fold_in(key0, sys_.step))
        r1 = float(threefry.normal_scalar(k1, dtype))
        rr = 2.0 * float(threefry.gamma_draw(k2, (dof - 1) / 2.0, dtype)[0])
        sel = g & sys_.mask
        m = torch.where(sel, m_all, 0.0)
        ke = 0.5 * u.mvv2e * torch.sum(m[:, None] * sys_.v ** 2)
        ke_new = (ke + (1.0 - c) * (ke_t * (r1 * r1 + rr) / dof - ke)
                  + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * ke_t * ke / dof))
        s = torch.sqrt(torch.clamp(ke_new, min=0.0) / ke)
        return sys_.replace(v=torch.where(sel[:, None], s * sys_.v, sys_.v))

    ctx.eos_hooks.append(csvr)


@fix_style("press/berendsen")
def build_press_berendsen(ctx, spec):
    """fix press/berendsen iso|aniso Pstart Pstop Pdamp | x|y|z Pstart
    Pstop Pdamp [modulus B] (fix_press_berendsen.cpp): at the end of every
    step the box and the atoms dilate about the box centre by mu_d = (1 -
    dt/Pdamp (P - P_d)/B)^(1/3), P_d from the step's virial and the
    kinetic tensor of all atoms (iso their trace over dim), P = Pstart (no
    ramp, as in the JAX package)."""
    from lidp_tpu_torch.box import Box

    a = list(spec.args)
    p_start = [None] * 3
    p_period = [0.0] * 3
    iso, bulkmod = False, 10.0
    i = 0
    while i < len(a):
        k = a[i]
        if k in ("iso", "aniso"):
            iso = k == "iso"
            p_start = [float(a[i + 1])] * 3
            p_period = [float(a[i + 3])] * 3
            i += 4
        elif k in ("x", "y", "z"):
            d = "xyz".index(k)
            p_start[d] = float(a[i + 1])
            p_period[d] = float(a[i + 3])
            i += 4
        elif k == "modulus":
            bulkmod = float(a[i + 1])
            i += 2
        else:
            _skipped(f"fix press/berendsen keyword {k}")
    p_flag = [v is not None for v in p_start]
    if not any(p_flag):
        raise ValueError("fix press/berendsen needs a pressure keyword")
    u, dt, dim = ctx.u, ctx.script.dt, ctx.dim
    m_all = _masses(ctx)
    flags = torch.tensor(p_flag, device=ctx.device)
    tgt = _vec([v if v is not None else 0.0 for v in p_start], ctx)
    period = _vec([max(v, 1e-300) for v in p_period], ctx)

    def press_berendsen(sys_, res_):
        m = torch.where(sys_.mask, m_all, 0.0)
        v6 = res_.virial
        vol = sys_.box.volume
        if iso:
            mvv = u.mvv2e * torch.sum(m[:, None] * sys_.v ** 2)
            w = v6[0] + v6[1] + v6[2]
            p_cur = ((mvv + w) / (dim * vol) * u.nktv2p).expand(3)
        else:
            mvvd = u.mvv2e * torch.sum(m[:, None] * sys_.v ** 2, dim=0)
            p_cur = (mvvd + v6[:3]) / vol * u.nktv2p
        mu = torch.where(
            flags, (1.0 - dt / period * (tgt - p_cur) / bulkmod)
            ** (1.0 / 3.0), 1.0)
        lo, hi = sys_.box.lo, sys_.box.hi
        c = 0.5 * (lo + hi)
        box = Box(lo=(lo - c) * mu + c, hi=(hi - c) * mu + c,
                  periodic=sys_.box.periodic)
        return sys_.replace(x=c + (sys_.x - c) * mu, box=box)

    ctx.eos_hooks.append(press_berendsen)


@fix_style("halt")
def build_halt(ctx, spec):
    """fix halt N attribute op value [error|continue|message ...]
    (fix_halt.cpp:146): Simulation.run tests it at the run chunks'
    boundaries (the chunk divides N) on the thermo keyword or v_NAME; an
    error raises, else the run ends after the step's row, as in the JAX
    package."""
    from lidp_tpu_torch.io.script import THERMO_KEYWORDS

    a = spec.args
    if len(a) < 4 or a[2] not in ("<", "<=", ">", ">=", "==", "!="):
        raise ValueError(f"Illegal fix halt command: {' '.join(a)}")
    action = a[4] if len(a) > 4 else "break"
    if len(a) > 5 or action not in ("error", "break"):
        _skipped(f"fix halt keywords {' '.join(a[4:])} (the JAX package "
                 "reads one word, error or else a graceful stop)")
    if a[1] not in THERMO_KEYWORDS and not a[1].startswith(("v_", "c_")):
        _skipped(f"fix halt attribute {a[1]} (the JAX package looks it "
                 "up in its thermo row, where it never is, and never stops)")
    ctx.halt_spec = (int(a[0]), a[1], a[2], float(a[3]), action)


@fix_style("dt/reset")
def build_dt_reset(ctx, spec):
    """fix dt/reset N Tmin Tmax Xmax [units box|lattice]
    (fix_dt_reset.cpp): Simulation.run resets dt at setup and at the run
    chunks' boundaries on the steps N divides (Simulation._dt_reset); in
    lattice units Xmax scales by the x spacing."""
    a = list(spec.args)
    xmax = float(a[3])
    scale = "lattice"
    if len(a) > 4:
        if a[4] != "units" or len(a) != 6 or a[5] not in ("box", "lattice"):
            _skipped(f"fix dt/reset keywords {' '.join(a[4:])}")
        scale = a[5]
    if scale == "lattice":
        xmax *= float(ctx.script._spacing3()[0])
    ctx.dtreset_cfg = dict(
        nevery=max(1, int(a[0])),
        tmin=None if a[1] == "NULL" else float(a[1]),
        tmax=None if a[2] == "NULL" else float(a[2]),
        xmax=xmax, group=np.asarray(ctx.script.groups[spec.group]))


@fix_style("deform")
def build_deform(ctx, spec):
    """fix deform: Simulation.from_script parses it (sim.deform_config)
    and Simulation.run forms each run's schedule (integrate/driver.py
    DeformParams)."""
    ctx.deform_fix = spec


@fix_style("adapt")
def build_adapt(ctx, spec):
    """fix adapt N pair STYLE a * * v_NAME (fix_adapt.cpp, the JAX
    package's one form): the pair style's prefactor table follows the
    equal-style ramp(lo,hi) variable NAME over each run
    (ForceField.adapt)."""
    a = spec.args
    script = ctx.script
    if (len(a) != 7 or a[1] != "pair" or a[2] != script.pair.name
            or a[3:6] != ["a", "*", "*"] or not a[6].startswith("v_")):
        _skipped(f"fix adapt {' '.join(a)} (the JAX package adapts `pair "
                 "STYLE a * * v_NAME` of the pair style alone)")
    if script.pair.name != "soft":
        _skipped(f"fix adapt on pair_style {script.pair.name} (the JAX "
                 "package replaces the first coefficient table, pair "
                 "soft's prefactor A)")
    vname = a[6][2:]
    if vname not in script._ramp_vars:
        raise NotImplementedError(
            "fix adapt requires an equal-style ramp() variable of two "
            "constants, as in the JAX package")
    ctx.adapt = script._ramp_vars[vname]


@fix_style("tmd")
def build_tmd(ctx, spec):
    """fix ID group tmd rho_final target-file N [outfile] (fix_tmd.cpp, the
    JAX package's build_tmd): the holonomic constraint that drives the
    group's mass-weighted RMSD to the target linearly from its value at
    each run's start to rho_final; its correction of x and v follows the
    position update (Runner.tmd_hook).  With N > 0 the statistics file
    gets a row every N steps and its work sums grow every step: the port
    reads the step's five scalars to the host once a step, only while the
    file is open (the JAX package passes them through an ordered
    io_callback)."""
    import os

    script = ctx.script
    a = spec.args
    if len(a) not in (2, 3, 4):
        raise ValueError("Illegal fix tmd command")
    rho_stop = float(a[0])
    n = ctx.n
    xf = np.zeros((n, 3))
    seen = np.zeros(n, bool)
    with open(os.path.join(script.root, a[1])) as fh:
        for ln in fh:
            t = ln.split("#")[0].split()
            if len(t) in (4, 7):
                i = int(t[0]) - 1
                xf[i] = [float(v) for v in t[1:4]]
                seen[i] = True
    gm_host = np.asarray(script.groups[spec.group], bool)
    if not seen[gm_host].all():
        raise ValueError("fix tmd target file missing group atoms")
    mass = np.asarray(ctx.mass_atom[:n], float)
    mt = float(mass[gm_host].sum())
    nevery = int(a[2]) if len(a) > 2 else 0
    stat = None
    if nevery:
        if len(a) < 4:
            raise ValueError("Illegal fix tmd command")
        fh = open(os.path.join(script.root, a[3]), "w")
        fh.write("# Step rho_target rho_old gamma_back gamma_forward lambda "
                 "work_lambda work_analytical\n")
        # the statistics take dt and the unhalved dtf (fix_tmd.cpp:166)
        stat = dict(fh=fh, work_lambda=0.0, work_analytical=0.0,
                    previous=0, nevery=nevery)
        script._tmd_stat = stat
    ctx.tmd_factory = dict(
        rho_stop=rho_stop, xf=xf, gm=gm_host, mass=mass, mt=mt, stat=stat,
        gmj=_group(ctx, spec)[:, None],
        mj=torch.where(_group(ctx, spec), torch.as_tensor(
            ctx.padA(mass, 0.0), dtype=ctx.dtype, device=ctx.device), 0.0),
        xfj=torch.as_tensor(ctx.padA(xf, 0.0), dtype=ctx.dtype,
                            device=ctx.device),
        ftm2v=ctx.u.ftm2v)


def tmd_hook(cfg, window, rho_start, dt):
    """fix tmd's Runner hook for one run (the JAX package's make_hook):
    (x_prev, image_prev, sys, res) -> sys after initial_integrate, the
    constraint's multiplier solving FixTMD's quadratic for the step's
    target rho (ntimestep = sys.step + 1 there)."""
    from lidp_tpu_torch.box import unwrap

    begin, end = window
    rho_stop, mt, stat = cfg["rho_stop"], cfg["mt"], cfg["stat"]
    gmj, mj, xfj = cfg["gmj"], cfg["mj"], cfg["xfj"]
    dtv, dtf = dt, dt * cfg["ftm2v"]

    def rho_at(tstep):
        delta = min(max((tstep - begin) / max(end - begin, 1), 0.0), 1.0)
        return rho_start + delta * (rho_stop - rho_start)

    def hook(x_prev, image_prev, sys_, res_):
        xold = unwrap(x_prev, sys_.box, image_prev)
        xcur = unwrap(sys_.x, sys_.box, sys_.image)
        dxold = torch.where(gmj, xold - xfj, 0.0)
        dx = torch.where(gmj, xcur - xfj, 0.0)
        a = torch.sum(mj[:, None] * dxold * dxold) / mt
        b = 2.0 * torch.sum(mj[:, None] * dx * dxold) / mt
        e = torch.sum(mj[:, None] * dx * dx) / mt

        def gamma(rho):
            c = e - rho * rho
            d = torch.clamp(b * b - 4.0 * a * c, min=0.0)
            gmax = torch.where(b >= 0, -b - torch.sqrt(d),
                               -b + torch.sqrt(d)) / (2.0 * a)
            return torch.where(a == 0.0, 0.0, c / (
                a * torch.where(gmax == 0.0, 1.0, gmax)))

        tstep = sys_.step + 1
        rho_t = rho_at(tstep)
        gfwd = gamma(rho_t)
        if stat is not None:
            rho_old = rho_at(tstep - 1)
            gback = gamma(rho_old)
            dxkt = xcur + gback * dxold - xold
            kt = torch.sum(mj[:, None] * dxkt * dxkt)
            fr = torch.sum(torch.where(gmj, res_.f, 0.0) * dxold)
            gb, gf, fr, kt = (float(v) for v in torch.stack(
                [gback, gfwd, fr, kt]).double().cpu())
            stat["work_analytical"] += (
                (-fr - kt / dtv / dtf) * (rho_t - rho_old)
                / (rho_old if rho_old != 0.0 else 1.0))
            lam = gb * rho_old * mt / dtv / dtf
            stat["work_lambda"] += lam * (rho_t - rho_old)
            if tstep % stat["nevery"] == 0 and stat["previous"] != tstep:
                stat["fh"].write("%d %g %g %g %g %g %g %g\n" % (
                    tstep, rho_t, rho_old, gb, gf, lam,
                    stat["work_lambda"], stat["work_analytical"]))
                stat["fh"].flush()
                stat["previous"] = tstep
        return sys_.replace(x=sys_.x + gfwd * dxold,
                            v=sys_.v + (gfwd / dtv) * dxold)

    return hook
