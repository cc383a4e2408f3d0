"""Time-integration fix styles (lidp_tpu/styles/fix_integrators.py): nve,
nve/limit, nve/noforce, nvt, npt, nph, the point-sphere nvt/sphere,
npt/sphere and nph/sphere, rigid/nve, rigid/nvt, rigid/npt and rigid/nph
(with their /small forms).  Each builder sets ctx.integ.  nvt/sllod needs
the triclinic box of fix deform's tilt and raises (ROADMAP queue 1 item
6.4).  Where the JAX package skips a keyword it does not know (build_npt's
`else: i += 2`, build_rigid's `else: i += 1`), the port raises (ROADMAP
queue 3 item 11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.integrate import nve as nve_mod
from lidp_tpu_torch.integrate import nvt as nvt_mod
from lidp_tpu_torch.integrate import rigid as rigid_mod
from lidp_tpu_torch.integrate.driver import (npt_integrator, nve_integrator,
                                             nvt_integrator,
                                             rigid_nve_integrator)
from lidp_tpu_torch.styles import fix_style

_BREADTH = "ROADMAP queue 1 item 6, breadth"
# keywords the JAX package's builders skip without reading them
_SKIPPED = ("ROADMAP queue 1 item 6, breadth; the JAX package skips it "
            "unread: ROADMAP queue 3 item 11")


@fix_style("nve", "nve/limit", "nve/noforce", integrator=True)
def build_nve(ctx, spec):
    """fix nve, nve/limit xmax (each half-kick clamps |v| to xmax/dt,
    fix_nve_limit.cpp) and nve/noforce (the positions drift, the
    velocities are never kicked, fix_nve_noforce.cpp).  Sub-group nve:
    only the fix group integrates (atoms outside any time-integration fix
    do not move)."""
    nargs = {"nve": 0, "nve/limit": 1, "nve/noforce": 0}[spec.style]
    if len(spec.args) != nargs:
        raise NotImplementedError(
            f"fix {spec.style} arguments {' '.join(spec.args)}: the JAX "
            f"package reads {nargs} ({_SKIPPED})")
    gmask = ctx.groups[spec.group]
    gmask_real = ctx.script.groups[spec.group]
    nvep = nve_mod.NVEParams.create(
        ctx.script.dt, ctx.u.ftm2v, ctx.mass_atom, dtype=ctx.dtype,
        gmask=None if gmask_real.all() else gmask, device=ctx.device,
        xlimit=float(spec.args[0]) if spec.style == "nve/limit" else None,
        noforce=spec.style == "nve/noforce")
    ctx.integ = nve_integrator(nvep)


def _sphere_rot(ctx, style):
    """(dof, the rotational KE-tensor diagonal (3,)) of the */sphere
    Nose-Hoover fixes off the granular route, as the JAX package's
    _sphere_rot forms them (fix_nh_sphere.cpp, compute_temp_sphere.cpp):
    2 dim dof for each finite-radius atom, dim for a point atom, less dim;
    0.4 m r^2 w_d^2 summed over the atoms from the data's omega.  Central
    forces exert no torque, so omega changes only through the
    thermostat's scale, which the integrator tracks as a scalar."""
    script, dim_, n = ctx.script, ctx.dim, ctx.n
    if script.radius is None:
        raise ValueError(f"fix {style} requires atom style sphere")
    r = np.asarray(script.radius, float)
    m = np.asarray(script.rmass, float)
    w = (np.zeros((n, 3)) if script.omega is None
         else np.asarray(script.omega, float))
    nfin = int((r > 0).sum())
    dof = (2 * dim_ * nfin + dim_ * (n - nfin)) - dim_
    inert = 0.4 * m * r * r
    return dof, (inert[:, None] * w * w).sum(0) * ctx.u.mvv2e


@fix_style("nvt", "nvt/sllod", "nvt/sphere", integrator=True)
def build_nvt(ctx, spec):
    """fix nvt and nvt/sphere temp Tstart Tstop Tdamp [tchain N]; the
    point-sphere form carries the rotational kinetic energy of the data's
    omega in the chain (NVTParams.rot_ke20)."""
    if spec.style == "nvt/sllod":
        raise NotImplementedError(
            "fix nvt/sllod is not ported: it needs fix deform's tilt on a "
            "triclinic box (ROADMAP queue 1 item 6.4, triclinic boxes)")
    a = spec.args
    kw = dict(t_chain=3)
    temp = None
    i = 0
    while i < len(a):
        if a[i] == "temp":
            temp = (float(a[i + 1]), float(a[i + 2]), float(a[i + 3]))
            i += 4
        elif a[i] == "tchain":
            kw["t_chain"] = int(a[i + 1])
            i += 2
        else:
            raise NotImplementedError(
                f"fix nvt keyword {a[i]} is not ported ({_BREADTH})")
    if temp is None:
        raise ValueError("fix nvt requires the temp keyword")
    if not ctx.script.groups[spec.group].all():
        # the JAX package raises the same
        raise NotImplementedError("fix nvt on sub-group")
    t_start, t_stop, t_damp = temp
    u = ctx.u
    dof, rot = ctx.dim * ctx.n - ctx.dim, None
    if spec.style == "nvt/sphere":
        dof, rot3 = _sphere_rot(ctx, spec.style)
        rot = float(rot3.sum())
    nvtp = nvt_mod.NVTParams.create(
        ctx.script.dt, u.ftm2v, ctx.mass_atom, t_start, t_damp,
        dof=dof, boltz=u.boltz, mvv2e=u.mvv2e, t_stop=t_stop,
        dtype=ctx.dtype, device=ctx.device, rot_ke20=rot, **kw)
    ctx.integ = nvt_integrator(nvtp)


@fix_style("npt", "nph", "npt/sphere", "nph/sphere", integrator=True)
def build_npt(ctx, spec):
    """fix npt / nph (the JAX package's build_npt): temp Tstart Tstop
    Tdamp, iso|aniso Pstart Pstop Pdamp, x|y|z Pstart Pstop Pdamp, mtk
    yes|no, tchain N, pchain N; nph's barostat masses take t0 from the
    current kinetic energy (fix_nh.cpp setup's fallback).  npt/sphere and
    nph/sphere carry the rotational kinetic energy of the data's omega in
    the temperature and the pressure (NPTParams.rot_ke30)."""
    from lidp_tpu_torch.integrate import npt as npt_mod

    script, u = ctx.script, ctx.u
    dim_, n = ctx.dim, ctx.n
    if not script.groups[spec.group].all():
        # the JAX package raises the same
        raise NotImplementedError("fix npt on sub-group")
    a = spec.args
    tgt = dict(t=None, tdamp=None, mtk=True, tchain=3, pchain=3,
               iso=False, p=[None] * 3, pdamp=[1000.0] * 3,
               t_stop=None, p_stop=[None] * 3)
    i = 0
    while i < len(a):
        k = a[i]
        if k == "temp":
            tgt["t"], tgt["tdamp"] = float(a[i + 1]), float(a[i + 3])
            tgt["t_stop"] = float(a[i + 2])
            i += 4
        elif k in ("iso", "aniso"):
            tgt["iso"] = k == "iso"
            tgt["p"] = [float(a[i + 1])] * 3
            tgt["p_stop"] = [float(a[i + 2])] * 3
            tgt["pdamp"] = [float(a[i + 3])] * 3
            i += 4
        elif k in ("x", "y", "z"):
            d = "xyz".index(k)
            tgt["p"][d] = float(a[i + 1])
            tgt["p_stop"][d] = float(a[i + 2])
            tgt["pdamp"][d] = float(a[i + 3])
            i += 4
        elif k == "mtk":
            tgt["mtk"] = a[i + 1] == "yes"
            i += 2
        elif k == "tchain":
            tgt["tchain"] = int(a[i + 1])
            i += 2
        elif k == "pchain":
            tgt["pchain"] = int(a[i + 1])
            i += 2
        else:
            raise NotImplementedError(
                f"fix {spec.style} keyword {k} is not ported ({_SKIPPED})")
    p_flag = tuple(v is not None for v in tgt["p"])
    if not any(p_flag):
        raise ValueError("fix npt needs a pressure keyword")
    dof, rot3 = dim_ * n - dim_, None
    if spec.style.endswith("/sphere"):
        dof, rot3 = _sphere_rot(ctx, spec.style)
    had_temp = tgt["t"] is not None
    if not had_temp:
        # nph: the barostat masses use t_target = t0, the current
        # temperature, floored at 1.0 (lj) / 300 (fix_nh.cpp setup)
        ke = float(np.sum(ctx.mass_atom * np.sum(
            np.asarray(script.v) ** 2, axis=1))) * u.mvv2e
        t0 = ke / ((dim_ * n - dim_) * u.boltz)
        tgt["t"] = t0 if t0 > 0 else (1.0 if u.name == "lj" else 300.0)
    nptp = npt_mod.NPTParams.create(
        script.dt, u.ftm2v, ctx.mass_atom, tgt["t"],
        tgt["tdamp"] if tgt["tdamp"] is not None else 1.0,
        [v if v is not None else 0.0 for v in tgt["p"]],
        tgt["pdamp"], natoms=n, dof=dof, boltz=u.boltz,
        mvv2e=u.mvv2e, nktv2p=u.nktv2p, tchain=tgt["tchain"],
        pchain=tgt["pchain"], mtk=tgt["mtk"],
        tstat=spec.style.startswith("npt") and had_temp,
        p_flag=p_flag, iso=tgt["iso"], t_stop=tgt["t_stop"],
        p_stop=([v if v is not None else 0.0 for v in tgt["p_stop"]]
                if any(v is not None for v in tgt["p_stop"]) else None),
        dtype=ctx.dtype, device=ctx.device, rot_ke30=rot3)
    ctx.integ = npt_integrator(nptp)


def _rigid_keywords(style, a, u):
    """make_rigid_params keywords of fix rigid/nvt, rigid/npt and
    rigid/nph's grammar (FixRigid, fix_rigid.cpp:418-530): temp Tstart
    Tstop Tdamp, tparam Tchain Titer Torder, iso|aniso Pstart Pstop Pdamp,
    x|y|z Pstart Pstop Pdamp, couple xyz|none, pchain N.  Returns (kw,
    barostat keywords or None)."""
    kw = dict(boltz=u.boltz, mvv2e=u.mvv2e)
    p_start = [0.0, 0.0, 0.0]
    p_stop = [0.0, 0.0, 0.0]
    p_period = [1.0, 1.0, 1.0]
    p_flag = [False, False, False]
    pcouple_xyz = False
    i = 1
    while i < len(a):
        if a[i] == "temp":
            kw.update(tstat=True, t_start=float(a[i + 1]),
                      t_stop=float(a[i + 2]), t_period=float(a[i + 3]))
            i += 4
        elif a[i] == "tparam":
            kw.update(t_chain=int(a[i + 1]), t_iter=int(a[i + 2]),
                      t_order=int(a[i + 3]))
            i += 4
        elif a[i] in ("iso", "aniso"):
            p_start = [float(a[i + 1])] * 3
            p_stop = [float(a[i + 2])] * 3
            p_period = [float(a[i + 3])] * 3
            p_flag = [True, True, True]
            pcouple_xyz = a[i] == "iso"
            i += 4
        elif a[i] in ("x", "y", "z"):
            d = "xyz".index(a[i])
            p_start[d] = float(a[i + 1])
            p_stop[d] = float(a[i + 2])
            p_period[d] = float(a[i + 3])
            p_flag[d] = True
            i += 4
        elif a[i] == "couple":
            pcouple_xyz = a[i + 1] == "xyz"
            i += 2
        elif a[i] == "pchain":
            kw["p_chain"] = int(a[i + 1])
            i += 2
        elif a[i] == "dilate":
            raise NotImplementedError(
                f"fix {style} keyword dilate is not ported ({_BREADTH})")
        else:
            raise NotImplementedError(
                f"fix {style} keyword {a[i]} is not ported ({_SKIPPED})")
    if style in ("rigid/nvt", "rigid/npt") and not kw.get("tstat"):
        raise ValueError(f"fix {style} requires the temp keyword "
                         "(fix_rigid_nvt.cpp:38/fix_rigid_npt.cpp:38)")
    if style == "rigid/nvt":
        if any(p_flag):
            raise NotImplementedError(
                f"fix {style}: its pressure keywords are not ported "
                f"({_SKIPPED})")
        return kw, None
    if not any(p_flag):
        raise ValueError(f"fix {style} needs a pressure keyword "
                         "(fix_rigid_npt.cpp:47)")
    return kw, dict(pstat=True, p_start=tuple(p_start),
                    p_stop=tuple(p_stop), p_period=tuple(p_period),
                    p_flag=tuple(p_flag), iso=pcouple_xyz,
                    nktv2p=u.nktv2p)


def _rigid_t0(ctx, rsetup, gmask):
    """FixRigidNH::setup's t0 fallback (:348-356), the JAX package's: the
    barostat masses use the group temperature after the setup's set_v
    projection onto rigid motion, body KE = sum M vcm^2 + L.omega, from
    the data's x and v (host numpy, float64)."""
    script, u = ctx.script, ctx.u
    v0 = np.asarray(script.v)
    x0 = np.asarray(script.x)
    m0 = np.asarray(ctx.mass_atom[:v0.shape[0]])
    akin = 0.0
    for b in range(rsetup.nbody):
        idx = np.nonzero(rsetup.body_of_atom[:v0.shape[0]] == b)[0]
        M = rsetup.masstotal[b]
        vcm0 = (m0[idx, None] * v0[idx]).sum(0) / M
        akin += M * np.dot(vcm0, vcm0)
        xc = (m0[idx, None] * x0[idx]).sum(0) / M
        L0 = (m0[idx, None] * np.cross(x0[idx] - xc, v0[idx])).sum(0)
        R0 = rigid_mod.q_to_matrix(
            torch.as_tensor(rsetup.quat0[b], dtype=torch.float64)).numpy()
        mb = R0.T @ L0
        I0 = rsetup.inertia[b]
        akin += np.dot(mb, np.where(I0 > 0.0, mb / np.where(I0 > 0.0, I0,
                                                             1.0), 0.0))
    g0 = np.asarray(gmask)[:v0.shape[0]]
    dof0 = max(3.0 * int(g0.sum()) - 3.0 - rsetup.dof_removed, 1.0)
    t0 = float(akin) * u.mvv2e / (dof0 * u.boltz)
    if t0 <= 0.0:
        t0 = 1.0 if u.name == "lj" else 300.0
    return t0


@fix_style("rigid", "rigid/nve", "rigid/nvt", "rigid/small",
           "rigid/nve/small", "rigid/nvt/small", "rigid/npt", "rigid/nph",
           "rigid/npt/small", "rigid/nph/small", integrator=True)
def build_rigid(ctx, spec):
    # the /small variants (fix_rigid_small.cpp) alias their parents
    if spec.style.endswith("/small"):
        spec = dataclasses.replace(spec, style=spec.style[:-6])
    script, u = ctx.script, ctx.u
    if not spec.args or spec.args[0] != "molecule":
        raise NotImplementedError(
            f"fix {spec.style} {' '.join(spec.args)}: only bodies by "
            f"molecule are ported ({_BREADTH})")
    kw, baro = {}, None
    if spec.style in ("rigid/nvt", "rigid/npt", "rigid/nph"):
        kw, baro = _rigid_keywords(spec.style, spec.args, u)
    gmask = ctx.groups[spec.group]
    x_unwrap = (ctx.padA(script.x)
                + ctx.padA(script.image, 0)
                * (script.box_hi - script.box_lo))
    rsetup = rigid_mod.setup_bodies(x_unwrap, ctx.mass_atom,
                                    ctx.padA(script.mol, 0), gmask)
    if baro is not None:
        if spec.style == "rigid/nph" or "t_start" not in kw:
            t0 = _rigid_t0(ctx, rsetup, gmask)
            kw.setdefault("t_start", t0)
            kw.setdefault("t_stop", t0)
            kw.setdefault("t_period", 1.0)
        kw.update(baro)
    rp = rigid_mod.make_rigid_params(rsetup, script.dt, u.ftm2v,
                                     mass_atom=ctx.mass_atom,
                                     dtype=ctx.dtype, device=ctx.device,
                                     **kw)
    ctx.integ = rigid_nve_integrator(
        rp, torch.as_tensor(np.asarray(ctx.mass_atom), dtype=ctx.dtype,
                            device=ctx.device))
    ctx.dof_removed += rsetup.dof_removed
    ctx.rigid_groups.append((spec.group, rsetup))
