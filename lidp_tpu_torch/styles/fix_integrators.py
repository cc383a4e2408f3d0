"""Time-integration fix styles (lidp_tpu/styles/fix_integrators.py): nve,
rigid/nve, rigid/nvt and nvt.  Each builder sets ctx.integ.  nve/limit,
nve/noforce, nvt/sllod, nvt/sphere and the barostat styles (npt, nph,
rigid/npt, rigid/nph and their /small and /sphere forms) are not ported:
the rigid and nvt ones raise here, the others have no builder.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.integrate import nve as nve_mod
from lidp_tpu_torch.integrate import nvt as nvt_mod
from lidp_tpu_torch.integrate import rigid as rigid_mod
from lidp_tpu_torch.integrate.driver import (nve_integrator, nvt_integrator,
                                             rigid_nve_integrator)
from lidp_tpu_torch.styles import fix_style

_BREADTH = "ROADMAP queue 1 item 6, breadth"


@fix_style("nve", integrator=True)
def build_nve(ctx, spec):
    # sub-group nve: only the fix group integrates (atoms outside any
    # time-integration fix do not move)
    gmask = ctx.groups[spec.group]
    gmask_real = ctx.script.groups[spec.group]
    nvep = nve_mod.NVEParams.create(
        ctx.script.dt, ctx.u.ftm2v, ctx.mass_atom, dtype=ctx.dtype,
        gmask=None if gmask_real.all() else gmask, device=ctx.device)
    ctx.integ = nve_integrator(nvep)


@fix_style("nvt", "nvt/sllod", "nvt/sphere", integrator=True)
def build_nvt(ctx, spec):
    if spec.style != "nvt":
        raise NotImplementedError(
            f"fix {spec.style} is not ported ({_BREADTH}: integrate/nvt.py "
            "sllod and rot_ke20)")
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
    nvtp = nvt_mod.NVTParams.create(
        ctx.script.dt, u.ftm2v, ctx.mass_atom, t_start, t_damp,
        dof=ctx.dim * ctx.n - ctx.dim, boltz=u.boltz, mvv2e=u.mvv2e,
        t_stop=t_stop, dtype=ctx.dtype, device=ctx.device, **kw)
    ctx.integ = nvt_integrator(nvtp)


def _rigid_nvt_keywords(style, a, u):
    """make_rigid_params keywords of fix rigid/nvt's grammar (FixRigid,
    fix_rigid.cpp:418-530): temp Tstart Tstop Tdamp, tparam Tchain Titer
    Torder.  The barostat's keywords raise."""
    kw = dict(boltz=u.boltz, mvv2e=u.mvv2e)
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
        elif a[i] in ("iso", "aniso", "x", "y", "z", "couple", "pchain",
                      "dilate"):
            raise NotImplementedError(
                f"fix {style} keyword {a[i]}: {rigid_mod._BAROSTAT}")
        else:
            raise NotImplementedError(
                f"fix {style} keyword {a[i]} is not ported ({_BREADTH})")
    if not kw.get("tstat"):
        raise ValueError(f"fix {style} requires the temp keyword "
                         "(fix_rigid_nvt.cpp:38/fix_rigid_npt.cpp:38)")
    return kw


@fix_style("rigid", "rigid/nve", "rigid/nvt", "rigid/small",
           "rigid/nve/small", "rigid/nvt/small", "rigid/npt", "rigid/nph",
           "rigid/npt/small", "rigid/nph/small", integrator=True)
def build_rigid(ctx, spec):
    # the /small variants (fix_rigid_small.cpp) alias their parents
    if spec.style.endswith("/small"):
        spec = dataclasses.replace(spec, style=spec.style[:-6])
    script, u = ctx.script, ctx.u
    if spec.style in ("rigid/npt", "rigid/nph"):
        raise NotImplementedError(f"fix {spec.style}: {rigid_mod._BAROSTAT}")
    if not spec.args or spec.args[0] != "molecule":
        raise NotImplementedError(
            f"fix {spec.style} {' '.join(spec.args)}: only bodies by "
            f"molecule are ported ({_BREADTH})")
    kw = {}
    if spec.style == "rigid/nvt":
        kw = _rigid_nvt_keywords(spec.style, spec.args, u)
    gmask = ctx.groups[spec.group]
    x_unwrap = (ctx.padA(script.x)
                + ctx.padA(script.image, 0)
                * (script.box_hi - script.box_lo))
    rsetup = rigid_mod.setup_bodies(x_unwrap, ctx.mass_atom,
                                    ctx.padA(script.mol, 0), gmask)
    rp = rigid_mod.make_rigid_params(rsetup, script.dt, u.ftm2v,
                                     mass_atom=ctx.mass_atom,
                                     dtype=ctx.dtype, device=ctx.device,
                                     **kw)
    ctx.integ = rigid_nve_integrator(
        rp, torch.as_tensor(np.asarray(ctx.mass_atom), dtype=ctx.dtype,
                            device=ctx.device))
    ctx.dof_removed += rsetup.dof_removed
    ctx.rigid_groups.append((spec.group, rsetup))
