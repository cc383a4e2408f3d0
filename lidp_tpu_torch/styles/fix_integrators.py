"""Time-integration fix styles (lidp_tpu/styles/fix_integrators.py): nve
and rigid/nve.  Each builder sets ctx.integ.  nve/limit, nve/noforce and
the Nose-Hoover and barostat styles (nvt, npt, nph, rigid/nvt, rigid/npt,
rigid/nph and their /small forms) are not ported: the rigid ones raise
here, the others have no builder.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.integrate import nve as nve_mod
from lidp_tpu_torch.integrate import rigid as rigid_mod
from lidp_tpu_torch.integrate.driver import (nve_integrator,
                                             rigid_nve_integrator)
from lidp_tpu_torch.styles import fix_style


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


@fix_style("rigid", "rigid/nve", "rigid/nvt", "rigid/small",
           "rigid/nve/small", "rigid/nvt/small", "rigid/npt", "rigid/nph",
           "rigid/npt/small", "rigid/nph/small", integrator=True)
def build_rigid(ctx, spec):
    # the /small variants (fix_rigid_small.cpp) alias their parents
    if spec.style.endswith("/small"):
        spec = dataclasses.replace(spec, style=spec.style[:-6])
    script, u = ctx.script, ctx.u
    if spec.style not in ("rigid", "rigid/nve"):
        # the thermostat and barostat grammar (fix_rigid.cpp:418-530) goes
        # with their integrators
        raise NotImplementedError(f"fix {spec.style}: {rigid_mod._BREADTH}")
    if not spec.args or spec.args[0] != "molecule":
        raise NotImplementedError(
            f"fix {spec.style} {' '.join(spec.args)}: only bodies by "
            "molecule are ported (ROADMAP queue 1 item 6, breadth)")
    gmask = ctx.groups[spec.group]
    x_unwrap = (ctx.padA(script.x)
                + ctx.padA(script.image, 0)
                * (script.box_hi - script.box_lo))
    rsetup = rigid_mod.setup_bodies(x_unwrap, ctx.mass_atom,
                                    ctx.padA(script.mol, 0), gmask)
    rp = rigid_mod.make_rigid_params(rsetup, script.dt, u.ftm2v,
                                     mass_atom=ctx.mass_atom,
                                     dtype=ctx.dtype, device=ctx.device)
    ctx.integ = rigid_nve_integrator(
        rp, torch.as_tensor(np.asarray(ctx.mass_atom), dtype=ctx.dtype,
                            device=ctx.device))
    ctx.dof_removed += rsetup.dof_removed
