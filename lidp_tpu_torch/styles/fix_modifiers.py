"""Modifier fix styles (lidp_tpu/styles/fix_modifiers.py): the constraint
fixes shake and rattle, which add post_force hooks (and rattle's
end_of_step velocity projection) to the FixBuildCtx sinks.  The other
modifier styles of the JAX module (setforce, ...) are not ported (ROADMAP
queue 1 item 6, breadth).
"""

from __future__ import annotations

import dataclasses

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
    ctx.pf_hooks.append(
        lambda sys_, f_, _p=shakep: shake_mod.shake_post_force(sys_, f_, _p))
    ctx.pf_hooks_setup.append(
        lambda sys_, f_, _p=shakep_half: shake_mod.shake_post_force(
            sys_, f_, _p))
    if spec.style == "rattle":
        # the velocity-stage constraint after final_integrate
        # (FixRattle::final_integrate -> vrattle*)
        ctx.rattle_params = shakep


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
