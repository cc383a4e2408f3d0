"""Simulation assembly: interpreter state -> a runnable system
(lidp_tpu/sim.py, the routes of lj/cut, lj/cut/coul/long,
lj/cut/coul/long/polarization, lj/charmm/coul/long,
lj/charmm/coul/charmm, eam, eam/alloy and eam/fs, the k-space breadth's
lj/long/coul/long, buck/long/coul/long, the five TIP4P styles,
lj/cut/coul/msm and lj/charmm/coul/msm, the other pair styles of
styles/pair_builders.py (the generic styles, lj/cut/coul/cut|debye|dsf|
wolf, table, hybrid, hybrid/overlay, dpd, dpd/tstat, pair_modify tail),
the rest of the CHARMM family (lj/charmmfsw/coul/long|charmmfsh with
qqr2e 332.0716 under units real, lj/charmm/coul/charmm/implicit), fix
cmap's crossterms and the DREIDING hydrogen bonds, with the bonded terms
and the modifier fixes).

The analog of the LAMMPS init phase (Run::command -> LAMMPS::init,
run.cpp:38): the lj/cut or lj/cut/coul/long tables with geometric (or
arithmetic) mixing for unset type pairs (Pair::init_one pair.cpp:660,
676), the neigh_modify exclusions, the k-space setup of a coulomb style
(Ewald, or PPPM's grid and g_ewald) with the `kspace_modify gewald`
override, the polarization settings of the pair keywords, the special
bonds of the Bonds section, the k-space breadth (_kspace_terms: the
ewald/disp dispersion sum on the per-atom B_i with g6 = g_ewald, the
pppm/disp mesh, MSM with its adjusted cutoff pushed back into the pair
table and the cell grid; _tip4p_params: the TIP4P sites, the dense route
only), the bonded terms of the bond, angle, dihedral
and improper styles (less the bonds and angles fix shake constrains, the
clusters found in a pre-pass), the integrator of the fixes (nve,
rigid/nve, rigid/nvt, rigid/npt, rigid/nph, nvt, npt, nph; without one,
nve with dt 0, the atoms frozen, as in the JAX package) with its dof
removal (FixRigid::dof, fix_rigid.cpp:1181; FixShake's constraints, which
the thermostats' dof lose too), the modifier fixes' post_force and
end_of_step hooks (rattle's velocity projection, the deferred temp/rescale
and temp/berendsen on their group's dof), the group temperatures of `compute ID
group temp`, in 2d (dimension 2) dim*N - dim dof and the pressure over the
area, the thermo temperature of `thermo_modify temp` (that compute's group
and dof for Temp, KE, TotEng and the pressure's kinetic part), and the
shrink-wrapped box of `boundary s` or `m` after create_box (a
box.ShrinkSpec the Runner resets the box with at setup and, on the cell
grid, at every rebuild; its static bins can then grow thinner than the
cutoff, which sets the grid's overflow flag, and the run aborts as the
JAX package's does), and the computes (_wire_computes: the tables of
computes.py); then `run` (each run the window of the thermostats' and
barostats' target ramps), the output fixes of styles/fix_output.py at the
run chunks' ends, the thermo rows with every compute's c_ID and c_ID[i]
and the v_NAME columns (thermo_row), and the dump frames.  Under a barostat the Ewald tables follow the live box
(ForceField.kspace_dynamic), PPPM reads it at each call, and the Runner
evaluates the virial every step (every_step_ev), so a thermo row reads the
step's own evaluation on the box after the step's remap.

It takes the route the JAX package takes:
  * the dense route (forcefield.compute_forces with nlist=None in the
    generic Runner, (N,N) tensors in plain PyTorch): every style at most
    DENSE_PATH_MAX_ATOMS atoms, the polar style only without
    LIDP_FAST_POLAR=1, with the System unpadded and the special codes of
    the Bonds section (built up to the cap only, as in JAX); the TIP4P
    styles take it only, and raise above the cap as the JAX package's
    do;
  * the cell grid above the cap (the generic Runner on a CellConfig of the
    largest cutoff plus the skin, cap_slack 1.7, rebuilt as neigh_modify
    every/delay/check say): the pair term on the grid (the CUDA kernel
    cell_pair_forces_lj for single-type float32 lj/cut, else plain
    torch), the special lists' sparse correction, then the Ewald sum and
    the dense polar term; the polar style takes it under LIDP_FAST_POLAR=0
    or with a fix the panel engine does not compose with.  A cell
    overflow aborts the run;
  * the panel engine (FastPolarRunner through maybe_attach, the CUDA
    kernels) for the polar style above the cap or under
    LIDP_FAST_POLAR=1, with the System padded to the panel alignment and
    the special lists;
  * the EAM styles on the cell grid at every atom count (the file's
    cutoff plus the skin; ForceField(pair=None, eam=...), ops/eam.py in
    plain torch), orthogonal boxes only, as in the JAX package;
  * pair_style table and dpd on the dense route at every atom count
    (ForceField(pair=None, dpd=...) for dpd), as in the JAX package;
  * the hydrogen bonds (ForceField.hbond, its dense [M, N] pass) on
    either route; fix cmap (ForceField.cmap) on the dense route only,
    raising on the cell grid (ROADMAP queue 3 item 39);
  * the granular route for a pair gran/* style on atom_style sphere data
    (styles/gran_builders.py: integrate/gran_runner.GranRunner on the cell
    grid at every size, padded by fix pour's budget, whose insertions
    Simulation.run makes at the run chunks' boundaries), as in the JAX
    package; its fixes, sphere computes and neigh_modify exclude group
    raise on the other routes.
Above the cap, a box under 3 cells of the largest cutoff plus the skin a
side takes the JAX package's neighbour list, which is not ported (ROADMAP
queue 1 item 5) and raises; only the polar style keeps the dense pass
without special codes there, which gives that list's rows while no pair
comes within the cutoff between rebuilds (ROADMAP queue 3 item 5).  A
composition the JAX package runs and the port cannot (another pair or
kspace style) raises NotImplementedError naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from lidp_tpu_torch import computes, resolve_device
from lidp_tpu_torch import topology as topo_mod
from lidp_tpu_torch.box import Box
from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.integrate.driver import Runner
from lidp_tpu_torch.io.script import (EAM_STYLES, GRAN_STYLES, PAIR_STYLES,
                                      SPHERE_COMPUTES)
from lidp_tpu_torch.ops import polarization as pol_ops
from lidp_tpu_torch.ops.cells import CellConfig
from lidp_tpu_torch.ops.eam import build_eam_alloy_params, build_eam_params
from lidp_tpu_torch.ops.ewald import (Ewald6Params, EwaldParams,
                                      setup_dispersion, setup_ewald_disp)
from lidp_tpu_torch.ops.msm import MSMParams, setup_msm
from lidp_tpu_torch.ops.pair import make_long_pair_params, make_pair_params
from lidp_tpu_torch.ops.pppm import (PPPMDispParams, PPPMParams,
                                     setup_pppm, setup_pppm_disp)
from lidp_tpu_torch.parallel import fast_polar
from lidp_tpu_torch.parallel.fast_polar import (aligned_npad, maybe_attach,
                                                prescan)
from lidp_tpu_torch.state import make_system
from lidp_tpu_torch.styles import fix_output
from lidp_tpu_torch.styles import pair_builders as pb
from lidp_tpu_torch.thermo import (ThermoParams, compute_pressure,
                                   temperature, thermo_row)

# the charge meshes without a dispersion mesh
_CHARGE_MESHES = ("pppm", "pppm/cg", "pppm/stagger", "pppm/tip4p")
_KSPACE_ITEM = ("ROADMAP queue 1 item 6.5, the k-space: its other "
                "compositions")
# the fix styles that move the box (the JAX package's has_baro, less the
# styles the port does not have)
BAROSTATS = ("npt", "nph", "rigid/npt", "rigid/nph", "rigid/npt/small",
             "rigid/nph/small")

# the JAX package's warning for the dense route above the cap
# (lidp_tpu/sim.py:2020-2025)
_ABOVE_CAP = ("WARNING: polarization above the dense-path size cap is "
              "running the O(N^2) tensor path (fast-polar engine "
              "ineligible: unsupported fix/kspace/bonded composition)")
# the fix styles of the granular route alone (styles/gran_builders.py)
GRAN_FIXES = ("gravity", "freeze", "nve/sphere", "wall/gran",
              "wall/gran/region", "pour")
# the JAX package's abort on a cell overflow (lidp_tpu/sim.py:3623-3627)
_OVERFLOW = ("neighbor cell capacity overflow during run (Neighbor "
             "'dangerous build' analog) — increase cap_slack")


def _cell_config(script, cut, n, coul):
    """The cell grid the JAX package runs the pair term on above the dense
    cap, and EAM at every size (its sim.py:1798-1820): CellConfig.for_box
    at the largest cutoff (of the coulomb term too; EAM's the potential
    file's) plus the skin, cap_slack 1.7; None where the box is under 3
    such cells a side and the JAX package takes a neighbour list
    instead."""
    L = script.box_hi - script.box_lo
    cutmax = float(np.max(cut))
    if coul:
        cutmax = max(cutmax, script.pair.cut_coul)
    try:
        # slack 1.7, the JAX package's (a cell that overfills aborts the
        # run: Simulation.run)
        return CellConfig.for_box(L, cutmax + script.skin,
                                  density=n / float(np.prod(L)),
                                  cap_slack=1.7)
    except ValueError:
        return None


def _check_kspace(name, style, msm_pair, long_disp):
    """Refuse the compositions of a k-space pair style and a k-space style
    the port does not run: the JAX package's own refusal of pppm/disp
    without a dispersion style, and the compositions it runs with one sum
    of a pair's terms missing or doubled (a coul/msm style with another
    k-space, msm with another coulomb, a long dispersion style with a
    charge mesh alone), which the port leaves to ROADMAP queue 1 item
    6.5."""
    if style == "pppm/disp" and not long_disp:
        # the JAX package's message (its sim.py:1337-1340)
        raise NotImplementedError(
            "kspace pppm/disp needs a */long/* dispersion pair style")
    if (style in ("msm", "msm/cg")) != msm_pair:
        raise NotImplementedError(
            f"pair_style {name} with kspace_style {style}: the port runs "
            f"the coul/msm styles with msm, and msm with them, only (the "
            f"JAX package runs it; {_KSPACE_ITEM})")
    if long_disp and style in _CHARGE_MESHES:
        raise NotImplementedError(
            f"pair_style {name} with kspace_style {style}: the charge mesh "
            f"has no dispersion sum (the JAX package runs it without one; "
            f"{_KSPACE_ITEM})")


def _buck_tables(script):
    """buck/long/coul/long's (T+1,T+1) A, 1/rho, C and cutoff tables from
    its pair_coeff rows; every type pair must be set (the JAX package's
    sim.py:1180-1200)."""
    T = script.ntypes
    tA = np.zeros((T + 1, T + 1))
    tRinv = np.zeros((T + 1, T + 1))
    tC = np.zeros((T + 1, T + 1))
    cut = np.full((T + 1, T + 1), script.pair.cut_lj_global)
    seen = np.zeros((T + 1, T + 1), bool)
    for (i, j), (a_, rho_, c_, cut_) in script.pair_coeffs.items():
        tA[i, j] = tA[j, i] = a_
        tRinv[i, j] = tRinv[j, i] = 1.0 / rho_
        tC[i, j] = tC[j, i] = c_
        cut[i, j] = cut[j, i] = cut_
        seen[i, j] = seen[j, i] = True
    for i in range(1, T + 1):
        for j in range(i + 1, T + 1):
            if not seen[i, j]:
                raise ValueError("All pair coeffs are not set "
                                 f"(buck/long/coul/long {i} {j})")
    return tA, tRinv, tC, cut


def _kspace_terms(script, u, pair, b_atom, n, dtype, device) -> dict:
    """The k-space setup of the JAX package's sim.py:1293-1425: the
    ForceField fields (ewald, pppm, msm, ewald6, pppm_disp) and the pair
    table with its g_ewald, g6 or MSM cutoff ("pair").  pppm/cg and
    msm/cg run as pppm and msm, pppm/tip4p and pppm/disp/tip4p as pppm
    and pppm/disp (the charge sites are the ForceField's tip4p).  The
    ewald/disp dispersion sum takes g6 = g_ewald (ewald_disp.cpp:230;
    kspace_modify gewald/disp counts for pppm/disp only, as in the JAX
    package); MSM's adjusted cutoff goes back into the pair table and the
    script (msm.cpp:1048), where the cell grid reads it.  u: the run's
    units (qqr2e the CHARMM constant under the charmmfsw styles)."""
    style, acc = script.kspace
    L = script.box_hi - script.box_lo
    out = {}
    if style.startswith("pppm"):
        ps = setup_pppm(accuracy_rel=acc, qqrd2e=u.qqr2e, q=script.q,
                        natoms=n, cutoff=script.pair.cut_coul,
                        box_lengths=L, g_ewald=script._gewald_override)
        pair = dataclasses.replace(pair, g_ewald=float(ps.g_ewald))
        out["pppm"] = PPPMParams.from_setup(
            ps, u.qqr2e, float(np.sum(script.q ** 2)),
            float(np.sum(script.q)), stagger=style == "pppm/stagger")
        if style in ("pppm/disp", "pppm/disp/tip4p") and b_atom is not None:
            # the pair flag `cut long` leaves the dispersion mesh off
            ps6 = setup_pppm_disp(
                accuracy_rel=acc, qqrd2e=u.qqr2e, b_atom=b_atom, natoms=n,
                cutoff=script.pair.cut_lj_global, box_lengths=L,
                g6=script._gewald6_override)
            pair = dataclasses.replace(pair, g6=float(ps6.g6))
            out["pppm_disp"] = PPPMDispParams.from_setup(ps6)
    elif style in ("msm", "msm/cg"):
        ms = setup_msm(accuracy_rel=acc, qqrd2e=u.qqr2e, q=script.q,
                       natoms=n, cutoff=script.pair.cut_coul, box_lengths=L,
                       cutoff_adjust=script._msm_cutoff_adjust)
        out["msm"] = MSMParams.from_setup(ms, dtype=dtype, device=device)
        if ms.cutoff != script.pair.cut_coul:
            script.log(f"Adjusting Coulombic cutoff for MSM, new cutoff = "
                       f"{ms.cutoff:g}")
            script.pair.cut_coul = ms.cutoff
            cc2 = ms.cutoff ** 2
            pair = dataclasses.replace(
                pair, cut_coulsq=cc2, cutsq=torch.clamp(pair.cutsq,
                                                        min=cc2))
    else:
        # ewald/disp on an uncharged system: the charge function is off
        # and only the dispersion function runs (EwaldDisp::init)
        es = None
        if not (float(np.sum(script.q ** 2)) == 0.0 and b_atom is not None):
            es = setup_ewald_disp(
                accuracy_rel=acc, qqrd2e=u.qqr2e, q=script.q, natoms=n,
                cutoff=script.pair.cut_coul, box_lengths=L,
                g_ewald=script._gewald_override)
            pair = dataclasses.replace(pair, g_ewald=float(es.g_ewald))
            out["ewald"] = EwaldParams.from_setup(es, u.qqr2e, dtype=dtype,
                                                  device=device)
        if b_atom is not None:
            es6 = setup_dispersion(
                accuracy_rel=acc, qqrd2e=u.qqr2e, b_atom=b_atom, natoms=n,
                cutoff=script.pair.cut_lj_global, box_lengths=L,
                g6=(es.g_ewald if es is not None
                    else script._gewald_override))
            pair = dataclasses.replace(pair, g6=float(es6.g6))
            out["ewald6"] = Ewald6Params.from_setup(es6, dtype=dtype,
                                                    device=device)
    out["pair"] = pair
    return out


def _tip4p_params(script, npad, n, device):
    """The TIP4P sites of the pair style's O and H types (the JAX
    package's sim.py:1442-1465): alpha = qdist / (cos(theta0/2) r0) from
    the O-H bond's and H-O-H angle's coefficients, the H of each O by tag
    (atom index + 1, as there); above the dense cap it raises as the JAX
    package does."""
    import math

    from lidp_tpu_torch.ops.tip4p import make_tip4p_params

    otype, htype, btype, atype, qdist = script.pair.tip4p
    if btype not in script.bond_coeffs or atype not in script.angle_coeffs:
        raise ValueError("TIP4P needs bond/angle coeffs for the O-H bond "
                         "and H-O-H angle types")
    r0 = float(script.bond_coeffs[btype][1])
    th0 = math.radians(float(script.angle_coeffs[atype][1]))
    type_pad = np.zeros(npad, np.asarray(script.type).dtype)
    type_pad[:n] = script.type
    tipp = make_tip4p_params(type_pad, np.arange(1, npad + 1), otype, htype,
                             qdist / (math.cos(0.5 * th0) * r0),
                             device=device)
    if n > fast_polar.DENSE_PATH_MAX_ATOMS:
        raise NotImplementedError(
            "TIP4P pair styles run the dense path only "
            f"(n <= {fast_polar.DENSE_PATH_MAX_ATOMS})")
    return tipp


def _bonded_params(script, dtype, device, u, eps, sig, cut, bond_keep,
                   angle_keep):
    """The ForceField's bond, angle, dihedral and improper tuples (the JAX
    package's sim.py:1570-1610): one params object per hybrid sub-style,
    the bonds and angles fix shake constrains left out; quartic's pair
    subtraction takes the lj/cut tables."""
    from lidp_tpu_torch.styles import bonded_builders as bb

    out = {}
    if script._bonds is not None and len(script._bonds) \
            and script.bond_style is not None:
        pair_tables = None
        if script.bond_style == "quartic" or (
                script.bond_style == "hybrid"
                and "quartic" in script.bond_style_args):
            # pair_style zero: nothing to subtract (the JAX package's
            # sim.py:1578-1588)
            if script.pair.name.startswith("lj/cut"):
                pair_tables = (eps, sig, cut)
            elif script.pair.name != "zero":
                raise NotImplementedError(
                    "bond quartic pair subtraction supports lj/cut")
        out["bond"] = bb.build_bond_params(script, dtype, bond_keep,
                                           pair_tables, device=device)
    for fam, build, args in (
            ("angle", bb.build_angle_params, (angle_keep,)),
            ("dihedral", bb.build_dihedral_params, (u, eps, sig)),
            ("improper", bb.build_improper_params, ())):
        terms = getattr(script, f"_{fam}s")
        if terms is not None and len(terms) \
                and getattr(script, f"{fam}_style") is not None:
            out[fam] = build(script, dtype, *args, device=device)
    return out


def _cmap_params(script, dtype, device, cells: bool):
    """(ops.cmap.CMAPParams, its fix ID) of `fix ID group cmap FILE` with
    read_data's CMAP rows and fix_modify ID energy (the JAX package's
    sim.py:1487-1500), (None, None) without the fix; on the cell grid
    (`cells`) it raises."""
    from lidp_tpu_torch.ops.cmap import make_cmap_params

    out = (None, None)
    for fid, spec in script.fixes.items():
        if spec.style != "cmap":
            continue
        if script._crossterms is None:
            raise ValueError("fix cmap requires read_data ... fix ID "
                             "crossterm CMAP")
        if cells:
            raise NotImplementedError(
                "fix cmap on the cell grid: the JAX package takes the "
                "crossterms' raw coordinates, which the grid's rebuilds "
                "wrap into the box (ROADMAP queue 3 item 39, fix cmap "
                "beyond the dense route)")
        energy = script._fix_modify.get(fid, {}).get("energy") == "yes"
        out = (make_cmap_params(os.path.join(script.root, spec.args[0]),
                                script._crossterms, dtype=dtype,
                                device=device, energy=energy), fid)
    return out


def _hbond_params(script, n, dtype, device) -> tuple:
    """The ops.hbond.HbondParams of each hbond/dreiding sub-style (or the
    pair style itself), on the dense special codes of the Bonds section
    (the JAX package's sim.py:1502-1517, which refuses a system without
    bonds)."""
    from lidp_tpu_torch.ops.hbond import make_hbond_params

    specs = pb.hbond_specs(script)
    if not specs:
        return ()
    if script._bonds is None or not len(script._bonds):
        raise ValueError("pair hbond/dreiding requires a molecular system "
                         "(init_style :393)")
    if script.neigh_exclude_types or script.neigh_exclude_mol:
        # the reference's donors take their acceptors from the full
        # neighbour list, which neigh_modify exclude thins
        raise NotImplementedError(
            "pair hbond/dreiding with neigh_modify exclude: the JAX "
            "package's [M, N] pass takes every acceptor the exclusion "
            "drops from the reference's neighbour list (ROADMAP queue 3 "
            "item 40)")
    code = topo_mod.special_codes_dense(n, script._bonds)
    return tuple(make_hbond_params(
        rows, script.ntypes, int(args[0]), float(args[1]), float(args[2]),
        float(args[3]), np.asarray(script._bonds), n, script.type,
        list(script.special_lj), special_code=code, dtype=dtype,
        device=device, morse=name.endswith("morse"))
        for name, args, rows in specs)


def _compose_pf(hooks):
    """The post_force hooks, fn(sys, f) -> (f, virial6), in fix order
    (Modify::post_force): (sys, f) -> (f, the summed virial); None for
    none."""
    if not hooks:
        return None

    def composed(sys_, f_, _hooks=tuple(hooks)):
        vtot = f_.new_zeros(6)
        for h in _hooks:
            f_, v6 = h(sys_, f_)
            vtot = vtot + v6
        return f_, vtot

    return composed


def _compose_eos(fctx):
    """The end_of_step of the fixes, in the JAX package's order (its
    sim.py:1833-1920): fix rattle's velocity projection
    (FixRattle::final_integrate -> vrattle*), then the end_of_step hooks
    in declaration order, then the deferred temp/rescale or
    temp/berendsen; None for none."""
    from lidp_tpu_torch.styles.fix_modifiers import temp_fix_end_of_step

    hooks = list(fctx.eos_hooks)
    if fctx.pending_temp_fix is not None:
        hooks.append(temp_fix_end_of_step(fctx, fctx.pending_temp_fix))
    if fctx.rattle_params is not None:
        from lidp_tpu_torch.ops import shake as shake_mod

        hooks.insert(0, lambda sys_, res_=None, _p=fctx.rattle_params:
                     shake_mod.rattle_velocity(sys_, _p))
    if not hooks:
        return None

    def end_of_step(sys_, res_=None, _hooks=tuple(hooks)):
        for h in _hooks:
            sys_ = h(sys_, res_)
        return sys_

    return end_of_step


def _compose_pi(hooks):
    """The post_integrate hooks in declaration order; None for none."""
    if not hooks:
        return None

    def post_integrate(sys_, _hooks=tuple(hooks)):
        for h in _hooks:
            sys_ = h(sys_)
        return sys_

    return post_integrate


def _check_not_granular(script, name):
    """What the granular route alone takes raises on the others: its fix
    styles and sphere computes (the JAX package refuses those fixes and
    prints no value for those computes there), fix nvt/sphere (the JAX
    package's point-particle form), sphere data (its per-atom masses) and
    neigh_modify exclude group (which the JAX package drops there)."""
    for spec in script.fixes.values():
        if spec.style in GRAN_FIXES:
            raise NotImplementedError(
                f"fix style {spec.style} with pair_style {name}: it runs "
                "with a pair gran/* style alone (the JAX package's "
                "granular route)")
        if spec.style == "nvt/sphere":
            raise NotImplementedError(
                f"fix nvt/sphere with pair_style {name} is not ported "
                "(ROADMAP queue 1 item 6.8, integrator keywords)")
    for cid, spec_c in script.computes.items():
        if spec_c[1] in SPHERE_COMPUTES:
            raise NotImplementedError(
                f"compute {cid} {spec_c[1]} with pair_style {name}: the JAX "
                "package reads it on the granular route alone (ROADMAP "
                "queue 3 item 26, values JAX's thermo row lacks)")
    if script.rmass is not None:
        raise NotImplementedError(
            f"atom_style sphere with pair_style {name}: the per-atom masses "
            "are ported on the granular route alone (ROADMAP queue 1 item "
            "6, breadth)")
    if script.neigh_exclude_group is not None:
        raise NotImplementedError(
            f"neigh_modify exclude group with pair_style {name}: the JAX "
            "package drops it off the granular route (ROADMAP queue 3 item "
            "44)")


def shrink_spec(script):
    """The ShrinkSpec of the script's boundary (the JAX package's
    sim.py:1933-1947): face codes p and f 0, s 2, m 3; small 1e-4 of the
    created box's length, the `m` faces' limits the created box's.  None
    without a shrink-wrapped face or a box from create_box (a read_data
    box is not shrink-wrapped, as in the JAX package)."""
    from lidp_tpu_torch.box import ShrinkSpec

    if script._created_box is None:
        return None
    code = {"p": 0, "f": 0, "s": 2, "m": 3}
    lo_c = tuple(code[st[0]] for st in script.boundary_styles)
    hi_c = tuple(code[st[1]] for st in script.boundary_styles)
    if not any(c in (2, 3) for c in lo_c + hi_c):
        return None
    c_lo, c_hi = script._created_box
    return ShrinkSpec(lo_style=lo_c, hi_style=hi_c,
                      small=tuple(float(v) for v in 1.0e-4 * (c_hi - c_lo)),
                      min_lo=tuple(float(v) for v in c_lo),
                      min_hi=tuple(float(v) for v in c_hi))


def polarization_settings(p) -> pol_ops.PolarizationSettings:
    """PolarizationSettings of the parsed pair_style keywords (a
    PairStyleSpec)."""
    return pol_ops.PolarizationSettings(
        iterations_max=p.iterations_max,
        damping_type=(pol_ops.DAMPING_EXPONENTIAL
                      if p.damping_type == "exponential"
                      else pol_ops.DAMPING_NONE),
        polar_damp=p.polar_damp, zodid=p.zodid,
        polar_precision=p.polar_precision,
        fixed_iteration=p.fixed_iteration, polar_gs=p.polar_gs,
        polar_gs_ranked=p.polar_gs_ranked, polar_gamma=p.polar_gamma,
        use_previous=p.use_previous)


class Simulation:
    """One assembled run: the System, the runner (the generic Runner on
    the dense route, else FastPolarRunner) and the thermo parameters;
    `run(nsteps)` advances it and writes the thermo rows and dump frames
    through the script."""

    def __init__(self, script, sys, runner, thermo_params, natoms: int,
                 group_thermo=None):
        self.script = script
        self.sys = sys
        self.runner = runner
        self.thermo_params = thermo_params
        # compute ID -> ThermoParams of its group (the c_ID columns)
        self.group_thermo = group_thermo or {}
        self.natoms = natoms
        self.res = None
        self.istate = None
        # the cell grid's carry (integrate/driver.NeighborCarry) across
        # runs and chunks; None on the dense route and the panel engine
        self.nlist = None
        # the ID of fix cmap (its f_ID column), None without one
        self.cmap_fid = None
        # the other computes by kind (_wire_computes): ID -> group mask
        # and what the style needs
        self.gg_computes = {}
        self.rigid_computes = {}
        self.msd_computes = {}
        self.rdf_computes = {}
        self.simple_computes = {}
        self.vacf_computes = {}
        self.peratom_computes = {}
        self.reduce_computes = {}
        self.tempvar_computes = {}
        self.slice_computes = {}
        self.press_computes = {}
        # chunk/atom: ID -> (group, spec); the */chunk computes: ID ->
        # (group, style, chunk ID, arguments); heat/flux: ID -> (group,
        # [ke, pe, stress IDs]); msd/chunk's reference centres by ID
        self.chunk_computes = {}
        self.chunkagg_computes = {}
        self.hf_computes = {}
        self.msdchunk_ref = {}
        # the granular route's: erotate/sphere and temp/sphere by ID (their
        # group masks), fix pour's insertions, the per-atom radius and mass
        self.erotate_computes = {}
        self.tempsphere_computes = {}
        self.pour_fixes = []
        self.gran_radius = self.gran_rmass = None
        # a state's per-atom values (computes.eval_peratom) and thermo row
        # are formed once: keyed by the step and the force result, the
        # row also by a generation the fixes' per-atom stores bump
        self._gen = 0
        self._peratom = (None, None, {})
        self._row_cache = None

    @staticmethod
    def from_script(script) -> "Simulation":
        u = script.units
        dtype = script.dtype
        device = resolve_device(script.device)
        n = script.x.shape[0]
        dim_ = script.dimension
        name = script.pair.name
        hybrid = name in ("hybrid", "hybrid/overlay")
        if u.name == "real" and any(
                "charmmfsw" in nm or "charmmfsh" in nm
                for nm in [name] + [nm for nm, _ in (
                    script.pair_hybrid if hybrid else ())]):
            # the charmmfsw and charmmfsh styles switch qqr2e to the CHARMM
            # constant under units real (pair_lj_charmmfsw_coul_charmmfsh
            # .cpp:50-58, force.cpp:56-57; the JAX package's sim.py
            # :964-970)
            u = dataclasses.replace(u, qqr2e=332.0716)
        if name in GRAN_STYLES:
            # atom_style sphere with pair gran/*: the granular route (the
            # JAX package's sim.py:1058-1061)
            from lidp_tpu_torch.styles.gran_builders import \
                build_granular_sim

            return build_granular_sim(script, u, dtype, device)
        _check_not_granular(script, name)
        if name not in PAIR_STYLES + EAM_STYLES:
            raise NotImplementedError(
                f"pair_style {name or '(none)'}: the port's script engine "
                f"runs {', '.join(PAIR_STYLES + EAM_STYLES)} only (other "
                "pair styles: ROADMAP queue 1 item 6, breadth)")
        eam = name in EAM_STYLES
        if eam and script.box_tilt is not None and any(
                float(v) != 0.0 for v in script.box_tilt):
            # the JAX package's message (its sim.py:1788-1790)
            raise NotImplementedError(
                "triclinic + eam: the EAM cell kernel is orthogonal-only")
        if eam and script.eam_file is None:
            raise ValueError("All pair coeffs are not set")
        polar = name.endswith("/polarization")
        coul = "coul" in name
        charmm = "charmm" in name
        tip4p = script.pair.tip4p is not None
        # the style, or a hybrid's sub-styles
        names = [n for n, _ in script.pair_hybrid] if hybrid else [name]
        msm_pair = any(n.endswith("/msm") for n in names)
        # the long dispersion styles: the r^-6 term's k-space half in the
        # ewald/disp or pppm/disp dispersion sum
        long_disp = name in ("lj/long/coul/long", "buck/long/coul/long") \
            or (name == "lj/long/tip4p/long" and script._tip4p_lj_long)
        # the coulomb styles a k-space sum completes (coul/cut, debye,
        # dsf, wolf, charmm, gromacs and the tip4p/cut styles take none)
        coul_long = any(n.endswith(("coul/long", "coul/msm",
                                    "/polarization")) for n in names)
        needs_kspace = coul_long or (tip4p
                                     and script.pair.tip4p_mode == "long")
        if needs_kspace and script.kspace is None:
            raise ValueError(f"Pair style {name} requires a KSpace style")
        if not needs_kspace and script.kspace is not None:
            raise ValueError(f"KSpace style {script.kspace[0]} is "
                             f"incompatible with pair style {name}")
        if needs_kspace:
            _check_kspace(name, script.kspace[0], msm_pair, long_disp)
        dense = not prescan(script, n)
        above_cap = n > fast_polar.DENSE_PATH_MAX_ATOMS
        npad = n if dense else aligned_npad(n)

        def _padA(a, fill=0.0):
            a = np.asarray(a)
            if npad == a.shape[0]:
                return a
            out = np.full((npad,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        # group masks padded False; real-count checks keep script.groups
        groups = {k: _padA(v, False) for k, v in script.groups.items()}
        mask_pad = np.arange(npad) < n
        alpha = _padA(script.alpha_type[script.type])
        box = Box.create(script.box_lo, script.box_hi, dtype=dtype,
                         periodic=script.periodic, tilt=script.box_tilt,
                         device=device)
        sys = make_system(
            _padA(script.x), box=box, v=_padA(script.v), q=_padA(script.q),
            type=_padA(script.type, 0), mol=_padA(script.mol, 0),
            alpha=alpha, image=_padA(script.image, 0), mask=mask_pad,
            dtype=dtype, device=device)
        sys = sys.replace(step=int(script.step))
        # padded atoms get unit mass so 1/m stays finite (f == 0 keeps
        # v == 0)
        mass_atom = _padA(script.mass_type[script.type], 1.0)

        # ---- pair tables, exclusions, kspace ----
        hbond_alone = name in pb.HBOND_STYLES
        generic = name in pb.GENERIC_PAIR_KINDS or name in (
            "table", "dpd", "dpd/tstat") or hybrid or hbond_alone
        if generic:
            # no LJ tables: the charmm dihedral's 1-4 term has none, as in
            # the JAX package
            eps = sig = None
        elif name == "buck/long/coul/long":
            eps = sig = np.zeros((script.ntypes + 1, script.ntypes + 1))
            tA, tRinv, tC, cut = _buck_tables(script)
        else:
            eps, sig, cut = pb.mix_pair_tables(script)
        excl_types = None
        if script.neigh_exclude_types:
            # neigh_modify exclude type (the JAX package's sim.py:1088-1096)
            excl_types = np.zeros((script.ntypes + 1, script.ntypes + 1),
                                  bool)
            for t1, t2 in script.neigh_exclude_types:
                excl_types[t1, t2] = excl_types[t2, t1] = True
        eamp = pair = b_atom = dpdp = None
        extra_pairs, extra_flags = (), ()
        etail = ptail = 0.0
        if script._pair_tail and (generic or eam or long_disp):
            # the JAX package forms the tail of the lj/cut family alone
            # (its sim.py:1237-1258) and skips the keyword for the rest
            raise NotImplementedError(
                f"pair_modify tail with pair_style {name}: the JAX package "
                "adds no tail correction there (ROADMAP queue 3 item 37)")
        if name == "table":
            pair, cut = pb._build_table_pair(script, excl_types, dtype,
                                             device)
        elif name in ("dpd", "dpd/tstat"):
            cut, dpdp = pb._build_dpd_pair(script, u, dtype, device)
        elif hybrid:
            pair, extra_pairs, extra_flags, cut = pb._build_hybrid_pair(
                script, u, excl_types, dtype, device)
        elif hbond_alone:
            pair, cut = pb._build_hbond_base(script, u, dtype, device)
        elif name in pb.GENERIC_PAIR_KINDS:
            pair, cut = pb._build_generic_pair(script, u, excl_types, dtype,
                                               device)
        elif name == "eam":
            eamp, _ = build_eam_params(script.eam_file, dtype=dtype,
                                       device=device)
        elif eam:
            eamp, _ = build_eam_alloy_params(
                script.eam_file, script.eam_type_elems, dtype=dtype,
                device=device, fs=name == "eam/fs")
        elif long_disp:
            # both sums long (the JAX package's sim.py:1158-1233): the
            # short-range part and the g6-damped r^-6 complement, with the
            # per-atom B_i of EwaldDisp::init_coeffs; the tip4p flavour's
            # coulomb runs on the charge sites (coul False)
            kw = dict(cut_coul=script.pair.cut_coul, qqrd2e=u.qqr2e,
                      coul=not tip4p, special_lj=script.special_lj,
                      special_coul=script.special_coul,
                      excl_types=excl_types, dtype=dtype, device=device)
            tt = np.arange(1, script.ntypes + 1)
            if name == "buck/long/coul/long":
                pair = make_long_pair_params("buck/long", tA, tC, cut,
                                             rhoinv=tRinv, **kw)
                # B_i = sqrt(|C_tt|)
                b_type = np.sqrt(np.abs(np.concatenate([[0.0],
                                                        tC[tt, tt]])))
            else:
                s6t = sig ** 6
                pair = make_long_pair_params("lj/long", 4.0 * eps * s6t * s6t,
                                             4.0 * eps * s6t, cut, **kw)
                # B_i = sqrt(4 eps_tt) sigma_tt^3
                b_type = (np.sqrt(4.0 * np.concatenate([[0.0], eps[tt, tt]]))
                          * np.concatenate([[0.0], sig[tt, tt]]) ** 3)
            b_atom = b_type[script.type]
        else:
            if script._pair_tail and not charmm:
                etail, ptail = pb.tail_corrections(script, eps, sig, cut)
            pair = make_pair_params(
                eps, sig, cut,
                cut_coul=script.pair.cut_coul if coul or tip4p else 0.0,
                qqrd2e=u.qqr2e, coul=coul, g_ewald=pb.coul_g(script, name),
                special_lj=script.special_lj,
                special_coul=script.special_coul, excl_types=excl_types,
                shift=script._pair_shift,
                cut_lj_inner=script.pair.cut_lj_inner, charmm=charmm,
                charmm_fsw="charmmfsw" in name,
                coul_kind=pb.coul_kind_of(name),
                cut_coul_inner=script.pair.cut_coul_inner, dtype=dtype,
                device=device)
        ks = _kspace_terms(script, u, pair, b_atom, n, dtype, device) \
            if needs_kspace else {}
        pair = ks.pop("pair", pair)
        if extra_pairs and ("ewald" in ks or "pppm" in ks):
            # the coul/long sub-styles take the k-space g_ewald (the JAX
            # package's sim.py:1319-1324, 1396-1402)
            extra_pairs = tuple(
                dataclasses.replace(pe, g_ewald=pair.g_ewald) if fl else pe
                for pe, fl in zip(extra_pairs, extra_flags[1:]))
        # the TIP4P sites (the JAX package's sim.py:1442-1465): the dense
        # route only
        tipp = _tip4p_params(script, npad, n, device) if tip4p else None
        if script.neigh_exclude_mol and pair is not None:
            pair = dataclasses.replace(pair, excl_mol=True)
            extra_pairs = tuple(dataclasses.replace(pe, excl_mol=True)
                                for pe in extra_pairs)
        pol = polarization_settings(script.pair) if polar else None
        # a barostat moves the box: the Ewald tables follow it and the
        # integrator reads the virial every step (the JAX package's
        # sim.py:1612-1617, 1667, 2005)
        # (fix box/relax, which moves the box only in `minimize`, counts
        # as one there too)
        has_baro = any(f.style in BAROSTATS + ("box/relax",)
                       for f in script.fixes.values())
        # the post_force terms that depend on the velocities (the
        # constraint forces and their virial, langevin's friction and
        # noise, viscous drag) cannot be re-tallied at a chunk boundary:
        # the Runner evaluates the virial every step (the JAX package's
        # has_vdep_pf, its sim.py:1618-1620)
        has_vdep_pf = any(f.style in ("shake", "rattle", "langevin",
                                      "viscous")
                          for f in script.fixes.values())

        # ---- neighbour strategy (the JAX package's sim.py:1785-1820) ----
        ncfg = None
        if eam:
            # the file's cutoff in the run's dtype, as the JAX package reads
            # float(eamp.cut)
            ncfg = _cell_config(script, float(eamp.cut), n, False)
            if ncfg is None:
                raise NotImplementedError(
                    f"pair_style {name} in a box under 3 cells of the "
                    f"potential's cutoff plus the skin ({script.skin:g}) a "
                    "side: the JAX package takes a neighbour list here "
                    "(ROADMAP queue 1 item 5, neighbour lists)")
        elif dense and above_cap and name not in ("table", "dpd",
                                                   "dpd/tstat"):
            # the table and DPD take the dense route at every size, as in
            # the JAX package (its sim.py:1791-1797)
            ncfg = _cell_config(script, cut, n, coul)
            if ncfg is None and not polar:
                raise NotImplementedError(
                    f"{n} atoms in a box under 3 cells of the largest "
                    f"cutoff plus the skin ({script.skin:g}) a side: above "
                    "the dense cap the JAX package takes a neighbour list "
                    "here (ROADMAP queue 1 item 5, neighbour lists)")

        sp_lists = sp_code = sp_idx = sp_lvl = None
        has_bonds = script._bonds is not None and len(script._bonds)
        if has_bonds and not above_cap:
            # the JAX package builds the codes up to the cap only
            # (lidp_tpu/sim.py:1471; ROADMAP queue 3), on the panel engine
            # too (padded), where only `minimize`'s dense evaluation reads
            # them
            code = topo_mod.special_codes_dense(n, script._bonds)
            if npad != n:
                code = np.pad(code, ((0, npad - n), (0, npad - n)))
            sp_code = torch.as_tensor(code, device=device)
        if has_bonds and (ncfg is not None or not dense):
            si, sl = topo_mod.special_lists(n, script._bonds)
            if npad != n:
                # remap the "invalid" fill (== n) past the padding, then pad
                si = np.where(si == n, npad, si)
                si = np.concatenate(
                    [si, np.full((npad - n, si.shape[1]), npad, si.dtype)])
                sl = np.concatenate(
                    [sl, np.zeros((npad - n, sl.shape[1]), sl.dtype)])
            if dense:
                sp_idx = torch.as_tensor(si, dtype=torch.long, device=device)
                sp_lvl = torch.as_tensor(sl, dtype=torch.long, device=device)
            else:
                sp_lists = (si, sl)

        # read_data keeps each atom's stored coordinates; the polar F.r
        # virial uses them wrapped as they stood at the run's start
        L0 = script.box_hi - script.box_lo
        polar_xshift = _padA(
            -np.floor((script.x - script.box_lo) / L0) * L0)
        if dense:
            polar_xshift = torch.as_tensor(polar_xshift, dtype=dtype,
                                           device=device)
        # the hydrogen bonds' rows, before the bonded terms as in the JAX
        # package (its sim.py:1502-1517)
        hbond = _hbond_params(script, n, dtype, device)
        # ---- fix shake pre-pass and the bonded terms ----
        from lidp_tpu_torch.styles.fix_modifiers import shake_pre_pass

        shake_found, shake_cfg, bond_keep, angle_keep = shake_pre_pass(
            script, mass_atom)
        bonded = _bonded_params(script, dtype, device, u, eps, sig, cut,
                                bond_keep, angle_keep)
        cmapp, cmap_fid = _cmap_params(script, dtype, device,
                                       cells=ncfg is not None)
        ff = ForceField(pair=pair, eam=eamp, polar=pol, qqrd2e=u.qqr2e,
                        extra_pairs=extra_pairs, dpd=dpdp,
                        hbond=hbond, cmap=cmapp,
                        polar_xshift=polar_xshift, sp_code=sp_code,
                        sp_idx=sp_idx, sp_lvl=sp_lvl,
                        kspace_dynamic=(has_baro
                                        and ks.get("ewald") is not None),
                        tip4p=tipp,
                        tip4p_cut=script.pair.tip4p_mode == "cut",
                        b_atom=(None if b_atom is None else torch.as_tensor(
                            _padA(b_atom), dtype=dtype, device=device)),
                        **ks, **bonded)

        # ---- integrator from fixes ----
        from lidp_tpu_torch.styles import FixBuildCtx, build_fixes

        fctx = build_fixes(FixBuildCtx(
            script=script, groups=groups, u=u, dtype=dtype, device=device,
            mass_atom=mass_atom, padA=_padA, n=n, dim=dim_, sys=sys,
            shake_found=shake_found, shake_cfg=shake_cfg))
        if fctx.integ is None:
            # no time-integration fix: nve with dt 0, the atoms frozen (the
            # JAX package's sim.py:1781-1783)
            from lidp_tpu_torch.integrate import nve as nve_mod
            from lidp_tpu_torch.integrate.driver import nve_integrator

            fctx.integ = nve_integrator(nve_mod.NVEParams.create(
                0.0, u.ftm2v, mass_atom, dtype=dtype, device=device))
        sys = fctx.sys
        integ = fctx.integ
        if fctx.shake_dof_removed and hasattr(integ.params, "dof"):
            # a thermostat sees the constrained dof whatever the fixes'
            # order (the reference's temperature computes query fix_dof at
            # run time; the JAX package's sim.py:1822-1830)
            integ = dataclasses.replace(integ, params=dataclasses.replace(
                integ.params,
                dof=float(integ.params.dof) - fctx.shake_dof_removed))
        runner = Runner(ff, integ, neighbor_cfg=ncfg,
                        rebuild_every=script.neigh_every if ncfg else 1,
                        check=script.neigh_check, skin=script.skin,
                        delay=script.neigh_delay,
                        every_step_ev=has_baro or has_vdep_pf,
                        post_force=_compose_pf(fctx.pf_hooks),
                        post_force_setup=(_compose_pf(fctx.pf_hooks_setup)
                                          if fctx.pf_hooks_setup
                                          != fctx.pf_hooks else None),
                        end_of_step=_compose_eos(fctx),
                        post_integrate=_compose_pi(fctx.pi_hooks),
                        shrink=shrink_spec(script))
        if dense:
            if above_cap and polar:
                script.log(_ABOVE_CAP)
        else:
            runner = maybe_attach(
                runner, script=script, ff=ff, pol=pol, sys=sys, n=n,
                npad=npad, dt=script.dt, ftm2v=u.ftm2v, dtype=dtype,
                sp_lists=sp_lists, log=script.log)
            if runner is None:
                # the JAX package would run its Runner on the padded
                # System; no script the port reads gets here
                raise NotImplementedError(
                    "the panel engine declined a script its prescan took "
                    "(bonded terms or another term it does not compose "
                    "with, which the JAX package runs on the padded "
                    "System: ROADMAP queue 1 item 6, breadth)")

        # ---- thermo ----
        # compute_modify thermo_temp extra N replaces the default extra dof
        # (dim; compute.cpp modify_params)
        cmod = script._compute_modify
        extra_dof = float(cmod.get("thermo_temp", {}).get("extra", dim_))
        dof = dim_ * n - extra_dof - fctx.dof_removed
        norm = script._thermo_norm
        tp = ThermoParams.create(
            mass_atom, dof=dof, units=u,
            norm=(u.name == "lj") if norm is None else norm, natoms=n,
            dim=dim_, etail=etail, ptail=ptail, dtype=dtype, device=device)
        if script._thermo_temp is not None:
            # thermo_modify temp ID: Temp, KE, TotEng and the pressure's
            # kinetic part follow the compute's group, its dof dim*ng - dim
            # less every fix's removed dof; the norm is the units' default
            # and natoms stay global (the JAX package's sim.py:2153-2162)
            tgmask = groups[script.computes[script._thermo_temp][0]]
            ngt = int(np.count_nonzero(tgmask))
            tp = ThermoParams.create(
                np.where(tgmask, mass_atom, 0.0),
                dof=dim_ * ngt - dim_ - fctx.dof_removed, units=u,
                norm=u.name == "lj", natoms=n, dim=dim_, dtype=dtype,
                device=device)
        sim = Simulation(script, sys, runner, tp, n)
        sim.cmap_fid = cmap_fid
        sim._wire_computes(groups, mass_atom, fctx.rigid_groups)
        return sim

    def _wire_computes(self, groups, mass_atom, rigid_groups):
        """Sort the script's computes into the tables the thermo row, the
        output fixes and the dumps read (the JAX package's sim.py
        :2041-2151).  A temperature compute (temp, temp/partial, temp/com)
        gets the ThermoParams of its group: dof dim*ng - dim (compute_modify
        extra replacing dim; temp/partial nper*ng - nper,
        compute_temp_partial.cpp:77-86), less a rigid fix's removed dof
        when all its bodies lie in the group.  Group masks are the script's
        (the real atoms); references become float64 tensors on the
        device."""
        script = self.script
        dim_ = script.dimension
        dev = self.sys.x.device
        cmod = script._compute_modify

        def ref(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        from lidp_tpu_torch.io.dump import LOCAL_STYLES

        for cid, spec_c in script.computes.items():
            gname, style = spec_c[0], spec_c[1]
            if style in LOCAL_STYLES:
                continue        # evaluated at dump local's frames
            gm = script.groups[gname].copy()
            if style in ("temp", "temp/partial", "temp/com"):
                gmask = groups[gname]
                ng = int(gmask.sum())
                gdof = dim_ * ng - dim_
                if "extra" in cmod.get(cid, {}):
                    gdof = dim_ * ng - float(cmod[cid]["extra"])
                vcomp = (True, True, True)
                if style == "temp/partial":
                    flags = spec_c[2]
                    vcomp = tuple(bool(f) for f in flags)
                    nper = sum(1 for f in flags if f)
                    gdof = nper * ng - (nper / dim_) * dim_
                for _, rsetup in rigid_groups:
                    if np.all(gmask[rsetup.body_of_atom >= 0]):
                        gdof -= rsetup.dof_removed
                self.group_thermo[cid] = ThermoParams.create(
                    np.where(gmask, mass_atom, 0.0), dof=gdof,
                    units=script.units, norm=False, natoms=ng, dim=dim_,
                    vcomp=vcomp, com_bias=style == "temp/com",
                    dtype=self.sys.x.dtype, device=dev)
                continue
            spec = spec_c[2]
            if style in ("ke/rigid", "erotate/rigid"):
                self.rigid_computes[cid] = style
            elif style == "group/group":
                self.gg_computes[cid] = (gm, script.groups[spec].copy())
            elif style == "msd":
                self.msd_computes[cid] = (gm, ref(spec))
            elif style == "vacf":
                self.vacf_computes[cid] = (gm, ref(spec))
            elif style == "rdf":
                self.rdf_computes[cid] = (gm, int(spec))
            elif style in ("com", "gyration", "ke", "pe"):
                self.simple_computes[cid] = (gm, style)
            elif style in computes.PERATOM_STYLES:
                if style == "displace/atom":
                    spec = {"x0": ref(spec["x0"])}
                self.peratom_computes[cid] = (gm, style, spec)
            elif style == "slice":
                self.slice_computes[cid] = dict(spec)
            elif style == "chunk/atom":
                self.chunk_computes[cid] = (gm, spec)
            elif style in computes.CHUNK_AGG_STYLES:
                self.chunkagg_computes[cid] = (gm, style, spec["chunk"],
                                               spec["extra"])
            elif style == "heat/flux":
                self.hf_computes[cid] = (gm, list(spec["ids"]))
            elif style == "pressure":
                self.press_computes[cid] = dict(spec)
            elif style == "reduce":
                self.reduce_computes[cid] = (gm, spec)
            else:   # temp/ramp, temp/region, temp/profile
                self.tempvar_computes[cid] = (gm, style, spec)

    # ------------------------------ output -------------------------------

    def peratom_cache(self) -> dict:
        """The per-atom values of the current state (computes.py), emptied
        when the step or the force result changes."""
        step, res, cache = self._peratom
        if step != int(self.sys.step) or res is not self.res:
            cache = {}
            self._peratom = (int(self.sys.step), self.res, cache)
        return cache

    def bump_generation(self):
        """A fix's per-atom store changed: the next row is formed anew."""
        self._gen += 1

    def _global_computes(self) -> tuple:
        """The global computes' values as 0-d tensors, not yet read: the
        c_ID and c_ID[i] columns (the JAX package's sim.py:2998-3064 and
        the pressure computes of :3081-3098, which it adds after the
        v_NAME columns)."""
        out = {"c_" + cid: temperature(self.sys, tp)
               for cid, tp in self.group_thermo.items()}
        for cid, (ma, mb) in self.gg_computes.items():
            out["c_" + cid] = computes.group_group_energy(self, ma, mb)
        for cid, rstyle in self.rigid_computes.items():
            out["c_" + cid] = computes.rigid_scalar(self, rstyle)
        tp = self.thermo_params
        if self.cmap_fid is not None:
            # fix cmap's f_ID: the crossterm energy (compute_scalar,
            # fix_cmap.cpp:623; extensive, so normalized under norm yes)
            out["f_" + self.cmap_fid] = self.res.ecmap / (
                float(tp.natoms) if tp.norm else 1.0)
        for cid, (gm, style) in self.simple_computes.items():
            vals = computes.simple_compute(self, gm, style)
            if style == "com":
                for d in range(3):
                    out[f"c_{cid}[{d + 1}]"] = vals[d]
            else:
                out["c_" + cid] = vals[0]
        for table, fn in ((self.msd_computes, computes.msd),
                          (self.vacf_computes, computes.vacf)):
            for cid, (gm, ref) in table.items():
                for k, val in enumerate(fn(self, gm, ref)):
                    out[f"c_{cid}[{k + 1}]"] = val
        for cid, (_, spec) in self.reduce_computes.items():
            vals = computes.eval_reduce(self, cid)
            # reduce sum is extensive (compute_reduce.cpp extvector=1):
            # thermo normalizes it by natoms under norm yes
            nrm = (1.0 / tp.natoms if tp.norm and spec["mode"] == "sum"
                   else 1.0)
            if len(vals) == 1:
                out["c_" + cid] = vals[0] * nrm
            else:
                for k, val in enumerate(vals):
                    out[f"c_{cid}[{k + 1}]"] = val * nrm
        for cid, (gm, style, args) in self.tempvar_computes.items():
            out["c_" + cid] = computes.temp_variant(self, gm, style, args)
        for cid, gm in self.erotate_computes.items():
            # compute erotate/sphere, not normalized (the JAX package's
            # sim.py:2970-2978; ROADMAP queue 3 item 45)
            out["c_" + cid] = computes.erotate_sphere(self, gm)
        for cid, gm in self.tempsphere_computes.items():
            out["c_" + cid] = computes.temp_sphere(self, gm)
        late = {}
        virial = self.res.virial
        ev = getattr(self.istate, "virial", None)
        if ev is not None:
            virial = virial + ev
        for cid, spec in self.press_computes.items():
            # compute pressure temp-ID|NULL [virial]: the named temperature
            # compute's kinetic part, none for NULL or virial
            tcid = spec["temp"]
            late["c_" + cid] = compute_pressure(
                self.sys, self.group_thermo.get(tcid, self.thermo_params),
                virial, kinetic=tcid != "NULL" and "virial" not in spec["kw"])
        # then, as the JAX package adds them (its sim.py:3099-3117): a
        # compute slice of one column by row, heat/flux's six components
        # and temp/chunk's scalar
        for cid in self.slice_computes:
            sl = fix_output.eval_slice(self, cid)
            if sl.shape[1] == 1:
                for k in range(sl.shape[0]):
                    late[f"c_{cid}[{k + 1}]"] = sl[k, 0]
        for cid in self.hf_computes:
            hf = computes.eval_heat_flux(self, cid)
            for k in range(6):
                late[f"c_{cid}[{k + 1}]"] = hf[k]
        for cid, (_, style, _, extra) in self.chunkagg_computes.items():
            if style == "temp/chunk" and not computes.temp_chunk_keywords(
                    extra, tp.dim)[3]:
                late["c_" + cid] = computes.eval_chunk_agg(self, cid)
        return out, late

    def thermo_row(self) -> dict:
        """The thermo row of the current state: thermo_row with the
        integrator's constraint virial in the pressure and every global
        compute's c_ID / c_ID[i] (temperatures, pe, ke, com, gyration, msd,
        vacf, reduce, group/group, the rigid and biased temperatures,
        pressure, a one-column slice, heat/flux, temp/chunk's scalar),
        every scalar read to the host in one transfer; the atom and
        topology counts and dt; then the v_NAME columns, evaluated with
        this row as the thermo keywords' context (thermo.cpp
        compute_variable), and the pressure, slice, heat/flux and
        temp/chunk computes after them, as the JAX package orders them.
        The read is formed once per state."""
        key = (int(self.sys.step), self._gen)
        cached = self._row_cache
        if cached is not None and cached[0] == key and cached[1] is self.res:
            base, late = cached[2], cached[3]
        else:
            extra, late = self._global_computes()
            base = thermo_row(self.sys, self.res, self.thermo_params,
                              extra_virial=getattr(self.istate, "virial",
                                                   None),
                              extra={**extra, **late})
            late = {k: base.pop(k) for k in late}
            base["atoms"] = self.natoms
            bonds = self.script._bonds
            base["bonds"] = 0 if bonds is None else len(bonds)
            base["dt"] = float(self.script.dt)
            self._row_cache = (key, self.res, base, late)
        row = dict(base)
        prev = self.script._kw_row
        self.script._kw_row = row
        try:
            for c in self.script.thermo_columns:
                if c.startswith("v_"):
                    try:
                        row[c] = float(self.script.var_value(c[2:]))
                    except (KeyError, ValueError) as e:
                        raise NotImplementedError(
                            f"thermo column {c}: {e} (the JAX package prints "
                            "nan: ROADMAP queue 3 item 26, values JAX's "
                            "thermo row lacks)") from e
        finally:
            self.script._kw_row = prev
        row.update(late)
        return row

    def compute_rdf(self, cid):
        """compute rdf: its (Nbin, 3) array [r, g(r), coord] now
        (computes.rdf), read through api.lammps.extract_compute."""
        gm, nbin = self.rdf_computes[cid]
        return computes.rdf(self, gm, nbin)

    _HEADER = {"step": "Step", "etotal": "TotEng", "ke": "KinEng",
               "pe": "PotEng", "evdwl": "E_vdwl", "ecoul": "E_coul",
               "elong": "E_long", "epol": "E_pol", "temp": "Temp",
               "press": "Press", "epair": "E_pair", "emol": "E_mol",
               "ebond": "E_bond", "eangle": "E_angle", "edihed": "E_dihed",
               "eimp": "E_impro", "vol": "Volume", "density": "Density",
               "atoms": "Atoms", "lx": "Lx", "ly": "Ly", "lz": "Lz",
               "xlo": "Xlo", "xhi": "Xhi", "ylo": "Ylo", "yhi": "Yhi",
               "zlo": "Zlo", "zhi": "Zhi", "xy": "Xy", "xz": "Xz",
               "yz": "Yz", "bonds": "Bonds", "dt": "Dt"}

    def _emit(self):
        row = self.thermo_row()
        self.script.thermo_rows.append(row)
        cols = self.script.thermo_columns
        # thermo_modify format float FMT (thermo.cpp modify_params)
        ffmt = self.script._thermo_float_format
        vals = [row.get(c, float("nan")) for c in cols]
        self.script.log(" ".join(
            f"{int(v)}" if c == "step"
            else (ffmt % v if ffmt else f"{v:.8g}")
            for c, v in zip(cols, vals)))

    def _dump(self):
        """The dump frames of this step, in declaration order (the JAX
        package's sim.py:3682-3731): dcd, local, image and movie, cfg,
        else custom, atom and xyz."""
        from lidp_tpu_torch.io import dump as dump_mod

        step = int(self.sys.step)
        for d in self.script.dumps.values():
            if not d.every or step % d.every:
                continue
            gmask = self.script.groups[d.group]
            if d.style == "dcd":
                dump_mod.write_dcd_frame(d, self.sys, self.script, gmask)
            elif d.style == "local":
                dump_mod.write_local_frame(d, self, self.script)
            elif d.style == "image":
                dump_mod.write_image_frame(d, self.sys, self.script, gmask)
            elif d.style == "movie":
                dump_mod.write_movie_frame(d, self.sys, self.script, gmask)
            elif d.style == "cfg":
                dump_mod.write_cfg_frame(d, self.sys, self.script, gmask)
            else:
                dump_mod.write_dump_frame(
                    d, self.sys, self.script, gmask,
                    f=None if self.res is None else self.res.f)

    # -------------------------------- run --------------------------------

    def _pour_boundary(self, chunk, todo):
        """Fix pour's insertions at a chunk boundary (the JAX package's
        sim.py:3604-3616): the events of the next step, then the chunk cut
        to the absolute thermo grid and to end just before the next
        event."""
        step_now = int(self.sys.step)
        evs = [e for e in (p.next_event() for p in self.pour_fixes)
               if e is not None]
        if evs and min(evs) == step_now + 1:
            self._pour_events(step_now + 1)
            evs = [e for e in (p.next_event() for p in self.pour_fixes)
                   if e is not None]
        if step_now % chunk:
            todo = min(todo, chunk - step_now % chunk)
        if evs:
            todo = min(todo, max(1, min(evs) - 1 - step_now))
        return todo

    def _pour_events(self, ev_step):
        """Every fix pour whose next insertion is ev_step
        (FixPour::pre_exchange; the JAX package's sim.py:3225-3285): the
        new atoms written into the host copies of x, v, radius, mass and
        mask, wound back one half-kick and drift (pour.py), the grid
        rebuilt with the shear history migrated, and the thermo's masses,
        atom count and dof following the inserted count."""
        from lidp_tpu_torch.ops.cells import build_cells
        from lidp_tpu_torch.ops.granular import migrate_shear

        runner = self.runner
        gp = runner.gp
        sys = self.sys
        dev, dtype = sys.x.device, sys.x.dtype

        def host(t):
            return t.cpu().numpy().copy()

        x, v, mask = host(sys.x), host(sys.v), host(sys.mask)
        radius, rmass, f = host(gp.radius), host(gp.rmass), host(self.res.f)
        rows = []
        for pf in self.pour_fixes:
            if pf.next_event() == ev_step:
                rows += pf.insert(ev_step, x, v, radius, rmass, mask,
                                  self.natoms)
        if not rows:
            return
        grav = runner.grav.double().cpu().numpy()
        dtf2 = 0.5 * runner.dt * runner.ftm2v
        for s in rows:
            x[s] = x[s] - runner.dt * v[s]
            v[s] = v[s] - dtf2 * grav
            f[s] = rmass[s] * grav

        def dev_t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        sys = sys.replace(x=dev_t(x), v=dev_t(v),
                          mask=torch.as_tensor(mask, device=dev))
        runner.gp = dataclasses.replace(gp, radius=dev_t(radius),
                                        rmass=dev_t(rmass))
        new = build_cells(sys.x, sys.mask, sys.box, runner.neighbor_cfg)
        st = self.istate
        shear = st.shear if gp.kind == "hooke" else migrate_shear(
            st.shear, self.nlist, new)
        self.istate = dataclasses.replace(st, shear=shear, x_ref=sys.x,
                                          last_build=int(sys.step),
                                          pairs=runner.pairs_of(new))
        self.nlist = new
        self.sys = sys
        self.res = dataclasses.replace(self.res, f=dev_t(f))
        self.natoms += len(rows)
        self.thermo_params = dataclasses.replace(
            self.thermo_params, mass_atom=runner.gp.rmass,
            natoms=self.natoms, dof=3 * self.natoms - 3)
        self.gran_radius, self.gran_rmass = runner.gp.radius, runner.gp.rmass

    def run(self, nsteps: int):
        """Advance nsteps: setup on the first run, fix vector's setup
        sample, the header, the row of the start and its dump frames, fix
        ave/time's setup sample, then the steps in chunks of the gcd of the
        thermo, dump and output-fix intervals, at each boundary the output
        fixes (styles/fix_output.py), a row and the dump frames, and the
        `Loop time` / `Performance` lines (Finish::end, finish.cpp:64)."""
        t_start = time.perf_counter()
        # the thermostats' target ramps span exactly this run
        # (FixNH::compute_temp_target uses update->beginstep/endstep)
        integ = getattr(self.runner, "integ", None)
        if integ is not None and hasattr(integ.params, "ramp_begin"):
            b = int(self.sys.step)
            self.runner.integ = dataclasses.replace(
                integ, params=dataclasses.replace(
                    integ.params, ramp_begin=b, ramp_end=b + nsteps))
        nvt = getattr(self.runner, "nvt", None)
        if nvt is not None:
            # fix nvt/sphere's ramp spans this run (the granular runner)
            b = int(self.sys.step)
            self.runner.nvt = dataclasses.replace(nvt, ramp_begin=b,
                                                  ramp_end=b + nsteps)
        if self.res is None:
            self.sys, self.res, self.nlist, self.istate = \
                self.runner.setup(self.sys)
        fixes = list(self.script.fixes.values())
        # FixVector::setup samples at run start when the step lands on
        # the Nevery grid (fix_vector.cpp:242-253)
        for spec in fixes:
            if spec.style == "vector":
                fix_output.vector_sample(self, spec, int(self.sys.step))
        # msd/chunk takes its reference centres at the run's setup
        # (ComputeMSDChunk::setup)
        for cid, (_, style, _, _) in self.chunkagg_computes.items():
            if style == "msd/chunk" and cid not in self.msdchunk_ref:
                computes.eval_chunk_agg(self, cid)
        self.script.log(" ".join(
            self._HEADER.get(c, c) for c in self.script.thermo_columns))
        # fix store/state's setup snapshot, before the setup row and dump
        # frames that read it (FixStoreState::end_of_setup semantics)
        for spec in fixes:
            if spec.style == "store/state" and getattr(
                    spec, "_peratom_store", None) is None:
                fix_output.store_state(self, spec, int(self.sys.step))
        self._emit()
        self._dump()
        # FixAveTime::setup -> end_of_step fires at the setup step when
        # nrepeat == 1 and the step is a multiple of Nfreq, once
        step0 = int(self.sys.step)
        for spec in fixes:
            if (spec.style == "ave/time" and int(spec.args[1]) == 1
                    and int(spec.args[2]) > 0
                    and step0 % int(spec.args[2]) == 0
                    and not getattr(spec, "_started_setup", False)):
                spec._started_setup = True
                fix_output.ave_time(self, spec, step0)
        remaining = nsteps
        every = self.script.thermo_every or nsteps
        chunk_opts = [every] + [d.every for d in self.script.dumps.values()
                                if d.every] \
            + fix_output.chunk_periods(self.script)
        chunk = int(np.gcd.reduce(chunk_opts))
        while remaining > 0:
            todo = min(chunk, remaining)
            if self.pour_fixes:
                todo = self._pour_boundary(chunk, todo)
            self.sys, self.res, self.nlist, self.istate = self.runner.run(
                self.sys, self.res, self.nlist, self.istate, todo)
            remaining -= todo
            step = int(self.sys.step)
            if self.nlist is not None and bool(self.nlist.overflow):
                raise RuntimeError(_OVERFLOW)
            fix_output.host_fixes(self, step)
            if every and step % every == 0 or remaining == 0:
                self._emit()
            self._dump()
        self.script.step = int(self.sys.step)

        if self.sys.x.device.type == "cuda":
            torch.cuda.synchronize(self.sys.x.device)
        wall = time.perf_counter() - t_start
        if nsteps > 0 and wall > 0:
            rate = nsteps / wall
            dt_ns = self.script.dt * self.script.units.femtosecond * 1e-6
            self.script.log(
                f"Loop time of {wall:.6g} on 1 procs for {nsteps} steps "
                f"with {self.natoms} atoms")
            self.script.log(
                f"Performance: {rate * dt_ns * 86400:.3f} ns/day, "
                f"{rate:.3f} timesteps/s")
