"""Simulation assembly: interpreter state -> a runnable system
(lidp_tpu/sim.py, the routes of lj/cut, lj/cut/coul/long,
lj/cut/coul/long/polarization, lj/charmm/coul/long,
lj/charmm/coul/charmm, eam, eam/alloy and eam/fs, with the bonded terms
and the modifier fixes).

The analog of the LAMMPS init phase (Run::command -> LAMMPS::init,
run.cpp:38): the lj/cut or lj/cut/coul/long tables with geometric (or
arithmetic) mixing for unset type pairs (Pair::init_one pair.cpp:660,
676), the neigh_modify exclusions, the k-space setup of a coulomb style
(Ewald, or PPPM's grid and g_ewald) with the `kspace_modify gewald`
override, the polarization settings of the pair keywords, the special
bonds of the Bonds section, the bonded terms of the bond, angle, dihedral
and improper styles (less the bonds and angles fix shake constrains, the
clusters found in a pre-pass), the integrator of the fixes (nve,
rigid/nve, rigid/nvt, rigid/npt, rigid/nph, nvt, npt, nph) with its dof
removal (FixRigid::dof, fix_rigid.cpp:1181; FixShake's constraints, which
the thermostats' dof lose too), the modifier fixes' post_force and
end_of_step hooks (rattle's velocity projection, the deferred temp/rescale
and temp/berendsen on their group's dof), the group temperatures of `compute ID
group temp`; then `run` (each run the window of the thermostats' and
barostats' target ramps), the thermo rows with their c_ID columns and the
dump frames.  Under a barostat the Ewald tables follow the live box
(ForceField.kspace_dynamic), PPPM reads it at each call, and the Runner
evaluates the virial every step (every_step_ev), so a thermo row reads the
step's own evaluation on the box after the step's remap.

It takes the route the JAX package takes:
  * the dense route (forcefield.compute_forces with nlist=None in the
    generic Runner, (N,N) tensors in plain PyTorch): every style at most
    DENSE_PATH_MAX_ATOMS atoms, the polar style only without
    LIDP_FAST_POLAR=1, with the System unpadded and the special codes of
    the Bonds section (built up to the cap only, as in JAX);
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
    plain torch), orthogonal boxes only, as in the JAX package.
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
import time

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch import topology as topo_mod
from lidp_tpu_torch.box import Box
from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.integrate.driver import Runner
from lidp_tpu_torch.io.script import EAM_STYLES, PAIR_STYLES
from lidp_tpu_torch.ops import polarization as pol_ops
from lidp_tpu_torch.ops.cells import CellConfig
from lidp_tpu_torch.ops.eam import build_eam_alloy_params, build_eam_params
from lidp_tpu_torch.ops.ewald import EwaldParams, setup_ewald_disp
from lidp_tpu_torch.ops.pair import make_pair_params
from lidp_tpu_torch.ops.pppm import PPPMParams, setup_pppm
from lidp_tpu_torch.parallel import fast_polar
from lidp_tpu_torch.parallel.fast_polar import (aligned_npad, maybe_attach,
                                                prescan)
from lidp_tpu_torch.state import make_system
from lidp_tpu_torch.thermo import ThermoParams, temperature, thermo_row

# the k-space styles the coulomb pair styles run with
KSPACE_STYLES = ("ewald", "ewald/disp", "pppm", "pppm/cg", "pppm/stagger")
# the fix styles that move the box (the JAX package's has_baro, less the
# styles the port does not have)
BAROSTATS = ("npt", "nph", "rigid/npt", "rigid/nph", "rigid/npt/small",
             "rigid/nph/small")

# the JAX package's warning for the dense route above the cap
# (lidp_tpu/sim.py:2020-2025)
_ABOVE_CAP = ("WARNING: polarization above the dense-path size cap is "
              "running the O(N^2) tensor path (fast-polar engine "
              "ineligible: unsupported fix/kspace/bonded composition)")
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


def _mix_pair_tables(script):
    """Per-type-pair eps/sigma/cut tables with geometric mixing for unset
    pairs (Pair::mix_energy/mix_distance defaults for lj/cut styles;
    pair_modify mix arithmetic mixes sigma arithmetically)."""
    T = script.ntypes
    eps = np.zeros((T + 1, T + 1))
    sig = np.zeros((T + 1, T + 1))
    cut = np.full((T + 1, T + 1), script.pair.cut_lj_global)
    seen = np.zeros((T + 1, T + 1), bool)
    for (i, j), (e, s, c) in script.pair_coeffs.items():
        eps[i, j] = eps[j, i] = e
        sig[i, j] = sig[j, i] = s
        cut[i, j] = cut[j, i] = c
        seen[i, j] = seen[j, i] = True
    mix = getattr(script, "_pair_mix", "geometric")
    for i in range(1, T + 1):
        for j in range(i + 1, T + 1):
            if not seen[i, j]:
                if not (seen[i, i] and seen[j, j]):
                    continue
                eps[i, j] = eps[j, i] = np.sqrt(eps[i, i] * eps[j, j])
                if mix == "arithmetic":
                    sig[i, j] = sig[j, i] = 0.5 * (sig[i, i] + sig[j, j])
                else:
                    sig[i, j] = sig[j, i] = np.sqrt(sig[i, i] * sig[j, j])
                cut[i, j] = cut[j, i] = 0.5 * (cut[i, i] + cut[j, j])
    return eps, sig, cut


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
            if not script.pair.name.startswith("lj/cut"):
                raise NotImplementedError(
                    "bond quartic pair subtraction supports lj/cut")
            pair_tables = (eps, sig, cut)
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

    @staticmethod
    def from_script(script) -> "Simulation":
        u = script.units
        dtype = script.dtype
        device = resolve_device(script.device)
        n = script.x.shape[0]
        dim_ = script.dimension
        name = script.pair.name
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
        # lj/charmm/coul/charmm: the switched coulomb, no k-space
        coul_long = coul and not name.endswith("coul/charmm")
        if coul_long and script.kspace is None:
            raise ValueError(f"Pair style {name} requires a KSpace style")
        if not coul_long and script.kspace is not None:
            raise ValueError(f"KSpace style {script.kspace[0]} is "
                             f"incompatible with pair style {name}")
        if coul_long and script.kspace[0] not in KSPACE_STYLES:
            raise NotImplementedError(
                f"kspace_style {script.kspace[0]}: the port runs the "
                f"coulomb pair styles with {', '.join(KSPACE_STYLES)} only "
                "(ROADMAP queue 1 item 6, breadth)")
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
        eps, sig, cut = _mix_pair_tables(script)
        excl_types = None
        if script.neigh_exclude_types:
            # neigh_modify exclude type (the JAX package's sim.py:1088-1096)
            excl_types = np.zeros((script.ntypes + 1, script.ntypes + 1),
                                  bool)
            for t1, t2 in script.neigh_exclude_types:
                excl_types[t1, t2] = excl_types[t2, t1] = True
        ew = pppm = None
        g_ewald = 0.0
        if coul_long:
            style, acc = script.kspace
            common = dict(accuracy_rel=acc, qqrd2e=u.qqr2e, q=script.q,
                          natoms=n, cutoff=script.pair.cut_coul,
                          box_lengths=script.box_hi - script.box_lo,
                          g_ewald=script._gewald_override)
            if style.startswith("pppm"):
                # pppm/cg spreads only the charged atoms, a sparsity
                # optimisation with the same result: it runs as pppm
                ps = setup_pppm(**common)
                g_ewald = ps.g_ewald
                pppm = PPPMParams.from_setup(
                    ps, u.qqr2e, float(np.sum(script.q ** 2)),
                    float(np.sum(script.q)), stagger=style == "pppm/stagger")
            else:
                es = setup_ewald_disp(**common)
                g_ewald = es.g_ewald
                ew = EwaldParams.from_setup(es, u.qqr2e, dtype=dtype,
                                            device=device)
        eamp = pair = None
        if name == "eam":
            eamp, _ = build_eam_params(script.eam_file, dtype=dtype,
                                       device=device)
        elif eam:
            eamp, _ = build_eam_alloy_params(
                script.eam_file, script.eam_type_elems, dtype=dtype,
                device=device, fs=name == "eam/fs")
        else:
            pair = make_pair_params(
                eps, sig, cut,
                cut_coul=script.pair.cut_coul if coul else 0.0,
                qqrd2e=u.qqr2e, g_ewald=g_ewald, coul=coul,
                special_lj=script.special_lj,
                special_coul=script.special_coul, excl_types=excl_types,
                shift=script._pair_shift,
                cut_lj_inner=script.pair.cut_lj_inner, charmm=charmm,
                coul_kind="long" if coul_long else "charmm",
                cut_coul_inner=script.pair.cut_coul_inner, dtype=dtype,
                device=device)
        if script.neigh_exclude_mol and pair is not None:
            pair = dataclasses.replace(pair, excl_mol=True)
        pol = polarization_settings(script.pair) if polar else None
        # a barostat moves the box: the Ewald tables follow it and the
        # integrator reads the virial every step (the JAX package's
        # sim.py:1612-1617, 1667, 2005)
        has_baro = any(f.style in BAROSTATS for f in script.fixes.values())
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
        elif dense and above_cap:
            ncfg = _cell_config(script, cut, n, coul)
            if ncfg is None and not polar:
                raise NotImplementedError(
                    f"{n} atoms in a box under 3 cells of the largest "
                    f"cutoff plus the skin ({script.skin:g}) a side: above "
                    "the dense cap the JAX package takes a neighbour list "
                    "here (ROADMAP queue 1 item 5, neighbour lists)")

        sp_lists = sp_code = sp_idx = sp_lvl = None
        has_bonds = script._bonds is not None and len(script._bonds)
        if dense and has_bonds and not above_cap:
            # the JAX package builds the codes up to the cap only
            # (lidp_tpu/sim.py:1471; ROADMAP queue 3)
            sp_code = torch.as_tensor(
                topo_mod.special_codes_dense(n, script._bonds),
                device=device)
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
        # ---- fix shake pre-pass and the bonded terms ----
        from lidp_tpu_torch.styles.fix_modifiers import shake_pre_pass

        shake_found, shake_cfg, bond_keep, angle_keep = shake_pre_pass(
            script, mass_atom)
        bonded = _bonded_params(script, dtype, device, u, eps, sig, cut,
                                bond_keep, angle_keep)
        ff = ForceField(pair=pair, eam=eamp, ewald=ew, polar=pol,
                        qqrd2e=u.qqr2e,
                        polar_xshift=polar_xshift, sp_code=sp_code,
                        sp_idx=sp_idx, sp_lvl=sp_lvl, pppm=pppm,
                        kspace_dynamic=has_baro and ew is not None,
                        **bonded)

        # ---- integrator from fixes ----
        from lidp_tpu_torch.styles import FixBuildCtx, build_fixes

        fctx = build_fixes(FixBuildCtx(
            script=script, groups=groups, u=u, dtype=dtype, device=device,
            mass_atom=mass_atom, padA=_padA, n=n, dim=dim_, sys=sys,
            shake_found=shake_found, shake_cfg=shake_cfg))
        if fctx.integ is None:
            raise NotImplementedError(
                "a run without a time-integration fix is not ported "
                "(fix nve, nvt, npt, nph or a rigid style)")
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
                        post_integrate=_compose_pi(fctx.pi_hooks))
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
        dof = dim_ * n - dim_ - fctx.dof_removed
        norm = script._thermo_norm
        tp = ThermoParams.create(
            mass_atom, dof=dof, units=u,
            norm=(u.name == "lj") if norm is None else norm, natoms=n,
            dim=dim_, dtype=dtype, device=device)
        # compute ID group temp: the group's dof is dim*ng - dim, less a
        # rigid fix's removed dof when all its bodies lie in the group (the
        # JAX package's rule, its sim.py:2126-2151)
        group_tp = {}
        for cid, (gname, _) in script.computes.items():
            gmask = groups[gname]
            ng = int(gmask.sum())
            gdof = dim_ * ng - dim_
            for _, rsetup in fctx.rigid_groups:
                if np.all(gmask[rsetup.body_of_atom >= 0]):
                    gdof -= rsetup.dof_removed
            group_tp[cid] = ThermoParams.create(
                np.where(gmask, mass_atom, 0.0), dof=gdof, units=u,
                norm=False, natoms=ng, dim=dim_, dtype=dtype, device=device)
        return Simulation(script, sys, runner, tp, n, group_tp)

    # ------------------------------ output -------------------------------

    def _thermo_row(self) -> dict:
        """The thermo row of the current state: thermo_row with the
        integrator's constraint virial in the pressure and each temp
        compute's c_ID, every scalar read to the host in one transfer;
        plus the atom and topology counts."""
        row = thermo_row(self.sys, self.res, self.thermo_params,
                         extra_virial=getattr(self.istate, "virial", None),
                         extra={"c_" + cid: temperature(self.sys, tp)
                                for cid, tp in self.group_thermo.items()})
        row["atoms"] = self.natoms
        bonds = self.script._bonds
        row["bonds"] = 0 if bonds is None else len(bonds)
        return row

    _HEADER = {"step": "Step", "etotal": "TotEng", "ke": "KinEng",
               "pe": "PotEng", "evdwl": "E_vdwl", "ecoul": "E_coul",
               "elong": "E_long", "epol": "E_pol", "temp": "Temp",
               "press": "Press", "epair": "E_pair", "emol": "E_mol",
               "ebond": "E_bond", "eangle": "E_angle", "edihed": "E_dihed",
               "eimp": "E_impro", "vol": "Volume", "density": "Density",
               "atoms": "Atoms", "lx": "Lx", "ly": "Ly", "lz": "Lz",
               "xlo": "Xlo", "xhi": "Xhi", "ylo": "Ylo", "yhi": "Yhi",
               "zlo": "Zlo", "zhi": "Zhi", "xy": "Xy", "xz": "Xz",
               "yz": "Yz", "bonds": "Bonds"}

    def _emit(self):
        row = self._thermo_row()
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
        from lidp_tpu_torch.io.dump import write_dump_frame

        step = int(self.sys.step)
        for d in self.script.dumps.values():
            if d.every and step % d.every == 0:
                write_dump_frame(d, self.sys, self.script,
                                 self.script.groups[d.group],
                                 f=None if self.res is None else self.res.f)

    # -------------------------------- run --------------------------------

    def run(self, nsteps: int):
        """Advance nsteps: setup on the first run, the header and the row of
        the start, then the steps in chunks of the gcd of the thermo and
        dump intervals, a row and the dump frames at each boundary, and the
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
        if self.res is None:
            self.sys, self.res, self.nlist, self.istate = \
                self.runner.setup(self.sys)
        self.script.log(" ".join(
            self._HEADER.get(c, c) for c in self.script.thermo_columns))
        self._emit()
        self._dump()
        remaining = nsteps
        every = self.script.thermo_every or nsteps
        chunk_opts = [every] + [d.every for d in self.script.dumps.values()
                                if d.every]
        chunk = int(np.gcd.reduce(chunk_opts))
        while remaining > 0:
            todo = min(chunk, remaining)
            self.sys, self.res, self.nlist, self.istate = self.runner.run(
                self.sys, self.res, self.nlist, self.istate, todo)
            remaining -= todo
            step = int(self.sys.step)
            if self.nlist is not None and bool(self.nlist.overflow):
                raise RuntimeError(_OVERFLOW)
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
