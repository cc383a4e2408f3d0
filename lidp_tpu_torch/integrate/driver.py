"""Run driver: the MD timestep as a Python loop over device work
(lidp_tpu/integrate/driver.py).

Analog of Verlet::setup + Verlet::run (verlet.cpp:88,223): per step
  1. integrator initial_integrate (half-kick + drift)
  2. neighbor decide/rebuild (Neighbor::decide: `every`, `delay`, `check`)
  3. force evaluation
  4. integrator final_integrate
Thermo sampling happens on the host between `run` calls.

Ported for the dense route (`neighbor_cfg` None: every evaluation is
compute_forces(nlist=None), with no wrap and no rebuild, as in the JAX
package) and for a cell grid (`neighbor_cfg` a CellConfig), with the nve,
rigid/nve, rigid/nvt, rigid/npt, rigid/nph, nvt, npt and nph integrators
(the barostats replace the System's Box inside the step; the Runner then
runs with every_step_ev, as they read the virial each step).  With check=False the loop
itself reads nothing back from the device: the step counter and the
rebuild schedule are Python ints.  With check=True the displacement test
is computed on the device and read once per rebuild decision (only on the
steps the schedule allows one).  What it calls may read: the Nose-Hoover
integrators read the kinetic energy once per chain update (rigid/nvt once
a step, in initial_integrate, with the rigid barostat's strain rate under
rigid/npt, and that alone under rigid/nph; nvt twice, once in each half;
npt and nph not at all), and the dense route's CG reads its residual once
an iteration.  A shrink-wrapped box (`shrink`, a box.ShrinkSpec) is
reset to the atoms' extent at setup and at every rebuild the schedule
takes, before the grid is built (Domain::reset_box; the dense route
rebuilds nothing, so there only setup resets it), as in the JAX package.
Neighbour lists, fix deform, fix tmd and rRESPA are not ported; asking
for them raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from lidp_tpu_torch import box as box_mod
from lidp_tpu_torch.forcefield import ForceField, compute_forces
from lidp_tpu_torch.ops.cells import CellConfig, build_cells
from lidp_tpu_torch.state import System


@dataclasses.dataclass(frozen=True)
class Integrator:
    """Bundle of functions + their params/state.

    initial/final receive the full ForceResult (res) — barostats need the
    virial, not just res.f."""

    initial: Callable  # (sys, res, params, istate) -> (sys, istate)
    final: Callable    # (sys, res, params, istate) -> (sys, istate)
    params: Any
    # setup-time hook (Modify::setup): may adjust sys
    init_state: Callable = lambda sys, f, params: (sys, ())
    # variant receiving the full ForceResult; wins over init_state when set
    init_state_res: Optional[Callable] = None


def nve_integrator(nve_params, compensated: bool = False) -> Integrator:
    from lidp_tpu_torch.integrate import nve

    if compensated:
        # Kahan-compensated x/v updates: restores ~float64-grade energy
        # conservation on the float32 path (see nve.py)
        return Integrator(
            initial=lambda s, r, p, st: nve.kahan_initial_integrate(
                s, r.f, p, st),
            final=lambda s, r, p, st: nve.kahan_final_integrate(
                s, r.f, p, st),
            params=nve_params,
            init_state=nve.kahan_init_state,
        )
    return Integrator(
        initial=lambda s, r, p, st: (nve.initial_integrate(s, r.f, p), st),
        final=lambda s, r, p, st: (nve.final_integrate(s, r.f, p), st),
        params=nve_params,
    )


def rigid_nve_integrator(rigid_params, mass_atom) -> Integrator:
    """fix rigid/nve, rigid/nvt, rigid/npt and rigid/nph: the no-squish
    integrator of integrate/rigid.py; its init_state is init_rigid_state
    (set_v at setup), with the barostat's init_pstat after it (it needs
    the setup's force virial).  With a thermostat or the barostat, each
    half takes the ramped targets of the step it produces,
    ramp_target(..., step + 1): Verlet::run increments ntimestep before
    initial_integrate (verlet.cpp:243), and the JAX package's _run_chunk
    substitutes them so for both halves (final_integrate reads them only
    under the barostat)."""
    from lidp_tpu_torch.integrate import rigid
    from lidp_tpu_torch.integrate.nvt import ramp_target

    def _ramped(p, step):
        if not (p.tstat or p.pstat):
            return p
        r = (p.ramp_begin, p.ramp_end, step)
        return dataclasses.replace(
            p, t_target=ramp_target(p.t_start, p.t_stop, *r),
            p_target=tuple(ramp_target(a, b, *r)
                           for a, b in zip(p.p_start, p.p_stop)))

    if rigid_params is not None and rigid_params.pstat:
        def _init(s, res, p):
            s, st = rigid.init_rigid_state(s, res.f, p, mass_atom)
            return s, rigid.init_pstat(s, res.virial, p, st)

        return Integrator(
            initial=lambda s, r, p, st: rigid.initial_integrate(
                s, r.f, _ramped(p, s.step + 1), st),
            final=lambda s, r, p, st: rigid.final_integrate(
                s, r.f, _ramped(p, s.step), st, res_virial=r.virial),
            params=rigid_params,
            init_state_res=_init,
        )
    return Integrator(
        initial=lambda s, r, p, st: rigid.initial_integrate(
            s, r.f, _ramped(p, s.step + 1), st),
        final=lambda s, r, p, st: rigid.final_integrate(s, r.f, p, st),
        params=rigid_params,
        init_state=lambda s, f, p: rigid.init_rigid_state(s, f, p,
                                                          mass_atom),
    )


def npt_integrator(npt_params) -> Integrator:
    """fix npt and fix nph: integrate/npt.py, each half on the ramped
    targets of the step it produces (ramp_target(..., step + 1), as the
    JAX package's _run_chunk substitutes them for both halves).  The
    System's Box is replaced by the remap inside initial_integrate; the
    force evaluation and the cell grid's rebuild read the new one."""
    from lidp_tpu_torch.integrate import npt
    from lidp_tpu_torch.integrate.nvt import ramp_target

    def _ramped(p, step):
        r = (p.ramp_begin, p.ramp_end, step)
        return dataclasses.replace(
            p, t_target=ramp_target(p.t_target, p.t_stop, *r),
            p_target=tuple(ramp_target(a, b, *r)
                           for a, b in zip(p.p_target, p.p_stop)))

    return Integrator(
        initial=lambda s, r, p, st: npt.initial_integrate(
            s, r, _ramped(p, s.step + 1), st),
        final=lambda s, r, p, st: npt.final_integrate(
            s, r, _ramped(p, s.step), st),
        params=npt_params,
        init_state=npt.init_state,
    )


def nvt_integrator(nvt_params) -> Integrator:
    """fix nvt: the Nose-Hoover chain of integrate/nvt.py (its target ramp
    taken inside each half from sys.step)."""
    from lidp_tpu_torch.integrate import nvt

    return Integrator(
        initial=lambda s, r, p, st: nvt.initial_integrate(s, r.f, p, st),
        final=lambda s, r, p, st: nvt.final_integrate(s, r.f, p, st),
        params=nvt_params,
        init_state=nvt.init_state,
    )


@dataclasses.dataclass(frozen=True)
class NeighborCarry:
    """Neighbor structure + rebuild-decision state (Neighbor::decide,
    neighbor.cpp:1923): positions at the last build and its step number
    (a Python int, like System.step)."""

    nlist: Any
    x_ref: torch.Tensor
    last_build: int

    @property
    def overflow(self):
        return self.nlist.overflow


def _make_carry(sys, nlist):
    return NeighborCarry(nlist=nlist, x_ref=sys.x, last_build=sys.step)


def _build_struct(sys, neighbor_cfg):
    if isinstance(neighbor_cfg, CellConfig):
        return build_cells(sys.x, sys.mask, sys.box, neighbor_cfg)
    raise NotImplementedError(
        "neighbour lists are not ported (ops/neighbor.py; ROADMAP queue 1 "
        "item 5, neighbour lists); pass a CellConfig or None")


def _apply_post_force(sys, res, post_force):
    """post_force may return f or (f, extra_virial6) — constraint fixes
    tally a virial that pressure must include."""
    out = post_force(sys, res.f)
    if isinstance(out, tuple):
        f2, vir = out
        return dataclasses.replace(res, f=f2, virial=res.virial + vir)
    return dataclasses.replace(res, f=out)


def _nlist_of(carry):
    return None if carry is None else carry.nlist


def _shrink(sys, shrink):
    if shrink is None:
        return sys
    return sys.replace(box=box_mod.reset_box(sys.x, sys.mask, sys.box,
                                             shrink))


def _setup_forces(sys, ff, *, neighbor_cfg, post_force=None, shrink=None):
    sys = _shrink(sys, shrink)
    nlist = None
    if neighbor_cfg is not None:
        x, image = box_mod.wrap(sys.x, sys.box, sys.image)
        sys = sys.replace(x=x, image=image)
        nlist = _make_carry(sys, _build_struct(sys, neighbor_cfg))
    res = compute_forces(sys, ff, _nlist_of(nlist))
    if post_force is not None:
        res = _apply_post_force(sys, res, post_force)
    sys = sys.replace(mu=res.mu)
    return sys, res, nlist


def _rebuild(sys, nc, neighbor_cfg, shrink=None):
    sys = _shrink(sys, shrink)
    x, image = box_mod.wrap(sys.x, sys.box, sys.image)
    sys = sys.replace(x=x, image=image)
    new = _build_struct(sys, neighbor_cfg)
    # sticky overflow: a capacity overrun at ANY rebuild inside a run must
    # survive to its end, where the host can see it
    new = dataclasses.replace(new, overflow=new.overflow | nc.nlist.overflow)
    return sys, _make_carry(sys, new)


def _run_chunk(sys, res, nlist, istate, ff, iparams, *, nsteps, initial,
               final, neighbor_cfg, rebuild_every, post_force=None,
               end_of_step=None, every_step_ev=True, check=False, skin=0.0,
               delay=0, post_integrate=None, shrink=None):
    for _ in range(nsteps):
        sys, istate = initial(sys, res, iparams, istate)
        if post_integrate is not None:
            sys = post_integrate(sys)
        sys = sys.replace(step=sys.step + 1)

        # Neighbor::decide (neighbor.cpp:1933): ago >= delay and
        # ago % every == 0; with dist_check, only when some atom moved
        # more than skin/2 since the last build
        if nlist is not None:
            ago = sys.step - nlist.last_build
            need = ago >= max(delay, 1) and ago % rebuild_every == 0
            if need and check:
                disp2 = torch.sum((sys.x - nlist.x_ref) ** 2, dim=1)
                disp2 = torch.where(sys.mask, disp2, 0.0)
                need = bool(torch.max(disp2) > (0.5 * skin) ** 2)
            if need:
                sys, nlist = _rebuild(sys, nlist, neighbor_cfg, shrink)

        res = compute_forces(sys, ff, _nlist_of(nlist),
                             need_ev=every_step_ev)
        if post_force is not None:
            res = _apply_post_force(sys, res, post_force)
        sys = sys.replace(mu=res.mu)
        sys, istate = final(sys, res, iparams, istate)
        if end_of_step is not None:
            sys = end_of_step(sys, res)
    if not every_step_ev:
        # one energy-bearing re-tally at the end of the run (forces at the
        # final positions are unchanged; thermo samples between runs)
        res = compute_forces(sys, ff, _nlist_of(nlist), need_ev=True)
        if post_force is not None:
            res = _apply_post_force(sys, res, post_force)
    return sys, res, nlist, istate


@dataclasses.dataclass
class Runner:
    """One simulation setup: the force field, the integrator and the
    neighbor policy.  `setup` evaluates the initial forces, `run` advances
    a number of steps."""

    ff: ForceField
    integ: Integrator
    neighbor_cfg: Optional[CellConfig] = None
    rebuild_every: int = 1
    post_force: Optional[Callable] = None   # (sys, f) -> f
    end_of_step: Optional[Callable] = None  # (sys, res) -> sys
    # Modify::post_integrate (after the position update, before forces)
    post_integrate: Optional[Callable] = None
    # setup-time variant of post_force
    post_force_setup: Optional[Callable] = None
    # True when the integrator consumes per-step energies/virials; False
    # runs the quiet force path inside `run` and re-tallies energies once
    # at its end (LAMMPS' ev_setup eflag/vflag gating, pair.cpp:752)
    every_step_ev: bool = False
    # neigh_modify check yes (dist_check): rebuild only when some atom moved
    # more than skin/2 since the last build; rebuild_every/delay gate how
    # often the check runs
    check: bool = False
    skin: float = 0.0
    delay: int = 0
    # shrink-wrapped faces (a box.ShrinkSpec): reset at setup and at every
    # rebuild (Domain::reset_box, domain.cpp:358)
    shrink: Optional[Any] = None
    # not ported: fix deform, fix tmd
    deform: Optional[Any] = None
    tmd_hook: Optional[Callable] = None

    def __post_init__(self):
        for name in ("deform", "tmd_hook"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"Runner({name}=...) is not ported (ROADMAP queue 1 "
                    f"item 6.1, the modifier fixes)")

    def setup(self, sys: System):
        """Initial force evaluation (Verlet::setup).  Returns (sys, res,
        nlist, istate)."""
        sys, res, nlist = _setup_forces(
            sys, self.ff, neighbor_cfg=self.neighbor_cfg,
            post_force=self.post_force_setup or self.post_force,
            shrink=self.shrink)
        if self.integ.init_state_res is not None:
            sys, istate = self.integ.init_state_res(sys, res,
                                                    self.integ.params)
        else:
            sys, istate = self.integ.init_state(sys, res.f,
                                                self.integ.params)
        return sys, res, nlist, istate

    def run(self, sys, res, nlist, istate, nsteps: int):
        """Advance nsteps; returns the updated carry and the last result."""
        return _run_chunk(
            sys, res, nlist, istate, self.ff, self.integ.params,
            nsteps=nsteps, initial=self.integ.initial,
            final=self.integ.final, neighbor_cfg=self.neighbor_cfg,
            rebuild_every=self.rebuild_every, post_force=self.post_force,
            end_of_step=self.end_of_step, every_step_ev=self.every_step_ev,
            check=self.check, skin=self.skin, delay=self.delay,
            post_integrate=self.post_integrate, shrink=self.shrink)


class RespaRunner:
    """rRESPA is not ported (ROADMAP queue 1 item 6, breadth)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "RespaRunner is not ported (ROADMAP queue 1 item 6, breadth)")
