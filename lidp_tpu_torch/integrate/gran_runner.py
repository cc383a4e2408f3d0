"""Granular runner: velocity Verlet for sphere atoms, translation and
rotation, with the contact shear history carried from step to step
(lidp_tpu/integrate/gran_runner.py).

The generic Runner's force path keeps no state between evaluations;
granular contacts carry per-pair shear history and give torques, so this
runner owns the step: the first half-kick of v and omega
(fix_nve_sphere.cpp:110-140, I = 0.4 m r^2) and the drift, Neighbor::decide
with the shrink-wrapped box reset, the wrap, a new cell grid and the
shear migrated onto it (ops/granular.py migrate_shear), the contact
forces, then fix gravity, the walls of fix wall/gran[/region] and fix
freeze, and the final half-kick.  fix nvt/sphere (FixNHSphere) scales v
and omega by the Nose-Hoover chain of integrate/nvt.py before the first
and after the last half-kick.

The step is a Python loop over device work.  The rebuild decision is
taken on the host: with `check` the largest displacement since the last
build is read once a step where the schedule allows a rebuild (the JAX
package decides inside lax.cond); the chain reads its kinetic energy once
in each half.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from lidp_tpu_torch import box as box_mod
from lidp_tpu_torch.forcefield import ForceResult
from lidp_tpu_torch.integrate.rigid import chain_dtype
from lidp_tpu_torch.ops import granular as gran
from lidp_tpu_torch.ops.cells import CellConfig, build_cells


@dataclasses.dataclass(frozen=True)
class GranState:
    omega: torch.Tensor       # (N,3)
    shear: torch.Tensor       # (noff, bx, by, bz, cap, cap, 3)
    torque: torch.Tensor      # (N,3) of the last force evaluation
    x_ref: torch.Tensor       # (N,3) positions at the last rebuild
    last_build: int
    virial: torch.Tensor      # (6,)
    eta_dot: np.ndarray       # (tchain,) fix nvt/sphere's chain, host
    shear_w: torch.Tensor     # (T, N, 3) the walls' contact histories
    pairs: gran.CandidatePairs  # the grid's live candidate pairs


@dataclasses.dataclass(frozen=True)
class WallGranFix:
    """One fix wall/gran or wall/gran/region (fix_wall_gran.cpp grammar:
    pairstyle kn kt gamman gammat xmu dampflag wallstyle args [wiggle dim
    amp period | shear dim vshear]).  contact_sources() gives its
    (d (N,3), rwall (N,) or None, active (N,)) sources, one a wall face."""

    kind: str                 # hooke | hooke/history | hertz/history
    kn: float
    kt: float
    gamman: float
    gammat: float
    xmu: float
    gmask: torch.Tensor       # (N,) bool
    wallstyle: str            # xplane | yplane | zplane | zcylinder | region
    lo: float = -1.0e30       # NULL: +-BIG, as the reference
    hi: float = 1.0e30
    cylradius: float = 0.0
    wiggle: bool = False
    wshear: bool = False
    axis: int = 0
    amplitude: float = 0.0
    omega_w: float = 0.0      # 2 pi / period
    vshear: float = 0.0
    time_origin: int = 0
    # x -> [(rdist, d wall->atom, ok, rwall or None)], one a region face
    region_contacts: Optional[Callable] = None
    n_contacts: int = 1

    def contact_sources(self, x, radius, step, dt):
        """(vwall (3,) or (N,3), [(d, rwall, active), ...])."""
        wlo, whi = self.lo, self.hi
        vwall = torch.zeros(3, dtype=x.dtype, device=x.device)
        if self.wiggle:
            arg = self.omega_w * (step - self.time_origin) * dt
            daxis = "xyz".find(self.wallstyle[0])
            if self.wallstyle != "zcylinder" and self.axis == daxis:
                off = self.amplitude - self.amplitude * math.cos(arg)
                wlo = self.lo + off
                whi = self.hi + off
            vwall[self.axis] = self.amplitude * self.omega_w * math.sin(arg)
        elif self.wshear:
            vwall[self.axis] = self.vshear
        ones = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        if self.wallstyle in ("xplane", "yplane", "zplane"):
            dim = "xyz".index(self.wallstyle[0])
            del1 = x[:, dim] - wlo
            del2 = whi - x[:, dim]
            d = torch.zeros_like(x)
            d[:, dim] = torch.where(del1 < del2, del1, -del2)
            return vwall, [(d, None, ones)]
        if self.wallstyle == "zcylinder":
            delxy = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2)
            delxy_s = torch.where(delxy > 0.0, delxy, 1.0)
            delr = self.cylradius - delxy
            inside = delr <= radius    # a candidate contact (:392-404)
            scale = torch.where(inside, -delr / delxy_s, 0.0)
            d = torch.stack([scale * x[:, 0], scale * x[:, 1],
                             torch.where(inside, 0.0, self.cylradius)],
                            dim=-1)
            rwall = torch.where(delxy < self.cylradius,
                                -2.0 * self.cylradius, 2.0 * self.cylradius)
            if self.wshear and self.axis != 2:
                vwall = torch.stack([self.vshear * x[:, 1] / delxy_s,
                                     -self.vshear * x[:, 0] / delxy_s,
                                     torch.zeros_like(delxy)], dim=-1)
            return vwall, [(d, rwall, ones)]
        # region: the fix sees the contacts within the atom's radius
        return vwall, [(dl, rw, ok & (rdist > 0.0))
                       for rdist, dl, ok, rw in self.region_contacts(x)]


@dataclasses.dataclass
class GranRunner:
    gp: gran.GranParams
    neighbor_cfg: CellConfig
    dt: float
    ftm2v: float
    gmask: torch.Tensor           # (N,) the integrated (active) atoms
    grav: torch.Tensor            # (3,) fix gravity's acceleration
    skin: float = 0.1
    shrink: Optional[Any] = None  # box.ShrinkSpec
    rebuild_every: int = 1
    delay: int = 0
    check: bool = True
    # fix nvt/sphere: integrate/nvt.NVTParams with compute temp/sphere's
    # dof; its scale applies to v and omega (FixNHSphere::nh_v_temp)
    nvt: Optional[Any] = None
    walls: tuple = ()             # WallGranFix
    omega0: Optional[torch.Tensor] = None
    rebuilds: int = 0             # the grid rebuilds the runs took

    # ---- mechanics ----
    def _accel(self, f, gp):
        return (0.5 * self.dt * self.ftm2v
                / torch.clamp(gp.rmass, min=1e-300))[:, None] * f

    def _omega_kick(self, omega, torque, gp):
        # d omega/dt = torque / (0.4 m r^2) (fix_nve_sphere.cpp:135)
        r = gp.radius
        inert = gran.INERTIA * gp.rmass * r * r
        pos = inert > 0
        dti = torch.where(pos, 0.5 * self.dt * self.ftm2v
                          / torch.where(pos, inert, 1.0), 0.0)
        return omega + dti[:, None] * torque

    def _force(self, sys, nlist, st, gp, shear_update, need_ev):
        f, tq, shear, vir = gran.gran_cell_forces(
            sys.x, sys.v, st.omega, sys.mask, nlist, sys.box, gp,
            st.shear, st.pairs, shear_update=shear_update, need_ev=need_ev)
        # fix gravity (post_force): f += m g on every atom
        f = f + gp.rmass[:, None] * self.grav
        shear_w = st.shear_w
        if self.walls:
            f, tq, shear_w = self.wall_forces(sys, st, f, tq, shear_update)
        # fix freeze: no force or torque on its group
        fr = gp.frozen[:, None]
        f = torch.where(fr, 0.0, f)
        tq = torch.where(fr, 0.0, tq)
        return f, tq, shear, shear_w, vir

    def wall_forces(self, sys, st, f, tq, shear_update=True):
        """fix wall/gran[/region] (post_force): the atoms' wall contacts,
        each source with its own shear history, added source by source
        onto f and tq (N,3).  Returns (f, tq, the walls' histories (T, N,
        3))."""
        gp = self.gp
        sw_new = []
        for wf in self.walls:
            vwall, sources = wf.contact_sources(sys.x, gp.radius, sys.step,
                                                self.dt)
            for d, rwall, ok in sources:
                act = ok & sys.mask & wf.gmask
                fw, tw, s_out = gran.wall_contact_force(
                    d, sys.v, st.omega, gp.radius, gp.rmass,
                    st.shear_w[len(sw_new)], vwall, act, wf.kn, wf.kt,
                    wf.gamman, wf.gammat, wf.xmu, self.dt, wf.kind,
                    rwall=rwall, shear_update=shear_update)
                f = f + fw
                tq = tq + tw
                sw_new.append(s_out)
        return f, tq, torch.stack(sw_new)

    def _mk_res(self, sys, f, vir):
        zero = torch.zeros((), dtype=sys.x.dtype, device=sys.x.device)
        return ForceResult(
            f=f, evdwl=zero, ecoul=zero, elong=zero, epol=zero, ebond=zero,
            virial=vir, mu=sys.mu,
            scf_iters=torch.zeros((), dtype=torch.int32,
                                  device=sys.x.device),
            scf_diverged=torch.zeros((), dtype=torch.bool,
                                     device=sys.x.device))

    # ---- public ----
    def setup(self, sys):
        """Domain::reset_box, the grid, then the setup force evaluation
        (no shear update: update->setupflag).  The setup virial is both
        the result's and the state's, as in the JAX package."""
        if self.shrink is not None:
            sys = sys.replace(box=box_mod.reset_box(
                sys.x, sys.mask, sys.box, self.shrink))
        nlist = build_cells(sys.x, sys.mask, sys.box, self.neighbor_cfg)
        x = sys.x
        nchain = self.nvt.t_chain if self.nvt is not None else 1
        nwall = sum(wf.n_contacts for wf in self.walls)
        omega0 = (torch.zeros_like(sys.v) if self.omega0 is None
                  else self.omega0)
        st = GranState(
            omega=omega0,
            shear=torch.zeros(gran.shear_shape(nlist), dtype=x.dtype,
                              device=x.device),
            torque=torch.zeros_like(sys.v), x_ref=x,
            last_build=int(sys.step),
            virial=torch.zeros(6, dtype=x.dtype, device=x.device),
            eta_dot=np.zeros(nchain, chain_dtype(x.dtype)),
            shear_w=torch.zeros((nwall,) + tuple(x.shape), dtype=x.dtype,
                                device=x.device),
            pairs=self.pairs_of(nlist))
        f, tq, shear, shear_w, vir = self._force(
            sys, nlist, st, self.gp, shear_update=False, need_ev=True)
        st = dataclasses.replace(st, torque=tq, shear=shear, shear_w=shear_w,
                                 virial=vir)
        return sys, self._mk_res(sys, f, vir), nlist, st

    def pairs_of(self, nlist):
        """The candidate pairs of a new grid (one host read)."""
        return gran.candidate_pairs(nlist, self.gp.radius.shape[0],
                                    self.gp.excl)

    def _sphere_ke2(self, sys, omega, gm, gp):
        """2 KE, translational and rotational, of the thermostat's group
        in energy units, read to the host (compute_temp_sphere.cpp)."""
        r = gp.radius
        ke2 = torch.sum(torch.where(gm, gp.rmass[:, None] * sys.v * sys.v,
                                    0.0))
        ke2 = ke2 + torch.sum(torch.where(
            gm, (gran.INERTIA * gp.rmass * r * r)[:, None] * omega * omega,
            0.0))
        return float(ke2 * self.nvt.mvv2e)

    def _chain(self, st, sys, omega, gm, gp):
        from lidp_tpu_torch.integrate.nvt import _nhc

        eta_dot, scale = _nhc(st.eta_dot, self._sphere_ke2(sys, omega, gm,
                                                           gp),
                              self.nvt, sys.step)
        scale = float(scale)
        sys = sys.replace(v=torch.where(gm, sys.v * scale, sys.v))
        omega = torch.where(gm, omega * scale, omega)
        return dataclasses.replace(st, eta_dot=eta_dot), sys, omega

    def _rebuild(self, sys, nlist, st):
        self.rebuilds += 1
        if self.shrink is not None:
            sys = sys.replace(box=box_mod.reset_box(
                sys.x, sys.mask, sys.box, self.shrink))
        x, image = box_mod.wrap(sys.x, sys.box, sys.image)
        sys = sys.replace(x=x, image=image)
        new = build_cells(sys.x, sys.mask, sys.box, self.neighbor_cfg)
        shear = st.shear if self.gp.kind == "hooke" else \
            gran.migrate_shear(st.shear, nlist, new)
        # sticky overflow: seen by the host at the end of the run
        new = dataclasses.replace(new, overflow=new.overflow | nlist.overflow)
        st = dataclasses.replace(st, shear=shear, x_ref=sys.x,
                                 last_build=int(sys.step),
                                 pairs=self.pairs_of(new))
        return sys, new, st

    def run(self, sys, res, nlist, st, nsteps: int):
        gp = self.gp
        gm = (self.gmask & sys.mask)[:, None]
        f = res.f
        for _ in range(nsteps):
            omega = st.omega
            if self.nvt is not None:
                # FixNH::initial_integrate: the chain, then v and omega
                # scaled (FixNHSphere::nh_v_temp), then the half-kicks
                st, sys, omega = self._chain(st, sys, omega, gm, gp)
            v = torch.where(gm, sys.v + self._accel(f, gp), sys.v)
            omega = torch.where(gm, self._omega_kick(omega, st.torque, gp),
                                omega)
            x = torch.where(gm, sys.x + self.dt * v, sys.x)
            sys = sys.replace(x=x, v=v, step=sys.step + 1)
            st = dataclasses.replace(st, omega=omega)

            # Neighbor::decide (neighbor.cpp:1933)
            ago = sys.step - st.last_build
            need = ago >= max(self.delay, 1) and ago % self.rebuild_every == 0
            if need and self.check:
                disp2 = torch.sum((sys.x - st.x_ref) ** 2, dim=1)
                disp2 = torch.where(sys.mask, disp2, 0.0)
                need = bool(torch.max(disp2) > (0.5 * self.skin) ** 2)
            if need:
                sys, nlist, st = self._rebuild(sys, nlist, st)

            f, tq, shear, shear_w, vir = self._force(
                sys, nlist, st, gp, shear_update=True, need_ev=False)
            st = dataclasses.replace(st, shear=shear, shear_w=shear_w,
                                     virial=vir)
            v = torch.where(gm, sys.v + self._accel(f, gp), sys.v)
            omega = torch.where(gm, self._omega_kick(st.omega, tq, gp),
                                st.omega)
            sys = sys.replace(v=v)
            if self.nvt is not None:
                # FixNH::final_integrate: the half-kicks, then the chain
                st, sys, omega = self._chain(st, sys, omega, gm, gp)
            st = dataclasses.replace(st, omega=omega, torque=tq)
        return sys, self._mk_res(sys, f, st.virial), nlist, st
