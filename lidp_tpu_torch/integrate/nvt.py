"""fix nvt — point-particle Nose-Hoover thermostat (lidp_tpu/integrate/
nvt.py; FixNH, fix_nh.cpp).

Velocity-Verlet with NH chain scaling applied before the first and after
the second half-kick (FixNH::initial_integrate:830, final_integrate:886):
  initial: chain update + v *= exp(-dtq*eta_dot[0]); v += dtf f/m; x += dt v
  final:   v += dtf f/m; chain update + scale.
Chain masses q[0] = dof*kT/freq^2, q[k>0] = kT/freq^2 (nhc_temp_integrate),
the target ramped linearly over each run (FixNH::compute_temp_target:
ramp_begin/ramp_end, which Simulation.run sets to the run's first and last
step).

As in integrate/rigid.py, the chain runs on the host: each half reduces
the kinetic energy on the device and reads it once (two host reads a
step), the chain advances on host scalars of the run's dtype, and the
velocity scale multiplies the device tensor as a Python scalar.

fix nvt/sphere off the granular route (fix_nh_sphere.cpp with central
forces, which exert no torque): the chain's kinetic energy adds the
rotational energy of the setup's omega, rot_ke20, times the cumulative
square of the thermostat's scale (NVTState.rot_scale2, a host scalar), as
the JAX package tracks it.  fix nvt/sllod (the streaming-velocity bias of
a deforming triclinic box) is not ported (ROADMAP queue 1 item 6.4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.integrate.rigid import _exp, _host_scalar, chain_dtype
from lidp_tpu_torch.state import System


@dataclasses.dataclass(frozen=True)
class NVTParams:
    dtv: torch.Tensor
    dtf: torch.Tensor
    mass_atom: torch.Tensor
    # host scalars of the run's dtype (rigid._host_scalar)
    dtq: float
    t_target: float          # t_start
    t_freq: float
    t_stop: float            # ramp end value (FixNH compute_temp_target)
    ramp_begin: int = 0      # run begin/end steps for the ramp
    ramp_end: int = 0
    dof: float = 3.0
    boltz: float = 1.0
    mvv2e: float = 1.0
    t_chain: int = 3
    # fix nvt/sphere: the setup's rotational KE sum 0.4 m r^2 w^2 (a host
    # scalar of the run's dtype), None for point particles
    rot_ke20: Optional[float] = None

    @staticmethod
    def create(dt, ftm2v, mass_atom, t_target, t_period, *, dof, boltz,
               mvv2e, t_chain=3, t_stop=None, dtype=torch.float64,
               device="cuda", rot_ke20=None):
        device = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        S = _host_scalar(dtype)
        return NVTParams(
            dtv=t(dt), dtf=t(0.5 * dt * ftm2v), mass_atom=t(mass_atom),
            dtq=S(0.5 * dt), t_target=S(t_target), t_freq=S(1.0 / t_period),
            t_stop=S(t_target if t_stop is None else t_stop),
            dof=float(dof), boltz=boltz, mvv2e=mvv2e, t_chain=t_chain,
            rot_ke20=None if rot_ke20 is None else S(rot_ke20))


def ramp_target(start, stop, begin: int, end: int, step: int):
    """FixNH::compute_temp_target (fix_nh.cpp): linear ramp over the run,
    delta = (step - beginstep)/(endstep - beginstep), clamped; host
    scalars of start's type."""
    S = type(start)
    denom = S(max(end - begin, 1))
    delta = min(max(S(step - begin) / denom, S(0.0)), S(1.0))
    return start + delta * (stop - start)


@dataclasses.dataclass(frozen=True)
class NVTState:
    eta_dot: np.ndarray  # (chain,) host numpy array of the run's dtype
    # nvt/sphere: the cumulative thermostat scale^2 (host scalar)
    rot_scale2: Optional[float] = None


def _ke2(sys, p):
    return torch.sum(p.mass_atom[:, None] * sys.v * sys.v
                     * sys.mask[:, None]) * p.mvv2e


def _nhc(eta_dot, ke2, p: NVTParams, step=None):
    """Half-step NH chain update on host scalars (eta_dot a numpy array,
    ke2 a host scalar); returns (eta_dot, velocity scale)."""
    tt = p.t_target
    if step is not None:
        tt = ramp_target(p.t_target, p.t_stop, p.ramp_begin, p.ramp_end,
                         step)
    S = type(tt)
    kt = p.boltz * tt
    q0 = p.dof * kt / (p.t_freq * p.t_freq)
    qk = kt / (p.t_freq * p.t_freq)
    q = [q0] + [qk] * (p.t_chain - 1)
    eta = [S(e) for e in eta_dot]
    f = [S(0.0)] * p.t_chain
    f[0] = (ke2 - p.dof * kt) / q[0]
    for k in range(1, p.t_chain):
        f[k] = (q[k - 1] * eta[k - 1] * eta[k - 1] - kt) / q[k]
    w = p.dtq
    C = p.t_chain
    eta[C - 1] = eta[C - 1] + 0.5 * w * f[C - 1]
    for k in range(C - 2, -1, -1):
        s = _exp(-0.25 * w * eta[k + 1])
        eta[k] = eta[k] * s * s + 0.5 * w * f[k] * s
    scale = _exp(-w * eta[0])
    ke2 = ke2 * scale * scale
    f[0] = (ke2 - p.dof * kt) / q[0]
    for k in range(0, C - 1):
        s = _exp(-0.25 * w * eta[k + 1])
        eta[k] = eta[k] * s * s + 0.5 * w * f[k] * s
        f[k + 1] = (q[k] * eta[k] * eta[k] - kt) / q[k + 1]
    eta[C - 1] = eta[C - 1] + 0.5 * w * f[C - 1]
    return np.array(eta, dtype=eta_dot.dtype), scale


def init_state(sys, f, p: NVTParams):
    dt = chain_dtype(sys.x.dtype)
    return sys, NVTState(eta_dot=np.zeros(p.t_chain, dt),
                         rot_scale2=(None if p.rot_ke20 is None
                                     else dt(1.0)))


def _minv(p):
    live = p.mass_atom > 0
    return torch.where(live, 1.0 / torch.where(live, p.mass_atom, 1.0), 0.0)


def _chain(sys, p, st):
    """One chain update from the kinetic energy of sys (one host read):
    (new state, the velocity scale as a Python scalar).  The ramp reads
    sys.step: before its increment in initial_integrate, after it in
    final_integrate, as the JAX package does."""
    S = type(p.t_target)
    ke2 = S(_ke2(sys, p).item())
    rs2 = st.rot_scale2
    if p.rot_ke20 is not None:
        ke2 = ke2 + p.rot_ke20 * rs2
    eta_dot, scale = _nhc(st.eta_dot, ke2, p, sys.step)
    if rs2 is not None:
        rs2 = rs2 * scale * scale
    return NVTState(eta_dot=eta_dot, rot_scale2=rs2), float(scale)


def initial_integrate(sys: System, f, p: NVTParams, st: NVTState):
    st, scale = _chain(sys, p, st)
    v = sys.v * scale
    v = v + (p.dtf * _minv(p))[:, None] * f
    v = torch.where(sys.mask[:, None], v, 0.0)
    x = sys.x + p.dtv * v
    return sys.replace(x=x, v=v), st


def final_integrate(sys: System, f, p: NVTParams, st: NVTState):
    v = sys.v + (p.dtf * _minv(p))[:, None] * f
    v = torch.where(sys.mask[:, None], v, 0.0)
    sys = sys.replace(v=v)
    st, scale = _chain(sys, p, st)
    return sys.replace(v=sys.v * scale), st
