"""fix npt / nph — Nose-Hoover thermostat + MTK barostat (lidp_tpu/
integrate/npt.py; FixNH, fix_nh.cpp).

The reference's sequence (FixNH::initial_integrate :830-880,
final_integrate :886-923):

  initial:  nhc_press(:1819) -> nhc_temp(:1748, scales v by factor_eta) ->
            recompute T,P (KE changed) -> nh_omega_dot(:2228) ->
            nh_v_press(:1923, double half-exp scale) -> nve_v(:1974) ->
            remap half(:1058) -> nve_x(:2011) -> remap half
  final:    nve_v -> nh_v_press -> recompute T,P -> nh_omega_dot ->
            nhc_temp -> nhc_press

Masses follow the reference's update-every-call rule: eta_mass[0] =
dof k T_t / t_freq^2, the others k T_t / t_freq^2 (:1756-1760); omega_mass
= N k T_t / p_freq^2 (:1830-1832); etap_mass = k T_t / p_freq_max^2
(:1841-1844).  The chains take the nc=1, Yoshida-Suzuki-1 default.
Couplings: iso (couple xyz) and aniso / per-dimension flags; the remap
scales the positions and the box faces about the box centre (:107-109,
:1145).  The k-space terms follow the box: ForceField.kspace_dynamic
rescales the Ewald tables to the live box at each call, and PPPM forms its
k vectors from it.

The chains, T, P and the barostat's rates are device tensors: a step reads
nothing back to the host (each scalar operation is a launch of its own).
The parameters are Python floats; the ramped targets (t_target, p_target)
are substituted per step by driver.npt_integrator.  npt/sphere and
nph/sphere off the granular route (fix_nh_sphere.cpp with central forces):
the kinetic tensor adds the setup's rotational diagonal rot_ke30 times the
cumulative square of the thermostat's scale (NPTState.rot_scale2), in the
temperature and the pressure, as the JAX package tracks it.  Triclinic
boxes and the deviatoric (sigma) terms are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.state import System


@dataclasses.dataclass(frozen=True)
class NPTParams:
    dtv: float
    dtf: float                 # 0.5*dt*ftm2v
    mass_atom: torch.Tensor    # (N,)
    t_target: float            # thermostat target (the ramp's start)
    p_target: tuple            # (3,) per-dim target pressure (the start)
    t_freq: float
    p_freq_max: float
    natoms: float              # real atom count (omega_mass)
    pflag: torch.Tensor        # (3,) bool on the device, p_flag's
    p_freq_sq: torch.Tensor    # (3,) p_freq^2 on the device
    dof: float = 0.0
    boltz: float = 1.0
    mvv2e: float = 1.0
    nktv2p: float = 1.0
    tchain: int = 3
    pchain: int = 3
    mtk: bool = True
    tstat: bool = True
    p_flag: tuple = (True, True, True)
    iso: bool = True
    # per-run linear ramps (FixNH compute_temp_target/compute_press_target)
    t_stop: Optional[float] = None
    p_stop: Optional[tuple] = None
    ramp_begin: int = 0
    ramp_end: int = 0
    # the /sphere styles: (3,) sum 0.4 m r^2 w_d^2 at setup, on the device
    rot_ke30: Optional[torch.Tensor] = None

    @staticmethod
    def create(dt, ftm2v, mass_atom, t_target, t_period, p_target, p_period,
               *, natoms, dof, boltz, mvv2e, nktv2p, tchain=3, pchain=3,
               mtk=True, tstat=True, p_flag=(True, True, True), iso=True,
               t_stop=None, p_stop=None, dtype=torch.float64,
               device="cuda", rot_ke30=None):
        device = resolve_device(device)
        p_target = tuple(float(v) for v in np.broadcast_to(
            np.asarray(p_target, float), (3,)))
        p_period = np.broadcast_to(np.asarray(p_period, float), (3,))
        p_freq = tuple(float(1.0 / v) for v in p_period)
        return NPTParams(
            dtv=float(dt), dtf=float(0.5 * dt * ftm2v),
            mass_atom=torch.as_tensor(np.asarray(mass_atom), dtype=dtype,
                                      device=device),
            t_target=float(t_target), p_target=p_target,
            t_freq=float(1.0 / t_period), p_freq_max=max(p_freq),
            natoms=float(natoms),
            pflag=torch.tensor([bool(b) for b in p_flag], device=device),
            p_freq_sq=torch.tensor([f * f for f in p_freq], dtype=dtype,
                                   device=device),
            dof=float(dof), boltz=boltz, mvv2e=mvv2e, nktv2p=nktv2p,
            tchain=tchain, pchain=pchain, mtk=mtk, tstat=tstat,
            p_flag=tuple(bool(b) for b in p_flag), iso=iso,
            t_stop=float(t_target if t_stop is None else t_stop),
            p_stop=(p_target if p_stop is None else tuple(
                float(v) for v in np.broadcast_to(
                    np.asarray(p_stop, float), (3,)))),
            rot_ke30=(None if rot_ke30 is None else torch.as_tensor(
                np.asarray(rot_ke30), dtype=dtype, device=device)))


@dataclasses.dataclass(frozen=True)
class NPTState:
    eta: torch.Tensor          # (tchain,)
    eta_dot: torch.Tensor      # (tchain+1,) the last stays 0
    eta_dotdot: torch.Tensor   # (tchain,)
    etap: torch.Tensor         # (pchain,)
    etap_dot: torch.Tensor     # (pchain+1,)
    etap_dotdot: torch.Tensor  # (pchain,)
    omega: torch.Tensor        # (3,)
    omega_dot: torch.Tensor    # (3,)
    mtk_term2: torch.Tensor    # () carried into nh_v_press
    # the /sphere styles' cumulative thermostat scale^2 (1 and unread for
    # point particles, as in the JAX package)
    rot_scale2: Optional[torch.Tensor] = None


def init_state(sys, f, p: NPTParams):
    def z(n):
        return sys.v.new_zeros((n,))

    pc = max(p.pchain, 1)
    return sys, NPTState(
        eta=z(p.tchain), eta_dot=z(p.tchain + 1), eta_dotdot=z(p.tchain),
        etap=z(pc), etap_dot=z(pc + 1), etap_dotdot=z(pc),
        omega=z(3), omega_dot=z(3), mtk_term2=sys.v.new_zeros(()),
        rot_scale2=sys.v.new_ones(()))


def _kt(p: NPTParams):
    return p.boltz * p.t_target


def _ke_tensor(v, mask, p: NPTParams, st: NPTState):
    """Per-dim sum(m v_d^2) * mvv2e over real atoms (compute_temp
    vector), plus the scale-tracked sphere rotational diagonal."""
    m = torch.where(mask, p.mass_atom, 0.0)
    ke3 = p.mvv2e * torch.sum(m[:, None] * v * v, dim=0)
    if p.rot_ke30 is not None:
        ke3 = ke3 + p.rot_ke30 * st.rot_scale2
    return ke3


def _t_current(ke3, p: NPTParams):
    return torch.sum(ke3) / (p.dof * p.boltz)


def _volume(box):
    L = box.lengths
    return L[0] * L[1] * L[2]


def _p_current(box, res, ke3, p: NPTParams):
    """Coupled pressure per dim: (mvv_d + virial_d)/V*nktv2p, then couple()
    (fix_nh.cpp couple: iso averages the coupled dims)."""
    ptens = (ke3 + res.virial[:3]) / _volume(box) * p.nktv2p
    if p.iso:
        ptens = torch.mean(ptens).expand(3)
    return ptens


def _chain_half(vel, dd, dt4, dt8, n):
    """The outer half of a chain update (the loop from the top link down
    to link 1), on lists of 0-d tensors: vel (n+1) velocities, dd (n)
    accelerations; returns expfac0 (used again after the scale)."""
    for ich in range(n - 1, 0, -1):
        expfac = torch.exp(-dt8 * vel[ich + 1])
        vel[ich] = (vel[ich] * expfac + dd[ich] * dt4) * expfac
    expfac0 = torch.exp(-dt8 * vel[1])
    vel[0] = (vel[0] * expfac0 + dd[0] * dt4) * expfac0
    return expfac0


def _chain_tail(vel, dd, mass, kt, dt4, dt8, n):
    for ich in range(1, n):
        expfac = torch.exp(-dt8 * vel[ich + 1])
        d = (mass[ich - 1] * (vel[ich - 1] * vel[ich - 1]) - kt) / mass[ich]
        dd[ich] = d
        vel[ich] = (vel[ich] * expfac + d * dt4) * expfac


def _nhc_temp(v, mask, t_current, st: NPTState, p: NPTParams):
    """nhc_temp_integrate (:1748) — one nc loop, updates (v, eta,
    eta_dot)."""
    dt4 = 0.5 * p.dtv / 2.0
    dt8 = dt4 / 2.0
    dthalf = 0.5 * p.dtv
    kT = _kt(p)
    ke_target = p.dof * kT
    tf2 = p.t_freq * p.t_freq
    eta_mass = [p.dof * kT / tf2] + [kT / tf2] * (p.tchain - 1)
    kecurrent = p.dof * p.boltz * t_current
    vel = list(st.eta_dot.unbind(0))
    dd = list(st.eta_dotdot.unbind(0))
    dd[0] = (kecurrent - ke_target) / eta_mass[0]
    expfac0 = _chain_half(vel, dd, dt4, dt8, p.tchain)

    factor_eta = torch.exp(-dthalf * vel[0])
    v = v * torch.where(mask, factor_eta, 1.0)[:, None]
    if p.rot_ke30 is not None:
        # FixNHSphere::nh_v_temp scales omega by the same factor
        st = dataclasses.replace(
            st, rot_scale2=st.rot_scale2 * factor_eta * factor_eta)
    t_current = t_current * factor_eta * factor_eta
    kecurrent = p.dof * p.boltz * t_current
    dd[0] = (kecurrent - ke_target) / eta_mass[0]
    eta = st.eta + dthalf * torch.stack(vel[:p.tchain])
    vel[0] = (vel[0] * expfac0 + dd[0] * dt4) * expfac0
    _chain_tail(vel, dd, eta_mass, kT, dt4, dt8, p.tchain)
    return v, t_current, dataclasses.replace(
        st, eta=eta, eta_dot=torch.stack(vel), eta_dotdot=torch.stack(dd))


def _kec(omega_dot, p: NPTParams, kT):
    w = p.natoms * kT / p.p_freq_sq * (omega_dot * omega_dot)
    return torch.sum(torch.where(p.pflag, w, 0.0))


def _nhc_press(st: NPTState, p: NPTParams):
    """nhc_press_integrate (:1819) — updates the etap chain and scales
    omega_dot."""
    if p.pchain == 0:
        return st
    dt4 = 0.5 * p.dtv / 2.0
    dt8 = dt4 / 2.0
    dthalf = 0.5 * p.dtv
    kT = _kt(p)
    etap_mass = [kT / (p.p_freq_max * p.p_freq_max)] * p.pchain
    vel = list(st.etap_dot.unbind(0))
    dd = list(st.etap_dotdot.unbind(0))
    dd[0] = (_kec(st.omega_dot, p, kT) - kT) / etap_mass[0]
    if p.pchain > 1:
        expfac0 = _chain_half(vel, dd, dt4, dt8, p.pchain)
    else:
        expfac0 = 1.0
        vel[0] = vel[0] + dd[0] * dt4
    etap = st.etap + dthalf * torch.stack(vel[:p.pchain])
    factor_etap = torch.exp(-dthalf * vel[0])
    omega_dot = torch.where(p.pflag, st.omega_dot * factor_etap,
                            st.omega_dot)
    dd[0] = (_kec(omega_dot, p, kT) - kT) / etap_mass[0]
    vel[0] = (vel[0] * expfac0 + dd[0] * dt4) * expfac0
    _chain_tail(vel, dd, etap_mass, kT, dt4, dt8, p.pchain)
    return dataclasses.replace(st, etap=etap, etap_dot=torch.stack(vel),
                               etap_dotdot=torch.stack(dd),
                               omega_dot=omega_dot)


def _p_hydro(p: NPTParams):
    pdim = sum(p.p_flag)
    return sum(t for t, f in zip(p.p_target, p.p_flag) if f) / max(pdim, 1)


def _nh_omega_dot(t_current, ke3, p_current, vol, st: NPTState,
                  p: NPTParams):
    """(:2228) — updates omega_dot and the MTK terms."""
    dthalf = 0.5 * p.dtv
    pdim = sum(p.p_flag)
    kT = _kt(p)
    omega_mass = p.natoms * kT / p.p_freq_sq
    p_hydro = _p_hydro(p)
    if p.mtk:
        if p.iso:
            mtk1 = p.dof * p.boltz * t_current / (pdim * p.natoms)
        else:
            mtk1 = torch.sum(torch.where(p.pflag, ke3, 0.0)) / (
                pdim * p.natoms)
    else:
        mtk1 = 0.0
    f_omega = ((p_current - p_hydro) * vol / (omega_mass * p.nktv2p)
               + mtk1 / omega_mass)
    omega_dot = torch.where(p.pflag, st.omega_dot + f_omega * dthalf,
                            st.omega_dot)
    if p.mtk:
        mtk2 = torch.sum(torch.where(p.pflag, omega_dot, 0.0)) / (
            pdim * p.natoms)
    else:
        mtk2 = torch.zeros_like(st.mtk_term2)
    return dataclasses.replace(st, omega_dot=omega_dot, mtk_term2=mtk2)


def _nh_v_press(v, st: NPTState, p: NPTParams):
    """(:1923) — v scaled twice by exp(-dt4*(omega_dot+mtk2)) per dim."""
    dt4 = 0.5 * p.dtv / 2.0
    factor = torch.where(p.pflag,
                         torch.exp(-dt4 * (st.omega_dot + st.mtk_term2)),
                         1.0)
    return v * (factor * factor)[None, :]   # padded atoms have v == 0


def _remap(sys: System, st: NPTState, p: NPTParams):
    """(:1058) — half-step box dilation about the box centre; atoms ride in
    fractional coordinates (x2lamda/lamda2x).  The System gets a new Box."""
    dto = 0.5 * p.dtv
    lo, hi = sys.box.lo, sys.box.hi
    fixed = 0.5 * (lo + hi)
    expfac = torch.where(p.pflag, torch.exp(dto * st.omega_dot), 1.0)
    lam = (sys.x - lo) / (hi - lo)
    lo2 = (lo - fixed) * expfac + fixed
    hi2 = (hi - fixed) * expfac + fixed
    x2 = lo2 + lam * (hi2 - lo2)
    box2 = dataclasses.replace(sys.box, lo=lo2, hi=hi2)
    omega = st.omega + dto * st.omega_dot
    return (sys.replace(x=x2, box=box2),
            dataclasses.replace(st, omega=omega))


def _dtfm(p: NPTParams):
    return (p.dtf / p.mass_atom)[:, None]


def initial_integrate(sys: System, res, p: NPTParams, st: NPTState):
    v, mask = sys.v, sys.mask
    st = _nhc_press(st, p)
    ke3 = _ke_tensor(v, mask, p, st)
    t_cur = _t_current(ke3, p)
    if p.tstat:
        v, t_cur, st = _nhc_temp(v, mask, t_cur, st, p)
        ke3 = _ke_tensor(v, mask, p, st)
    p_cur = _p_current(sys.box, res, ke3, p)
    st = _nh_omega_dot(t_cur, ke3, p_cur, _volume(sys.box), st, p)
    v = _nh_v_press(v, st, p)
    # nve_v + nve_x with half-step remaps around the drift
    v = v + _dtfm(p) * res.f
    v = torch.where(mask[:, None], v, 0.0)
    sys = sys.replace(v=v)
    sys, st = _remap(sys, st, p)
    sys = sys.replace(x=sys.x + p.dtv * sys.v)
    sys, st = _remap(sys, st, p)
    return sys, st


def final_integrate(sys: System, res, p: NPTParams, st: NPTState):
    mask = sys.mask
    v = sys.v + _dtfm(p) * res.f
    v = torch.where(mask[:, None], v, 0.0)
    v = _nh_v_press(v, st, p)
    ke3 = _ke_tensor(v, mask, p, st)
    t_cur = _t_current(ke3, p)
    p_cur = _p_current(sys.box, res, ke3, p)
    st = _nh_omega_dot(t_cur, ke3, p_cur, _volume(sys.box), st, p)
    if p.tstat:
        v, t_cur, st = _nhc_temp(v, mask, t_cur, st, p)
    st = _nhc_press(st, p)
    return sys.replace(v=v), st
