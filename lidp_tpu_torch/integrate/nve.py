"""fix nve — velocity-Verlet point-particle integration
(lidp_tpu/integrate/nve.py).

Matches FixNVE (fix_nve.cpp:65,109): half-kick + drift, then half-kick, with
dtf = 0.5 * dt * ftm2v.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lidp_tpu_torch.state import System


@dataclasses.dataclass(frozen=True)
class NVEParams:
    dtv: torch.Tensor        # dt
    dtf: torch.Tensor        # 0.5 * dt * ftm2v
    mass_atom: torch.Tensor  # (N,)
    # fix-group mask (FixNVE only integrates its group; atoms outside any
    # time-integration fix do not move); None = all atoms
    gmask: Optional[torch.Tensor] = None
    # fix nve/limit (fix_nve_limit.cpp): per-atom |v| clamp after each
    # half-kick, vlimitsq = (xlimit/dt)^2; None = plain nve
    vlimitsq: Optional[torch.Tensor] = None
    # fix nve/noforce (fix_nve_noforce.cpp): drift x only, never kick v
    noforce: bool = False

    @staticmethod
    def create(dt: float, ftm2v: float, mass_atom, dtype=torch.float64,
               gmask=None, xlimit=None, noforce=False, device="cpu"):
        def t(a, d=dtype):
            return torch.as_tensor(a, dtype=d, device=device)

        return NVEParams(
            dtv=t(dt), dtf=t(0.5 * dt * ftm2v), mass_atom=t(mass_atom),
            gmask=None if gmask is None else t(gmask, torch.bool),
            vlimitsq=None if xlimit is None else t((xlimit / dt) ** 2),
            noforce=noforce)


def _minv(p):
    live = p.mass_atom > 0
    return torch.where(live, 1.0 / torch.where(live, p.mass_atom, 1.0), 0.0)


def _upd_mask(sys, p):
    m = sys.mask
    if p.gmask is not None:
        m = m & p.gmask
    return m[:, None]


def _vclamp(v, upd, p):
    """fix nve/limit: rescale any atom whose |v| exceeds xlimit/dt."""
    vsq = torch.sum(v * v, dim=1, keepdim=True)
    scale = torch.sqrt(p.vlimitsq / torch.clamp(vsq, min=1e-300))
    return torch.where(upd & (vsq > p.vlimitsq), v * scale, v)


def _kick(sys, f, p, upd):
    v = torch.where(upd, sys.v + (p.dtf * _minv(p))[:, None] * f, sys.v)
    v = torch.where(sys.mask[:, None], v, 0.0)
    if p.vlimitsq is not None:
        v = _vclamp(v, upd, p)
    return v


def initial_integrate(sys: System, f, p: NVEParams) -> System:
    upd = _upd_mask(sys, p)
    v = sys.v if p.noforce else _kick(sys, f, p, upd)
    x = sys.x + torch.where(upd, p.dtv * v, 0.0)
    return sys.replace(x=x, v=v)


def final_integrate(sys: System, f, p: NVEParams) -> System:
    if p.noforce:
        return sys
    return sys.replace(v=_kick(sys, f, p, _upd_mask(sys, p)))


# --- compensated (Kahan) variant -------------------------------------------
#
# In float32 the plain x += dt*v update loses ~eps*|x| per step (|x| ~ box
# size while dt*v is ~1e-3 of it), which shows up as a secular energy drift.
# Carrying a Kahan compensation term for x and v in the integrator state
# recovers near-float64 conservation at float32 force cost; the compensation
# arrays ride in `istate`, so the System (and every force kernel) is
# unchanged.


def _kadd(a, d, c):
    """One Kahan step: a += d with running compensation c."""
    y = d - c
    t = a + y
    c_new = (t - a) - y
    return t, c_new


def kahan_init_state(sys: System, f, p: NVEParams):
    return sys, (torch.zeros_like(sys.x), torch.zeros_like(sys.v))


def _kahan_kick(sys, f, p, cv):
    v, cv = _kadd(sys.v, (p.dtf * _minv(p))[:, None] * f, cv)
    m = sys.mask[:, None]
    return torch.where(m, v, 0.0), torch.where(m, cv, 0.0)


def kahan_initial_integrate(sys: System, f, p: NVEParams, st):
    cx, cv = st
    v, cv = _kahan_kick(sys, f, p, cv)
    x, cx = _kadd(sys.x, p.dtv * v, cx)
    return sys.replace(x=x, v=v), (cx, cv)


def kahan_final_integrate(sys: System, f, p: NVEParams, st):
    cx, cv = st
    v, cv = _kahan_kick(sys, f, p, cv)
    return sys.replace(v=v), (cx, cv)
