"""Thermodynamic observables (lidp_tpu/thermo.py; thermo_style custom
columns).

Matches the reference computes: temperature (compute_temp.cpp:74 — dof =
dim*N - extra_dof - fix_dof), pressure (compute_pressure.cpp:178 — kinetic
trace + virial over 3V, nktv2p; compute pressure with a named temperature
compute or none), potential energy (compute_pe.cpp:80).  In
lj units thermo values are normalized per atom (thermo_modify norm
default), in real units they are extensive — as in Thermo::compute
(thermo.cpp:332).
"""

from __future__ import annotations

import dataclasses

import torch

from lidp_tpu_torch.forcefield import ForceResult
from lidp_tpu_torch.state import System
from lidp_tpu_torch.units import Units


@dataclasses.dataclass(frozen=True)
class ThermoParams:
    mass_atom: torch.Tensor   # (N,) per-atom mass
    dof: float                # temperature degrees of freedom
    boltz: float = 1.0
    mvv2e: float = 1.0
    nktv2p: float = 1.0
    norm: bool = False
    natoms: int = 0
    mv2d: float = 1.0
    dim: int = 3
    # compute temp/partial: per-component selection
    vcomp: tuple = (True, True, True)
    # compute temp/com: subtract the group's center-of-mass velocity
    com_bias: bool = False
    # pair_modify tail: long-range LJ corrections (thermo.cpp:1789 adds
    # etail/V to PE, compute_pressure.cpp:292 adds ptail/V to each diagonal
    # virial component)
    etail: float = 0.0
    ptail: float = 0.0

    @staticmethod
    def create(mass_atom, dof, units: Units, norm: bool, natoms: int,
               dim: int = 3, vcomp=(True, True, True), com_bias=False,
               etail=0.0, ptail=0.0, dtype=None, device="cpu"):
        return ThermoParams(
            mass_atom=torch.as_tensor(mass_atom, dtype=dtype, device=device),
            dof=float(dof), boltz=units.boltz, mvv2e=units.mvv2e,
            nktv2p=units.nktv2p, norm=norm, natoms=natoms,
            mv2d=getattr(units, "mv2d", 1.0), dim=dim,
            vcomp=tuple(bool(v) for v in vcomp), com_bias=bool(com_bias),
            etail=float(etail), ptail=float(ptail))


def ke_total(sys: System, tp: ThermoParams):
    m = tp.mass_atom * sys.mask
    v = sys.v
    if tp.com_bias:
        # compute_temp_com.cpp: thermal KE relative to the group vcm
        vcm = torch.sum(m[:, None] * v, dim=0) / torch.clamp(torch.sum(m),
                                                             min=1e-300)
        v = v - vcm[None, :]
    vv = v * v
    if not all(tp.vcomp):
        vv = vv * torch.tensor(tp.vcomp, dtype=v.dtype,
                               device=v.device)[None, :]
    msum = torch.sum(m[:, None] * vv)
    return 0.5 * msum * tp.mvv2e


def temperature(sys: System, tp: ThermoParams):
    return 2.0 * ke_total(sys, tp) / (tp.dof * tp.boltz)


def pressure(sys: System, tp: ThermoParams, virial6):
    """compute_pressure.cpp: 2d uses the area (xprd*yprd) and averages over
    the first `dim` diagonal components; mvv here is the FULL kinetic
    trace, which equals the in-plane trace in 2d (v_z == 0)."""
    mvv = 2.0 * ke_total(sys, tp)       # = dof*boltz*T
    if tp.dim == 2:
        w = virial6[0] + virial6[1]
        L = sys.box.lengths
        return (mvv + w) / (2.0 * L[0] * L[1]) * tp.nktv2p
    w = virial6[0] + virial6[1] + virial6[2]
    if tp.ptail:
        w = w + 3.0 * tp.ptail / sys.box.volume
    return (mvv + w) / (3.0 * sys.box.volume) * tp.nktv2p


def compute_pressure(sys: System, tp: ThermoParams, virial6,
                     kinetic=True):
    """compute ID group pressure temp-ID [virial] (compute_pressure.cpp
    as the JAX package forms it, its sim.py:3081-3098): the kinetic part
    of the temperature compute's ThermoParams tp (its group, masses and
    biases; tp's ptail, none for a compute's) plus the virial, over dim V;
    kinetic False (temp-ID NULL, or the virial keyword): the virial
    alone."""
    if not kinetic:
        tp = dataclasses.replace(tp, mass_atom=torch.zeros_like(tp.mass_atom))
    return pressure(sys, tp, virial6)


def thermo_row(sys: System, res: ForceResult, tp: ThermoParams,
               extra_virial=None, extra=None) -> dict:
    """All standard columns used by the bundled inputs, as Python numbers.

    extra_virial: fix contributions added to the pair/kspace virial for
    the pressure.  extra: further named 0-d tensors (a compute's c_ID) to
    read with the columns.  The scalars are stacked on the device in
    float64 (a float32 value converts exactly) and read with one transfer;
    `step` is the system's Python int."""
    ke = ke_total(sys, tp)
    box = sys.box
    vol = box.volume
    etail = tp.etail / vol if tp.etail else 0.0
    pe = res.pe + etail
    virial = res.virial if extra_virial is None else res.virial + extra_virial
    norm = float(tp.natoms) if tp.norm else 1.0
    L, lo, hi = box.lengths, box.lo, box.hi
    zero = torch.zeros((), dtype=sys.x.dtype, device=sys.x.device)
    cols = {
        "temp": temperature(sys, tp),
        "ke": ke / norm,
        "pe": pe / norm,
        "etotal": (ke + pe) / norm,
        "evdwl": res.evdwl / norm,
        "ecoul": res.ecoul / norm,
        "elong": res.elong / norm,
        "epol": res.epol / norm,
        "epair": (res.epair + etail) / norm,
        "emol": res.emol / norm,
        "ebond": res.ebond / norm,
        "eangle": res.eangle / norm,
        "edihed": res.edihed / norm,
        "eimp": res.eimp / norm,
        "press": pressure(sys, tp, virial),
        # 2d vol is the box area (thermo.cpp compute_vol)
        "vol": L[0] * L[1] if tp.dim == 2 else vol,
        "density": tp.mv2d * torch.sum(tp.mass_atom * sys.mask) / vol,
        "lx": L[0], "ly": L[1], "lz": L[2],
        "xlo": lo[0], "ylo": lo[1], "zlo": lo[2],
        "xhi": hi[0], "yhi": hi[1], "zhi": hi[2],
        # the port's box is orthogonal
        "xy": zero, "xz": zero, "yz": zero,
        **(extra or {}),
    }
    vals = torch.stack([(zero + v).to(torch.float64)
                        for v in cols.values()]).tolist()
    return {"step": int(sys.step), **dict(zip(cols, vals))}
