"""Carry force-field tables and state across from the JAX package.

The caller hands over the fields of lidp_tpu's dataclasses (PairParams,
DPDParams, EwaldParams, PPPMParams, Ewald6Params, PPPMDispParams, MSMParams,
TIP4PParams, PolarizationSettings, System, Cells, SlotCarry,
RigidSetup, RigidState, NVTState, NPTState, the bonded params and
ShakeParams) as numpy arrays or scalars, e.g.
`{f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}`,
so both packages compute from the same tables and the same state.  Nothing
here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.box import Box
from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.integrate.npt import NPTState
from lidp_tpu_torch.integrate.nvt import NVTState
from lidp_tpu_torch.integrate.rigid import (RigidSetup, RigidState,
                                            chain_dtype)
from lidp_tpu_torch.integrate.slot_runner import SlotCarry
from lidp_tpu_torch.ops.cells import Cells
from lidp_tpu_torch.ops.ewald import Ewald6Params, EwaldParams
from lidp_tpu_torch.ops.msm import MSMParams
from lidp_tpu_torch.ops.pair import COUL_KINDS, KINDS, PairParams
from lidp_tpu_torch.ops.polarization import PolarizationSettings
from lidp_tpu_torch.ops.pppm import PPPMDispParams, PPPMParams
from lidp_tpu_torch.ops.tip4p import TIP4PParams
from lidp_tpu_torch.state import System


def _scalar(v):
    """numpy 0-d array or Python scalar -> Python scalar (None stays)."""
    if v is None:
        return None
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a


def _given(d: dict, k):
    """d[k], None where it is absent or None (np.asarray(None) included)."""
    v = d.get(k)
    if isinstance(v, np.ndarray) and v.dtype == object and v.ndim == 0:
        v = v.item()
    return v


def pair_from_numpy(pair: dict, device="cuda",
                    dtype=torch.float32) -> PairParams:
    """The port's PairParams from a numpy copy of the JAX one, every kind
    and coulomb kind of ops/pair.py: lj/cut (coul=False), lj/cut/coul/long
    or the lj/charmm and lj/charmmfsw styles (lj3, lj4, the charmm energy
    or force switch, charmm_fsw); the long dispersion kinds lj/long (lj3,
    lj4 as they are) and buck/long (the JAX tables lj1 = A, lj2 = 1/rho,
    lj3 = C become lj3, rhoinv and lj4), both with the g6 of their lj5
    table; the generic kinds with their tables lj1..lj5 as they are; the
    table (tab_e, tab_f, tab_rlo, tab_dr); the coulomb kinds with their
    scalars (msm_order, the charmm and charmm/implicit switch, the
    dsf/wolf shifts, gromacs's coulsw); and excl_mol and the type
    exclusion table excl.  A kind or coulomb kind the JAX package does
    not have raises."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    coul = bool(_scalar(pair.get("coul", True)))
    kind = str(_scalar(pair.get("kind", "lj")))
    coul_kind = str(_scalar(pair.get("coul_kind", "long"))) if coul \
        else "long"
    if kind not in KINDS:
        raise NotImplementedError(f"pair field kind={kind!r}: no van der "
                                  "Waals kind of the JAX package")
    if coul_kind not in COUL_KINDS:
        raise NotImplementedError(f"pair field coul_kind={coul_kind!r}: no "
                                  "coulomb kind of the JAX package")
    lj5 = _given(pair, "lj5")
    if kind == "lj" and lj5 is not None:
        raise ValueError("pair field lj5 with kind 'lj': the JAX package "
                         "builds no such table")

    def f(k, default):
        v = _given(pair, k)
        return default if v is None else float(_scalar(v))

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    tabs = {k: t(pair[k]) for k in ("lj3", "lj4", "offset", "cut_ljsq",
                                    "cutsq", "special_lj", "special_coul")}
    extra = {}
    g6 = 1.0
    if kind in ("lj/long", "buck/long"):
        # the JAX package fills the whole table with the global g6
        lj5 = np.asarray(lj5, float)
        g6 = float(lj5.flat[0])
        if not np.all(lj5 == g6):
            raise ValueError("the long kinds' lj5 table is not one g6")
        if kind == "buck/long":
            tabs["lj3"], tabs["lj4"] = t(pair["lj1"]), t(pair["lj3"])
            extra["rhoinv"] = t(pair["lj2"])
    elif kind == "table":
        extra.update(tab_e=t(pair["tab_e"]), tab_f=t(pair["tab_f"]),
                     tab_rlo=f("tab_rlo", 0.0), tab_dr=f("tab_dr", 1.0))
    elif kind != "lj":
        extra.update(lj1=t(pair["lj1"]), lj2=t(pair["lj2"]),
                     lj5=None if lj5 is None else t(lj5))
    coulsw = _given(pair, "coulsw")
    return PairParams(
        **tabs, **extra,
        cut_coulsq=float(_scalar(pair["cut_coulsq"])),
        qqrd2e=float(_scalar(pair["qqrd2e"])),
        g_ewald=float(_scalar(pair["g_ewald"])), coul=coul,
        excl_mol=bool(_scalar(pair.get("excl_mol", False))),
        excl=(None if _given(pair, "excl") is None else torch.as_tensor(
            np.array(pair["excl"]), dtype=torch.bool, device=device)),
        charmm=bool(_scalar(pair.get("charmm", False))),
        charmm_fsw=bool(_scalar(pair.get("charmm_fsw", False))),
        cut_lj_innersq=f("cut_lj_innersq", 0.0), denom_lj=f("denom_lj", 1.0),
        coul_kind=coul_kind, cut_coul_innersq=f("cut_coul_innersq", 0.0),
        denom_coul=f("denom_coul", 1.0), kind=kind, g6=g6,
        msm_order=int(_scalar(pair.get("msm_order", 10))),
        coul_eshift=f("coul_eshift", 0.0), coul_fshift=f("coul_fshift", 0.0),
        coulsw=(None if coulsw is None
                else tuple(float(v) for v in np.asarray(coulsw))))


def dpd_from_numpy(d: dict, device="cuda", dtype=torch.float64):
    """The port's ops.dpd.DPDParams from a numpy copy of the JAX one (its
    tables in `dtype`, dtinvsqrt a Python float, seed and tstat as they
    are)."""
    from lidp_tpu_torch import resolve_device
    from lidp_tpu_torch.ops.dpd import DPDParams

    device = resolve_device(device)
    return DPDParams(
        **{k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)
           for k in ("a0", "gamma", "sigma", "cut", "cutsq", "special_lj")},
        dtinvsqrt=float(_scalar(d["dtinvsqrt"])),
        seed=int(_scalar(d["seed"])), tstat=bool(_scalar(d["tstat"])))


def forcefield_from_numpy(pair: dict, ewald: dict, polar: dict, qqrd2e,
                          device="cuda", dtype=torch.float32, sp_code=None,
                          reference_gs=False, sp_idx=None,
                          sp_lvl=None) -> ForceField:
    """The port's ForceField from numpy copies of the JAX dataclasses;
    sp_code: the JAX ForceField's (N,N) special codes, sp_idx and sp_lvl
    its (N,S) special lists, reference_gs its switch."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    pp = pair_from_numpy(pair, device=device, dtype=dtype)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    ew = None
    if ewald is not None:
        ew = EwaldParams(
            hvecs=t(ewald["hvecs"]), kcoeff=t(ewald["kcoeff"]),
            kvirial=t(ewald["kvirial"]),
            kints=(None if _given(ewald, "kints") is None
                   else t(ewald["kints"])),
            **{k: float(_scalar(ewald[k]))
               for k in ("g_ewald", "qscale", "qsum", "qsqsum")})
    s = None
    if polar is not None:
        names = {f.name for f in dataclasses.fields(PolarizationSettings)}
        s = PolarizationSettings(**{k: _scalar(v) for k, v in polar.items()
                                    if k in names})
    if sp_code is not None:
        sp_code = torch.as_tensor(np.array(sp_code), device=device)
    if sp_idx is not None:
        sp_idx = torch.as_tensor(np.array(sp_idx), dtype=torch.long,
                                 device=device)
        sp_lvl = torch.as_tensor(np.array(sp_lvl), dtype=torch.long,
                                 device=device)
    return ForceField(pair=pp, ewald=ew, polar=s, qqrd2e=float(qqrd2e),
                      sp_code=sp_code, reference_gs=bool(reference_gs),
                      sp_idx=sp_idx, sp_lvl=sp_lvl)


def _np_dtype(a):
    return torch.float64 if np.asarray(a).dtype == np.float64 \
        else torch.float32


def system_from_numpy(sys: dict, device="cuda") -> System:
    """The port's System from numpy copies of the JAX System's fields;
    `sys["box"]` is a dict with lo, hi and optionally periodic and tilt.
    Floating fields keep the dtype of x."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    dtype = _np_dtype(sys["x"])
    b = sys["box"]
    box = Box.create(b["lo"], b["hi"], dtype=dtype,
                     periodic=b.get("periodic", (True, True, True)),
                     tilt=b.get("tilt"), device=device)

    def t(name, d):
        return torch.as_tensor(np.array(sys[name]), device=device).to(d)

    return System(
        x=t("x", dtype), v=t("v", dtype), q=t("q", dtype),
        type=t("type", torch.int32), mol=t("mol", torch.int32),
        alpha=t("alpha", dtype), mu=t("mu", dtype),
        image=t("image", torch.int32), mask=t("mask", torch.bool), box=box,
        step=int(np.asarray(sys.get("step", 0))))


def cells_from_numpy(cells: dict, device="cuda") -> Cells:
    """The port's Cells from numpy copies of the JAX Cells' fields."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)

    def t(name, d):
        return torch.as_tensor(np.array(cells[name]), device=device).to(d)

    return Cells(atom_of_slot=t("atom_of_slot", torch.int32).contiguous(),
                 slot_of_atom=t("slot_of_atom", torch.int32),
                 overflow=t("overflow", torch.bool))


def slot_carry_from_numpy(carry: dict, device="cuda") -> SlotCarry:
    """The port's SlotCarry from numpy copies of the JAX SlotCarry's
    fields."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)

    def t(name, d):
        return torch.as_tensor(np.array(carry[name]), device=device).to(d)

    f32 = torch.float32
    return SlotCarry(x=t("x", f32), v=t("v", f32), f=t("f", f32),
                     invm=t("invm", f32), aid=t("aid", torch.int32),
                     step=int(np.asarray(carry["step"])),
                     overflow=t("overflow", torch.bool))


def rigid_setup_from_numpy(setup: dict) -> RigidSetup:
    """The port's RigidSetup (host numpy, as in the JAX package) from
    numpy copies of the JAX RigidSetup's fields."""
    return RigidSetup(
        nbody=int(np.asarray(setup["nbody"])),
        body_of_atom=np.asarray(setup["body_of_atom"], np.int32),
        **{k: np.asarray(setup[k], np.float64)
           for k in ("masstotal", "inertia", "displace", "xcm0", "quat0")},
        dof_removed=int(np.asarray(setup["dof_removed"])),
        nlinear=int(np.asarray(setup["nlinear"])))


def rigid_state_from_numpy(state: dict, device="cuda") -> RigidState:
    """The port's RigidState from numpy copies of the JAX RigidState's
    fields, the barostat's where they are not None.  The tensors keep the
    dtype of xcm; the chain velocities eta_dot_t, eta_dot_r and eta_dot_b
    stay host arrays of that dtype."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    dtype = _np_dtype(state["xcm"])
    chains = ("eta_dot_t", "eta_dot_r", "eta_dot_b")
    out = {f.name: torch.as_tensor(np.array(state[f.name]), dtype=dtype,
                                   device=device)
           for f in dataclasses.fields(RigidState)
           if f.name not in chains and _given(state, f.name) is not None}
    return RigidState(**out, **{
        k: np.array(state[k], dtype=np.asarray(state["xcm"]).dtype)
        for k in chains if _given(state, k) is not None})


def pppm_from_numpy(pppm: dict) -> PPPMParams:
    """The port's PPPMParams from a numpy copy of the JAX one (its scalars
    as Python floats)."""
    return PPPMParams(
        **{k: float(_scalar(pppm[k]))
           for k in ("g_ewald", "qqrd2e", "qsqsum", "qsum")},
        grid=tuple(int(v) for v in pppm["grid"]),
        order=int(_scalar(pppm["order"])),
        stagger=bool(_scalar(pppm.get("stagger", False))))


def ewald6_from_numpy(d: dict, device="cuda",
                      dtype=torch.float64) -> Ewald6Params:
    """The port's Ewald6Params from a numpy copy of the JAX one."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    return Ewald6Params(
        **{k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)
           for k in ("hvecs", "kcoeff6", "kvirial6")},
        **{k: float(_scalar(d[k])) for k in ("g6", "bsum", "bsbsum")})


def pppm_disp_from_numpy(d: dict) -> PPPMDispParams:
    """The port's PPPMDispParams from a numpy copy of the JAX one."""
    return PPPMDispParams(g6=float(_scalar(d["g6"])),
                          grid=tuple(int(v) for v in d["grid"]),
                          order=int(_scalar(d["order"])),
                          bsum=float(_scalar(d["bsum"])),
                          bsbsum=float(_scalar(d["bsbsum"])))


def msm_from_numpy(d: dict, device="cuda", dtype=torch.float64) -> MSMParams:
    """The port's MSMParams from a numpy copy of the JAX one (its ghat
    and vhat tuples of complex arrays, the static scalars)."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64

    def t(a):
        return torch.as_tensor(np.array(a), device=device).to(cdtype)

    return MSMParams(ghat=tuple(t(g) for g in d["ghat"]),
                     vhat=tuple(t(v) for v in d.get("vhat", ())),
                     order=int(_scalar(d["order"])),
                     cutoff=float(_scalar(d["cutoff"])),
                     grid=tuple(int(v) for v in d["grid"]),
                     levels=int(_scalar(d["levels"])),
                     gamma0=float(_scalar(d["gamma0"])),
                     qscale=float(_scalar(d["qscale"])))


def tip4p_from_numpy(d: dict, device="cuda") -> TIP4PParams:
    """The port's TIP4PParams from a numpy copy of the JAX one (h1, h2,
    is_o, alpha), with each H's O found from h1 and h2."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    h1, h2 = np.array(d["h1"]), np.array(d["h2"])
    is_o = np.array(d["is_o"], bool)
    o_of = np.arange(h1.shape[0])
    is_h = np.zeros(h1.shape[0], bool)
    for i in np.nonzero(is_o)[0]:
        o_of[h1[i]] = o_of[h2[i]] = i
        is_h[h1[i]] = is_h[h2[i]] = True

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    return TIP4PParams(h1=t(h1, torch.long), h2=t(h2, torch.long),
                       is_o=t(is_o, torch.bool), o_of=t(o_of, torch.long),
                       is_h=t(is_h, torch.bool),
                       alpha=float(_scalar(d["alpha"])))


def npt_state_from_numpy(state: dict, device="cuda") -> NPTState:
    """The port's NPTState from numpy copies of the JAX NPTState's fields
    (rot_scale2, the /sphere styles', is not read), in the dtype of
    omega."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    dtype = _np_dtype(state["omega"])
    return NPTState(**{
        f.name: torch.as_tensor(np.array(state[f.name]), dtype=dtype,
                                device=device)
        for f in dataclasses.fields(NPTState)})


def nvt_state_from_numpy(state: dict, dtype=torch.float64) -> NVTState:
    """The port's NVTState from a numpy copy of the JAX NVTState's eta_dot
    (rot_scale2, nvt/sphere's, is not read): a host array of the run's
    dtype."""
    return NVTState(eta_dot=np.array(state["eta_dot"],
                                     dtype=chain_dtype(dtype)))


# the integer and bool fields of the bonded params and ShakeParams
_INDEX_FIELDS = ("idx", "btype", "atype", "dtype_", "itype", "type_",
                 "ptype", "atoms", "cpairs")


def bonded_from_numpy(cls, d: dict, device="cuda", dtype=torch.float64):
    """One of the port's ops.bonded BondParams, AngleParams,
    DihedralParams, ImproperParams or ops.shake.ShakeParams (`cls`) from a
    numpy copy of the JAX one: index fields as long, masks as bool, tables
    in `dtype`, scalars as Python scalars; fields the JAX one leaves None
    stay None."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    kw = {}
    for fld in dataclasses.fields(cls):
        v = _given(d, fld.name)
        if v is None:
            continue
        a = np.asarray(v)
        if a.ndim == 0 or isinstance(v, str):
            kw[fld.name] = _scalar(v)
        elif fld.name in _INDEX_FIELDS:
            kw[fld.name] = torch.as_tensor(a, dtype=torch.long,
                                           device=device)
        elif a.dtype == bool:
            kw[fld.name] = torch.as_tensor(a, device=device)
        else:
            kw[fld.name] = torch.as_tensor(a, dtype=dtype, device=device)
    for k in ("dtv", "dtfsq", "qqrd2e", "tolerance"):
        if k in kw:
            kw[k] = float(kw[k])
    return cls(**kw)


def eam_from_numpy(d: dict, device="cuda"):
    """The port's ops.eam EAMParams (funcfl) or EAMAlloyParams (setfl,
    where `d` has seg_rho) from a numpy copy of the JAX one: the tables
    and the 0-d scalars (cut, cutsq, drho, rhomax) as tensors in the
    tables' dtype, type2elem as int64, the static fields as Python
    scalars."""
    from lidp_tpu_torch import resolve_device
    from lidp_tpu_torch.ops.eam import EAMAlloyParams, EAMParams

    device = resolve_device(device)
    cls = EAMAlloyParams if _given(d, "seg_rho") is not None else EAMParams
    tab = np.asarray(d["frho_spline"])
    kw = {}
    for fld in dataclasses.fields(cls):
        a = np.array(d[fld.name])
        if fld.name == "type2elem":
            kw[fld.name] = torch.as_tensor(a, dtype=torch.long,
                                           device=device)
        elif fld.type in ("int", "bool"):
            kw[fld.name] = _scalar(a)
        else:
            kw[fld.name] = torch.as_tensor(a, dtype=_np_dtype(tab),
                                           device=device)
    return cls(**kw)
