"""Carry force-field tables across from the JAX package.

The caller hands over the fields of lidp_tpu's PairParams, EwaldParams and
PolarizationSettings as numpy arrays or scalars, e.g.
`{f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}`,
so both packages compute from the same tables.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.ops.ewald import EwaldParams
from lidp_tpu_torch.ops.pair import PairParams
from lidp_tpu_torch.ops.polarization import PolarizationSettings


def _scalar(v):
    """numpy 0-d array or Python scalar -> Python scalar (None stays)."""
    if v is None:
        return None
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a


def forcefield_from_numpy(pair: dict, ewald: dict, polar: dict, qqrd2e,
                          device="cuda", dtype=torch.float32) -> ForceField:
    """The port's ForceField from numpy copies of the JAX dataclasses.

    Only the lj/cut/coul/long pair form is supported in this slice; a
    table that asks for another form raises."""
    from lidp_tpu_torch import resolve_device

    device = resolve_device(device)
    unsupported = dict(charmm=False, charmm_fsw=False, kind="lj",
                       coul_kind="long", excl=None, excl_mol=False, lj5=None,
                       tab_e=None)
    for k, want in unsupported.items():
        if k in pair and _scalar(pair[k]) != want:
            raise NotImplementedError(
                f"pair field {k}={_scalar(pair[k])!r} is not ported")

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    pp = PairParams(
        **{k: t(pair[k]) for k in ("lj3", "lj4", "offset", "cut_ljsq",
                                   "cutsq", "special_lj", "special_coul")},
        cut_coulsq=float(_scalar(pair["cut_coulsq"])),
        qqrd2e=float(_scalar(pair["qqrd2e"])),
        g_ewald=float(_scalar(pair["g_ewald"])),
        coul=bool(_scalar(pair.get("coul", True))))
    ew = None
    if ewald is not None:
        ew = EwaldParams(
            hvecs=t(ewald["hvecs"]), kcoeff=t(ewald["kcoeff"]),
            kvirial=t(ewald["kvirial"]),
            **{k: float(_scalar(ewald[k]))
               for k in ("g_ewald", "qscale", "qsum", "qsqsum")})
    s = None
    if polar is not None:
        names = {f.name for f in dataclasses.fields(PolarizationSettings)}
        s = PolarizationSettings(**{k: _scalar(v) for k, v in polar.items()
                                    if k in names})
    return ForceField(pair=pp, ewald=ew, polar=s, qqrd2e=float(qqrd2e))
