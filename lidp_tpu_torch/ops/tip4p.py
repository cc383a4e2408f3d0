"""TIP4P off-site charge coulomb (pair_style lj/cut/tip4p/long,
lj/cut/tip4p/cut, tip4p/long, tip4p/cut and lj/long/tip4p/long, with
pppm/tip4p and pppm/disp/tip4p; lidp_tpu/ops/tip4p.py).

The reference's TIP4P machinery (pair_lj_cut_tip4p_long.cpp):

  * the water oxygen's charge acts at the massless M site
    xM = xO + alpha/2 ((xH1 - xO) + (xH2 - xO)) (compute_newsite,
    :478-494), alpha = qdist / (cos(theta0/2) r0) (init_style, :471-474);
  * LJ acts between the real atoms, coulomb between the charge sites
    (compute, :190-240);
  * a force on an M site goes onto O, H1, H2 as fO = (1 - alpha) fM,
    fH = alpha/2 fM (:321-327); the k-space term evaluates at the M sites
    and redistributes alike (pppm_tip4p.cpp particle_map/fieldforce).

The redistribution weights sum to 1, so the global virial of a
charge-site pair is r_MM' (x) f_pair, tallied on the charge-site
separations with no correction term.  H1/H2 are the atoms of tags O+1 and
O+2, found once from the topology (:146-152).  `redistribute` is a gather:
each H row reads the force of its own O through an index built once, so
it adds no float scatter and repeats bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch.box import minimum_image
from lidp_tpu_torch.ops.pair import EWALD_F, erfc_as


@dataclasses.dataclass(frozen=True)
class TIP4PParams:
    h1: torch.Tensor      # (N,) long, first H of an O (self elsewhere)
    h2: torch.Tensor      # (N,) long, second H
    is_o: torch.Tensor    # (N,) bool
    # (N,) long: an H atom's O (self for every other atom), the gather
    # index of redistribute
    o_of: torch.Tensor
    is_h: torch.Tensor    # (N,) bool: an H of some O
    alpha: float          # qdist / (cos(theta0/2) r0)


def make_tip4p_params(type_, tags, type_o: int, type_h: int, alpha: float,
                      device="cpu") -> TIP4PParams:
    """The H1/H2 indices of each O (the atoms of tag O+1 and O+2,
    pair_lj_cut_tip4p_long.cpp:146-152 atom->map(tag[i]+1)) and each H's
    O, from host arrays; raises as the JAX function does where a hydrogen
    is missing or of another type."""
    type_ = np.asarray(type_)
    tags = np.asarray(tags)
    n = type_.shape[0]
    tag_to_idx = {int(t): i for i, t in enumerate(tags)}
    h1 = np.arange(n)
    h2 = np.arange(n)
    o_of = np.arange(n)
    is_h = np.zeros(n, bool)
    is_o = type_ == type_o
    for i in np.nonzero(is_o)[0]:
        j1 = tag_to_idx.get(int(tags[i]) + 1)
        j2 = tag_to_idx.get(int(tags[i]) + 2)
        if j1 is None or j2 is None:
            raise ValueError("TIP4P hydrogen is missing")
        if type_[j1] != type_h or type_[j2] != type_h:
            raise ValueError("TIP4P hydrogen has incorrect atom type")
        h1[i], h2[i] = j1, j2
        o_of[j1] = o_of[j2] = i
        is_h[j1] = is_h[j2] = True

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    return TIP4PParams(h1=t(h1, torch.long), h2=t(h2, torch.long),
                       is_o=t(is_o, torch.bool), o_of=t(o_of, torch.long),
                       is_h=t(is_h, torch.bool), alpha=float(alpha))


def charge_sites(x, box, tp: TIP4PParams):
    """Each atom's charge site: M for an O, x elsewhere (compute_newsite
    with the closest-image H displacements, :156-158)."""
    L = box.img_lengths
    d1 = minimum_image(x[tp.h1] - x, L)
    d2 = minimum_image(x[tp.h2] - x, L)
    shift = tp.alpha * 0.5 * (d1 + d2)
    return x + torch.where(tp.is_o[:, None], shift, 0.0)


def redistribute(f_cs, tp: TIP4PParams):
    """The force map from the charge sites onto the real atoms
    (fO = (1 - alpha) fM, fH += alpha/2 fM, :321-327), by a gather: an H
    row adds half alpha of its O's site force, every other row passes
    through (an H's own site force included)."""
    fm = torch.where(tp.is_o[:, None], f_cs, 0.0)
    f = f_cs - tp.alpha * fm
    return f + torch.where(tp.is_h[:, None], 0.5 * tp.alpha * fm[tp.o_of],
                           0.0)


def tip4p_coul_dense(x, q, sp_code, mask, box, cut_coulsq, g_ewald, qqrd2e,
                     special_coul, tp: TIP4PParams, mode="long"):
    """The dense (N,N) real-space coulomb between the charge sites:
    (f on the charge sites (N,3), ecoul, virial6); the caller
    redistributes the forces.

    mode "long": the erfc-damped Ewald real space
    (pair_lj_cut_tip4p_long.cpp / pair_tip4p_long.cpp), a special pair
    taking forcecoul -= (1 - factor) prefactor on the M-site separation
    (:263-268).  mode "cut": the bare cutoff coulomb with the
    multiplicative special factor (pair_tip4p_cut.cpp:211-214, :343;
    pair_lj_cut_tip4p_cut.cpp alike)."""
    xs = charge_sites(x, box, tp)
    n = x.shape[0]
    delta = minimum_image(xs[:, None, :] - xs[None, :, :], box.img_lengths)
    rsq = torch.sum(delta * delta, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    pair_mask = (~eye) & mask[:, None] & mask[None, :]
    rsq = torch.where(pair_mask, rsq, 1.0)

    if isinstance(sp_code, torch.Tensor):
        sp_code = sp_code.long()
    factor_coul = special_coul[sp_code]
    cm = pair_mask & (rsq < cut_coulsq)
    r = torch.sqrt(rsq)
    prefactor = qqrd2e * q[:, None] * q[None, :] / r
    if mode == "cut":
        forcecoul = factor_coul * prefactor
        ecoul = factor_coul * prefactor
    else:
        grij = g_ewald * r
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_as(grij, expm2)
        forcecoul = (prefactor * (erfc + EWALD_F * grij * expm2)
                     - (1.0 - factor_coul) * prefactor)
        ecoul = prefactor * erfc - (1.0 - factor_coul) * prefactor
    forcecoul = torch.where(cm, forcecoul, 0.0)
    ecoul = torch.where(cm, ecoul, 0.0)

    fpair = forcecoul / rsq
    f_cs = torch.sum(fpair[:, :, None] * delta, dim=1)
    w = 0.5 * fpair
    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    virial = torch.stack([
        torch.sum(w * dx * dx), torch.sum(w * dy * dy),
        torch.sum(w * dz * dz), torch.sum(w * dx * dy),
        torch.sum(w * dx * dz), torch.sum(w * dy * dz)])
    return f_cs, 0.5 * torch.sum(ecoul), virial
