"""Dissipative particle dynamics, pair_style dpd and dpd/tstat
(lidp_tpu/ops/dpd.py; pair_dpd.cpp, pair_dpd_tstat.cpp).

F_ij = a0 wd r^ - gamma wd^2 (r^.v_ij) r^ + sigma wd theta_ij dtinvsqrt r^,
wd = 1 - r/rc, sigma = sqrt(2 kB T gamma) (pair_dpd.cpp:135-152 and
init_one:236), on (N,N) tensors: the dense route takes DPD at every size,
as the JAX package does.

theta is the JAX package's counter-based noise, not LAMMPS's serial
RanMars stream: one normal (N,N) matrix drawn from fold_in(PRNGKey(seed),
step) by threefry.normal (the bits of jax.random.normal; its erfinv is
torch's), symmetrized as (A + A^T)/sqrt(2), so theta_ij == theta_ji to
the bit and the pair forces obey Newton's third law exactly.  The
matrix's shape is the System's atom count, padding included, as JAX draws
it on its System.
"""

from __future__ import annotations

import dataclasses

import torch

from lidp_tpu_torch import threefry
from lidp_tpu_torch.box import minimum_image


@dataclasses.dataclass(frozen=True)
class DPDParams:
    a0: torch.Tensor        # (T+1,T+1); zero for dpd/tstat
    gamma: torch.Tensor     # (T+1,T+1)
    sigma: torch.Tensor     # (T+1,T+1) sqrt(2 kB T gamma)
    cut: torch.Tensor       # (T+1,T+1), 1 where no cutoff is set
    cutsq: torch.Tensor     # (T+1,T+1)
    special_lj: torch.Tensor   # (4,) the special factors of the force
    dtinvsqrt: float        # 1/sqrt(dt)
    seed: int = 1
    tstat: bool = False


def dpd_noise(seed: int, step: int, n: int, dtype, device):
    """The symmetric (n,n) noise matrix of `step`: the JAX package's
    jax.random.normal(fold_in(PRNGKey(seed), step), (n, n)) A, then (A +
    A^T) / sqrt(2)."""
    key = threefry.fold_in(threefry.prng_key(seed), int(step))
    a = threefry.normal(key, (n, n), dtype=dtype, device=device)
    return (a + a.T) * (1.0 / torch.sqrt(torch.tensor(2.0, dtype=dtype,
                                                      device=device)))


def dpd_forces(x, v, type_, mask, box, p: DPDParams, step, sp_code=None,
               need_ev: bool = True):
    """(f, evdwl, virial6) of the DPD pairs at `step` on the dense (N,N)
    pass: evdwl the conservative energy 0.5 a0 rc wd^2 (zero at the
    cutoff, pair_dpd.cpp:165-168; none under dpd/tstat), sp_code the (N,N)
    special codes or None."""
    dtype = x.dtype
    n = x.shape[0]
    # every dimension folded, as the JAX function does (box.lengths)
    L = box.lengths
    dx = minimum_image(x[:, 0:1] - x[None, :, 0], L[0])
    dy = minimum_image(x[:, 1:2] - x[None, :, 1], L[1])
    dz = minimum_image(x[:, 2:3] - x[None, :, 2], L[2])
    rsq = dx * dx + dy * dy + dz * dz
    ti, tj = type_.long()[:, None], type_.long()[None, :]
    ar = torch.arange(n, device=x.device)
    pm = mask[:, None] & mask[None, :] & (ar[:, None] != ar[None, :])
    inr = pm & (rsq < p.cutsq[ti, tj]) & (rsq > 1e-20)
    r = torch.sqrt(torch.where(inr, rsq, 1.0))
    rinv = 1.0 / r
    dot = (dx * (v[:, 0:1] - v[None, :, 0])
           + dy * (v[:, 1:2] - v[None, :, 1])
           + dz * (v[:, 2:3] - v[None, :, 2]))
    cut = p.cut[ti, tj]
    wd = 1.0 - r / cut
    theta = dpd_noise(p.seed, step, n, dtype, x.device)
    fpair = (p.a0[ti, tj] * wd - p.gamma[ti, tj] * wd * wd * dot * rinv
             + p.sigma[ti, tj] * wd * theta * p.dtinvsqrt)
    if sp_code is not None:
        fpair = fpair * p.special_lj[sp_code.long()]
    fpair = torch.where(inr, fpair * rinv, 0.0)
    f = torch.stack([torch.sum(fpair * dx, dim=1),
                     torch.sum(fpair * dy, dim=1),
                     torch.sum(fpair * dz, dim=1)], dim=-1)
    evdwl = x.new_zeros(())
    vir = x.new_zeros(6)
    if need_ev:
        if not p.tstat:
            ew = 0.5 * p.a0[ti, tj] * cut * wd * wd
            if sp_code is not None:
                ew = ew * p.special_lj[sp_code.long()]
            evdwl = 0.5 * torch.sum(torch.where(inr, ew, 0.0))
        vir = 0.5 * torch.stack([
            torch.sum(fpair * dx * dx), torch.sum(fpair * dy * dy),
            torch.sum(fpair * dz * dz), torch.sum(fpair * dx * dy),
            torch.sum(fpair * dx * dz), torch.sum(fpair * dy * dz)])
    return f, evdwl, vir
