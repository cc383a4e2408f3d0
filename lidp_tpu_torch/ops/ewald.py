"""Reciprocal-space Ewald summation setup (lidp_tpu/ops/ewald.py).

The k-space setup is host-side numpy, copied from the JAX package so the
port depends on nothing of it: g_ewald estimate (ewald_disp.cpp:188-203),
per-dimension kmax from the RMS error bound (ewald_disp.cpp:255-331) and
the half-space k enumeration (ewald_disp.cpp:333-355).  Orthogonal boxes
only.  `ewald_forces` is the dense route's sum, [N,K] matmuls blocked over
k past _EWALD_CHUNK_ELEMS; the panel engine's lives in parallel/shard.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MY_PIS = math.sqrt(math.pi)


@dataclasses.dataclass(frozen=True)
class EwaldSetup:
    """Host-side (static) k-space configuration."""

    g_ewald: float
    hvecs: np.ndarray    # (K,3) wave vectors (2*pi*k_int/L), half space
    kcoeff: np.ndarray   # (K,) exp(-h^2/(4g^2))/h^2
    kvirial: np.ndarray  # (K,6) virial coefficients (xx yy zz xy xz yz)
    qsum: float
    qsqsum: float


def estimate_g_ewald(accuracy_rel: float, qqrd2e: float, qsqsum: float,
                     natoms: int, cutoff: float, volume: float) -> float:
    """Charge-function g_ewald (ewald_disp.cpp:188-203)."""
    accuracy = accuracy_rel * qqrd2e
    q2 = qsqsum * qqrd2e
    if q2 == 0.0:
        raise ValueError("Must use kspace_modify gewald for uncharged system")
    g = accuracy * math.sqrt(natoms * cutoff * volume) / (2.0 * q2)
    if g >= 1.0:
        return (1.35 - 0.15 * math.log(accuracy)) / cutoff
    return math.sqrt(-math.log(g)) / cutoff


def _rms_charge(km: int, prd: float, natoms: int, q2: float,
                g_ewald: float) -> float:
    g2 = g_ewald * g_ewald
    return (2.0 * q2 * g_ewald / prd
            * math.sqrt(1.0 / (math.pi * km * natoms))
            * math.exp(-math.pi**2 * km * km / (g2 * prd * prd)))


def setup_ewald_disp(*, accuracy_rel: float, qqrd2e: float, q: np.ndarray,
                     natoms: int, cutoff: float, box_lengths,
                     g_ewald: float | None = None) -> EwaldSetup:
    """K-space setup for an orthogonal box, following EwaldDisp exactly.
    g_ewald: the value `kspace_modify gewald` sets, in place of the
    estimate; kmax follows from it as from the estimate."""
    Lx, Ly, Lz = (float(v) for v in box_lengths)
    volume = Lx * Ly * Lz
    qsum = float(np.sum(q))
    qsqsum = float(np.sum(np.asarray(q) ** 2))
    accuracy = accuracy_rel * qqrd2e
    q2 = qsqsum * qqrd2e
    if g_ewald is None:
        g_ewald = estimate_g_ewald(accuracy_rel, qqrd2e, qsqsum, natoms,
                                   cutoff, volume)

    kmax = []
    for prd in (Lx, Ly, Lz):
        km = 1
        while _rms_charge(km, prd, natoms, q2, g_ewald) > accuracy:
            km += 1
        kmax.append(km)
    nbox = max(kmax)

    unit = 2.0 * math.pi / np.array([Lx, Ly, Lz])
    gsqmx = max(unit[d] ** 2 * kmax[d] ** 2 for d in range(3)) * 1.00001

    # half-space enumeration, same order/symmetry rules as reallocate()
    hvecs = []
    for ix in range(0, nbox + 1):
        for iy in range(-nbox, nbox + 1):
            for iz in range(-nbox, nbox + 1):
                if ix == 0 and (iy < 0 or (iy == 0 and iz <= 0)):
                    continue
                h_ = (unit[0] * ix, unit[1] * iy, unit[2] * iz)
                if h_[0] ** 2 + h_[1] ** 2 + h_[2] ** 2 <= gsqmx:
                    hvecs.append(h_)
    hvecs = np.array(hvecs, np.float64).reshape(-1, 3)

    eta2 = 0.25 / (g_ewald * g_ewald)
    h2 = np.sum(hvecs**2, axis=1)
    b2 = h2 * eta2
    c1 = np.exp(-b2) / h2
    c2 = 2.0 * c1 * (1.0 + b2) / h2
    kvirial = np.stack([
        c1 - c2 * hvecs[:, 0] * hvecs[:, 0],
        c1 - c2 * hvecs[:, 1] * hvecs[:, 1],
        c1 - c2 * hvecs[:, 2] * hvecs[:, 2],
        -c2 * hvecs[:, 1] * hvecs[:, 0],
        -c2 * hvecs[:, 2] * hvecs[:, 0],
        -c2 * hvecs[:, 2] * hvecs[:, 1],
    ], axis=1)

    return EwaldSetup(g_ewald=float(g_ewald), hvecs=hvecs, kcoeff=c1,
                      kvirial=kvirial, qsum=qsum, qsqsum=qsqsum)


@dataclasses.dataclass(frozen=True)
class EwaldParams:
    """Device-side k-space tables; scalars stay Python floats."""

    hvecs: torch.Tensor    # (K,3)
    kcoeff: torch.Tensor   # (K,)
    kvirial: torch.Tensor  # (K,6)
    g_ewald: float
    qscale: float          # qqrd2e * scale
    qsum: float
    qsqsum: float

    @staticmethod
    def from_setup(s: EwaldSetup, qqrd2e: float, dtype=torch.float64,
                   device="cpu") -> "EwaldParams":
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return EwaldParams(hvecs=t(s.hvecs), kcoeff=t(s.kcoeff),
                           kvirial=t(s.kvirial), g_ewald=float(s.g_ewald),
                           qscale=float(qqrd2e), qsum=float(s.qsum),
                           qsqsum=float(s.qsqsum))


def _ewald_kblock(x, q, hvecs, kcoeff, kvirial, c0):
    """Structure factors, energy, forces and virial of one k block
    (lidp_tpu/ops/ewald.py _ewald_kblock); per-k terms are independent,
    so blocks add."""
    phases = x @ hvecs.T                          # (N,Kb)
    c = torch.cos(phases)
    s = torch.sin(phases)
    sre = q @ c                                   # (Kb,)
    sim = q @ s
    sk2 = sre * sre + sim * sim
    e = c0 * torch.sum(kcoeff * sk2)
    w = kcoeff * sre * 2.0 * c0
    w2 = kcoeff * sim * 2.0 * c0
    coef = s * w[None, :] - c * w2[None, :]       # (N,Kb)
    f = (coef @ hvecs) * q[:, None]
    # only the per-k terms enter the virial (ewald.cpp:466-474)
    virial = c0 * (sk2 @ kvirial)
    return f, e, virial


# past this (N,K) working set the k axis is cut into blocks of
# _EWALD_CHUNK_ELEMS // N vectors (at least 128), summed in block order
_EWALD_CHUNK_ELEMS = 64_000_000


def ewald_forces(x, q, volume, p: EwaldParams):
    """Reciprocal-space forces, energy (less the self and background
    terms) and virial (lidp_tpu/ops/ewald.py ewald_forces): (f (N,3),
    elong (), virial6)."""
    c0 = 4.0 * math.pi * p.qscale / volume
    energy_self = (p.qsqsum * p.qscale * p.g_ewald / MY_PIS
                   + 0.5 * math.pi * p.qscale / (p.g_ewald**2 * volume)
                   * p.qsum * p.qsum)
    n = x.shape[0]
    K = p.hvecs.shape[0]
    if n * K <= _EWALD_CHUNK_ELEMS:
        f, e, virial = _ewald_kblock(x, q, p.hvecs, p.kcoeff, p.kvirial, c0)
        return f, e - energy_self, virial
    kb = max(128, _EWALD_CHUNK_ELEMS // max(n, 1))
    f = torch.zeros_like(x)
    e = x.new_zeros(())
    virial = x.new_zeros(6)
    for k0 in range(0, K, kb):
        # the JAX package pads the last block with zero coefficients; a
        # padded vector adds exactly zero, so the short block is the same
        fb, eb, vb = _ewald_kblock(x, q, p.hvecs[k0:k0 + kb],
                                   p.kcoeff[k0:k0 + kb],
                                   p.kvirial[k0:k0 + kb], c0)
        f, e, virial = f + fb, e + eb, virial + vb
    return f, e - energy_self, virial
