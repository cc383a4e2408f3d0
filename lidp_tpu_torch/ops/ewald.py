"""Reciprocal-space Ewald summation: ewald/disp's charge, dispersion and
point-dipole functions (lidp_tpu/ops/ewald.py).

The k-space setup is host-side numpy, copied from the JAX package so the
port depends on nothing of it: g_ewald estimate (ewald_disp.cpp:188-203),
per-dimension kmax from the RMS error bound (ewald_disp.cpp:255-331) and
the half-space k enumeration (ewald_disp.cpp:333-355), with the integer
indices that `rescale_coeffs` rescales to a barostat's live box.
Orthogonal boxes only.  `ewald_forces` is the dense route's sum, [N,K]
matmuls blocked over k past _EWALD_CHUNK_ELEMS; the panel engine's lives
in parallel/shard.py.  The dispersion function (`setup_dispersion`,
`ewald6_forces`, `dispersion_real`) and the point-dipole function
(`ewald_dipole_forces`, `dipole_real`; a library function no script
reaches) follow; their [N,K] sums are unblocked, as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

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
    kints: np.ndarray = None  # (K,3) integer indices of hvecs


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
    kints = []
    for ix in range(0, nbox + 1):
        for iy in range(-nbox, nbox + 1):
            for iz in range(-nbox, nbox + 1):
                if ix == 0 and (iy < 0 or (iy == 0 and iz <= 0)):
                    continue
                h_ = (unit[0] * ix, unit[1] * iy, unit[2] * iz)
                if h_[0] ** 2 + h_[1] ** 2 + h_[2] ** 2 <= gsqmx:
                    hvecs.append(h_)
                    kints.append((ix, iy, iz))
    hvecs = np.array(hvecs, np.float64).reshape(-1, 3)
    kints = np.array(kints, np.int32).reshape(-1, 3)

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
                      kvirial=kvirial, qsum=qsum, qsqsum=qsqsum, kints=kints)


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
    # (K,3) the integer indices of hvecs, in the tables' dtype, for
    # rescale_coeffs; None where the setup gave none
    kints: Optional[torch.Tensor] = None

    @staticmethod
    def from_setup(s: EwaldSetup, qqrd2e: float, dtype=torch.float64,
                   device="cpu") -> "EwaldParams":
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return EwaldParams(hvecs=t(s.hvecs), kcoeff=t(s.kcoeff),
                           kvirial=t(s.kvirial), g_ewald=float(s.g_ewald),
                           qscale=float(qqrd2e), qsum=float(s.qsum),
                           qsqsum=float(s.qsqsum),
                           kints=None if s.kints is None else t(s.kints))


def rescale_coeffs(p: EwaldParams, box_lengths) -> EwaldParams:
    """The box-dependent k-space tables recomputed for the live box
    lengths (lidp_tpu/ops/ewald.py rescale_coeffs; the analog of
    force->kspace->setup() after a barostat's box change,
    fix_nh.cpp:877).  The integer k set stays the one enumerated at
    setup."""
    dtype = p.hvecs.dtype
    unit = 2.0 * math.pi / box_lengths.to(dtype)
    hvecs = p.kints * unit[None, :]
    eta2 = 0.25 / (p.g_ewald * p.g_ewald)
    h2 = torch.sum(hvecs * hvecs, dim=1)
    b2 = h2 * eta2
    c1 = torch.exp(-b2) / h2
    c2 = 2.0 * c1 * (1.0 + b2) / h2
    kvirial = torch.stack([
        c1 - c2 * hvecs[:, 0] * hvecs[:, 0],
        c1 - c2 * hvecs[:, 1] * hvecs[:, 1],
        c1 - c2 * hvecs[:, 2] * hvecs[:, 2],
        -c2 * hvecs[:, 1] * hvecs[:, 0],
        -c2 * hvecs[:, 2] * hvecs[:, 0],
        -c2 * hvecs[:, 2] * hvecs[:, 1],
    ], dim=1)
    return dataclasses.replace(p, hvecs=hvecs, kcoeff=c1, kvirial=kvirial)


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


# --------------------- dispersion (geometric 1/r^6) -------------------------
#
# EwaldDisp function[1] (lidp_tpu/ops/ewald.py :283-476): long-range
# Lennard-Jones dispersion with geometric mixing.  The per-atom coefficient
# B_i = sqrt(B_ii), B_ij = 4 eps_ij sigma_ij^6 (init_coeffs,
# ewald_disp.cpp:497): geometric mixing makes B_ij == B_i B_j, so
# S6(k) = sum_i B_i e^{ik.r} carries the whole pair structure.  The setup
# is host numpy, as in the JAX package; the sums are [N,K] matmuls.


@dataclasses.dataclass(frozen=True)
class Ewald6Setup:
    g6: float
    nbox: int
    hvecs: np.ndarray     # (K,3)
    kcoeff6: np.ndarray   # (K,)
    kvirial6: np.ndarray  # (K,6)
    bsum: float           # sum_i B_i
    bsbsum: float         # sum_i B_i^2
    volume: float


def newton_g6(accuracy: float, bsbsum: float, natoms: int, cutoff: float,
              volume: float) -> float:
    """g_ewald_6 by the Newton solve of EwaldDisp::NewtonSolve + f
    (ewald_disp.cpp:1459-1504); the old-method guess where it fails
    (:216-221)."""
    x = (1.35 - 0.15 * math.log(accuracy)) / cutoff   # initial guess

    def f(xv):
        a = cutoff * xv
        return (4.0 * math.pi * bsbsum * xv**4 / volume
                / math.sqrt(float(natoms)) * math.erfc(a)
                * (6.0 * a**-5 + 6.0 * a**-3 + 3.0 / a + a) - accuracy)

    g = x
    for _ in range(10000):
        h = 1.0e-6
        df = (f(g + h) - f(g)) / h
        dx = f(g) / df
        g = g - dx
        if abs(dx) < 1.0e-5:
            return g
        if g < 0 or g != g:
            break
    return x


def _rms_lj(km: int, prd: float, natoms: int, b2: float, g6: float) -> float:
    """The LJ term of EwaldDisp::rms."""
    g2 = g6 * g6
    g7 = g2 * g2 * g2 * g6
    return (4.0 * b2 * g7 / 3.0
            * math.sqrt(1.0 / (math.pi * natoms))
            * math.exp(-math.pi**2 * km * km / (g2 * prd * prd))
            * (math.pi * km / (g6 * prd) + 1.0))


def setup_dispersion(*, accuracy_rel: float, qqrd2e: float, b_atom,
                     natoms: int, cutoff: float, box_lengths,
                     g6: float | None = None) -> Ewald6Setup:
    """K-space setup of the geometric-dispersion function: g6 by
    newton_g6 unless given, kmax per dimension from the LJ RMS bound, the
    half-space enumeration of setup_ewald_disp and the coefficients()
    func12 branch (ewald_disp.cpp:469-478).  b_atom: the per-atom
    B_i = sqrt(4 eps_ii sigma_ii^6)."""
    Lx, Ly, Lz = (float(v) for v in box_lengths)
    volume = Lx * Ly * Lz
    b_atom = np.asarray(b_atom, float)
    bsum = float(np.sum(b_atom))
    bsbsum = float(np.sum(b_atom**2))
    accuracy = accuracy_rel * qqrd2e   # two_charge_force (kspace.cpp)
    if g6 is None:
        g6 = newton_g6(accuracy, bsbsum, natoms, cutoff, volume)

    kmax = []
    for prd in (Lx, Ly, Lz):
        km = 1
        while _rms_lj(km, prd, natoms, bsbsum, g6) > accuracy:
            km += 1
        kmax.append(km)
    nbox = max(kmax)

    unit = 2.0 * math.pi / np.array([Lx, Ly, Lz])
    gsqmx = max(unit[d] ** 2 * kmax[d] ** 2 for d in range(3)) * 1.00001
    hvecs = []
    for ix in range(0, nbox + 1):
        for iy in range(-nbox, nbox + 1):
            for iz in range(-nbox, nbox + 1):
                if ix == 0 and (iy < 0 or (iy == 0 and iz <= 0)):
                    continue
                h = (unit[0] * ix, unit[1] * iy, unit[2] * iz)
                if h[0] ** 2 + h[1] ** 2 + h[2] ** 2 <= gsqmx:
                    hvecs.append(h)
    hvecs = np.array(hvecs, np.float64).reshape(-1, 3)

    h2 = np.sum(hvecs**2, axis=1)
    h1 = np.sqrt(h2)
    eta2 = 0.25 / (g6 * g6)
    b2k = h2 * eta2
    b1 = np.sqrt(b2k)
    expb2 = np.exp(-b2k)
    erfcb = np.array([math.erfc(v) for v in b1])
    c2e = MY_PIS * erfcb
    ke6 = -h1 * h2 * (c2e + (0.5 / b2k - 1.0) * expb2 / b1)
    c2v = 3.0 * h1 * (c2e - expb2 / b1)
    kvirial6 = np.stack([
        ke6 - c2v * hvecs[:, 0] * hvecs[:, 0],
        ke6 - c2v * hvecs[:, 1] * hvecs[:, 1],
        ke6 - c2v * hvecs[:, 2] * hvecs[:, 2],
        -c2v * hvecs[:, 1] * hvecs[:, 0],
        -c2v * hvecs[:, 2] * hvecs[:, 0],
        -c2v * hvecs[:, 2] * hvecs[:, 1],
    ], axis=1)
    return Ewald6Setup(g6=float(g6), nbox=nbox, hvecs=hvecs, kcoeff6=ke6,
                       kvirial6=kvirial6, bsum=bsum, bsbsum=bsbsum,
                       volume=volume)


@dataclasses.dataclass(frozen=True)
class Ewald6Params:
    """The device tables of an Ewald6Setup (the same attribute names, so
    ewald6_forces takes either); scalars stay Python floats."""

    hvecs: torch.Tensor
    kcoeff6: torch.Tensor
    kvirial6: torch.Tensor
    g6: float = 1.0
    bsum: float = 0.0
    bsbsum: float = 0.0

    @staticmethod
    def from_setup(s: Ewald6Setup, dtype=torch.float64,
                   device="cpu") -> "Ewald6Params":
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return Ewald6Params(hvecs=t(s.hvecs), kcoeff6=t(s.kcoeff6),
                            kvirial6=t(s.kvirial6), g6=float(s.g6),
                            bsum=float(s.bsum), bsbsum=float(s.bsbsum))


def ewald6_forces(x, b_atom, volume, s):
    """Reciprocal-space dispersion (f (N,3), edisp (), virial6) of the
    geometric mixing, compute_energy/compute_force/compute_virial func[1]
    (ewald_disp.cpp:964,840-884,1100-1109) as [N,K] matmuls.  s: an
    Ewald6Setup or Ewald6Params."""
    dtype, dev = x.dtype, x.device

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    hv, ke6, kv6, b = t(s.hvecs), t(s.kcoeff6), t(s.kvirial6), t(b_atom)
    phases = x @ hv.T
    c = torch.cos(phases)
    sn = torch.sin(phases)
    sre = b @ c
    sim = b @ sn
    sk2 = sre * sre + sim * sim

    g3 = s.g6 ** 3
    c_e = 2.0 * math.pi * MY_PIS / (24.0 * volume)
    c_f = 2.0 * math.pi * MY_PIS / (12.0 * volume)
    virial_self = math.pi * MY_PIS * g3 / (6.0 * volume) * s.bsum * s.bsum
    energy_self = -s.bsbsum * g3 * g3 / 12.0 + virial_self
    edisp = c_e * torch.sum(ke6 * sk2) - energy_self

    w = ke6 * sre * c_f
    w2 = ke6 * sim * c_f
    coef = sn * w[None, :] - c * w2[None, :]
    f = (coef @ hv) * b[:, None]

    virial = c_e * (sk2 @ kv6)
    virial = virial - virial_self * t([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    return f, edisp, virial


def dispersion_real(rsq, bij, g6: float):
    """The real-space damped dispersion complement
    (pair_lj_long_coul_long.cpp:525-533): (e, force * r) of -B_ij r^-6
    with its k-space part removed."""
    g2 = g6 * g6
    gg6 = g2 * g2 * g2
    g8 = gg6 * g2
    x2 = g2 * rsq
    a2 = 1.0 / x2
    x2e = a2 * torch.exp(-x2) * bij
    e = -gg6 * ((a2 + 1.0) * a2 + 0.5) * x2e
    force = -g8 * (((6.0 * a2 + 6.0) * a2 + 3.0) * a2 + 1.0) * x2e * rsq
    return e, force


# ------------------------- point-dipole function ---------------------------
#
# EwaldDisp function[3] (lidp_tpu/ops/ewald.py :479-528): the
# reciprocal-space sum of point dipoles, S_mu(k) = sum_i (mu_i . k)
# e^{ik.r_i}, with the charge function's coefficients e^{-k^2/4g^2}/k^2
# (coefficients() func3 branch, :479-487) and the self energy
# 2 g^3 / (3 sqrt(pi)) sum |mu|^2 (:597-599).  A library function: no
# script reaches it, in the JAX package or here.


def ewald_dipole_forces(x, mu, volume, s, scale=1.0):
    """Reciprocal-space dipole (f (N,3), edipole ()) as [N,K] matmuls on
    the charge function's k set and coefficients of `s` (an EwaldSetup or
    EwaldParams; the reference shares one k enumeration across
    functions).  scale: mumurd2e."""
    dtype, dev = x.dtype, x.device
    hv = torch.as_tensor(s.hvecs, dtype=dtype, device=dev)
    ke = torch.as_tensor(s.kcoeff, dtype=dtype, device=dev)
    phases = x @ hv.T                    # (N,K)
    c = torch.cos(phases)
    sn = torch.sin(phases)
    P = mu @ hv.T                        # (N,K) mu_i . k
    sre = torch.sum(P * c, dim=0)        # (K,)
    sim = torch.sum(P * sn, dim=0)
    sk2 = sre * sre + sim * sim

    g = s.g_ewald
    c0 = 4.0 * math.pi * scale / volume
    e_self = 2.0 * g**3 / (3.0 * MY_PIS) * scale * torch.sum(mu * mu)
    edip = c0 * torch.sum(ke * sk2) - e_self

    w = ke * sre * 2.0 * c0
    w2 = ke * sim * 2.0 * c0
    coef = (sn * w[None, :] - c * w2[None, :]) * P   # (N,K)
    return coef @ hv, edip


def dipole_real(rvec, mui, muj, g: float):
    """The real-space erfc-damped dipole-dipole pair energy, the
    complement of ewald_dipole_forces:
    E = B(r) mu_i.mu_j - C(r) (mu_i.r)(mu_j.r), with torch.special.erfc
    where the JAX function calls jax.scipy.special.erfc."""
    r2 = torch.sum(rvec * rvec, dim=-1)
    r = torch.sqrt(r2)
    gr = g * r
    erfc_gr = torch.special.erfc(gr)
    pref = 2.0 * gr / MY_PIS * torch.exp(-gr * gr)
    B = (erfc_gr + pref) / (r2 * r)
    C = (3.0 * erfc_gr + pref * (3.0 + 2.0 * gr * gr)) / (r2 * r2 * r)
    pdotp = torch.sum(mui * muj, dim=-1)
    pir = torch.sum(mui * rvec, dim=-1)
    pjr = torch.sum(muj * rvec, dim=-1)
    return B * pdotp - C * pir * pjr
