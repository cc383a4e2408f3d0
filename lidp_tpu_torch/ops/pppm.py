"""PPPM (particle-particle particle-mesh) long-range electrostatics
(lidp_tpu/ops/pppm.py, the charge mesh: kspace_style pppm, pppm/cg and
pppm/stagger).

The mesh analog of the reference's KSPACE/pppm.cpp: order-P B-spline charge
assignment (compute_rho1d, pppm.cpp:2844), a 3D FFT of the charge grid
(torch.fft, the counterpart of the JAX package's jnp.fft), the
ik-differentiation Green's-function convolution with a 1/W(k)^2
deconvolution of the assignment function (the JAX package's form, not the
reference's optimal influence function of compute_gf_ik: ROADMAP queue 3),
and the interpolation of the fields back to the atoms.

`setup_pppm` is host Python, line for line the JAX package's, so both give
the same g_ewald and grid bit for bit.  `pppm_forces` is plain PyTorch in
the dtype of x (complex128 under float64, complex64 under float32).  The
spread is a scatter-add of N * P^3 weights (`index_add_`); on a GPU it adds
in the order the atomics land, so two evaluations of one state may differ
in the last bits there.  The grid stays the one chosen at setup; every
box-dependent factor (the k vectors, the Green's function, the
deconvolution, the volume) is formed from the box lengths of each call, so
the mesh follows a barostat's box.

pppm/disp's dispersion mesh (setup_pppm_disp, pppm_disp_forces) shares
the charge mesh's stencil, spread and mode lattice.  pppm/tip4p is the
charge mesh on the TIP4P charge sites (forcefield.py, ops/tip4p.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PPPMSetup:
    g_ewald: float
    grid: tuple
    order: int


# charge-assignment error constants, Deserno & Holm JCP 109, 7698 (1998)
# (pppm.cpp compute_acons); index [order][m]
_ACONS = {
    1: [2.0 / 3.0],
    2: [1.0 / 50.0, 5.0 / 294.0],
    3: [1.0 / 588.0, 7.0 / 1440.0, 21.0 / 3872.0],
    4: [1.0 / 4320.0, 3.0 / 1936.0, 7601.0 / 2271360.0, 143.0 / 28800.0],
    5: [1.0 / 23232.0, 7601.0 / 13628160.0, 143.0 / 69120.0,
        517231.0 / 106536960.0, 106640677.0 / 11737571328.0],
    6: [691.0 / 68140800.0, 13.0 / 57600.0, 47021.0 / 35512320.0,
        9694607.0 / 2095994880.0, 733191589.0 / 59609088000.0,
        326190917.0 / 11700633600.0],
    7: [1.0 / 345600.0, 3617.0 / 35512320.0, 745739.0 / 838397952.0,
        56399353.0 / 12773376000.0, 25091609.0 / 1560084480.0,
        1755948832039.0 / 36229939200000.0, 4887769399.0 / 37838389248.0],
}


def _ik_error(h, prd, natoms, g, order, q2):
    """estimate_ik_error (pppm.cpp): per-dim ik-differentiation RMS error."""
    s = sum(_ACONS[order][m] * (h * g) ** (2 * m) for m in range(order))
    return (q2 * (h * g) ** order
            * math.sqrt(g * prd * math.sqrt(2.0 * math.pi) * s / natoms)
            / (prd * prd))


def _factorable(n):
    for f in (2, 3, 5):
        while n % f == 0:
            n //= f
    return n == 1


def setup_pppm(*, accuracy_rel: float, qqrd2e: float, q, natoms: int,
               cutoff: float, box_lengths, order: int = 5,
               g_ewald: float | None = None) -> PPPMSetup:
    """Grid and g_ewald as PPPM::set_grid_global + adjust_gewald
    (pppm.cpp:985,1287, the ik-differentiation path): g from the Ewald
    formula (or the `kspace_modify gewald` value), each dimension's grid
    grown until the ik error bound meets the accuracy (with the
    reference's one-extra-step loop), raised to a 2/3/5-factorable size,
    then g solved by Newton so the real-space and k-space errors balance
    (not with an override)."""
    L = np.asarray(box_lengths, float)
    qsqsum = float(np.sum(np.asarray(q) ** 2))
    accuracy = accuracy_rel * qqrd2e      # two_charge_force (kspace.cpp)
    q2 = qsqsum * qqrd2e
    vol = float(np.prod(L))

    if g_ewald is None:
        g0 = accuracy * math.sqrt(natoms * cutoff * vol) / (2.0 * q2)
        if g0 >= 1.0:
            g = (1.35 - 0.15 * math.log(accuracy)) / cutoff
        else:
            g = math.sqrt(-math.log(g0)) / cutoff
    else:
        g = float(g_ewald)

    grid = []
    hs = []
    for prd in L:
        h = 1.0 / g                       # the first error uses h = 1/g
        n = int(prd / h) + 1
        err = _ik_error(h, prd, natoms, g, order, q2)
        while err > accuracy:
            err = _ik_error(h, prd, natoms, g, order, q2)
            n += 1
            h = prd / n
        while not _factorable(n):
            n += 1
        grid.append(n)
        hs.append(prd / n)

    if g_ewald is None:
        # adjust_gewald: df_rspace(g) == df_kspace(g) by Newton
        def f_of(gv):
            df_r = (2.0 * q2 * math.exp(-gv * gv * cutoff * cutoff)
                    / math.sqrt(natoms * cutoff * L[0] * L[1] * L[2]))
            lpr = [_ik_error(hs[d], L[d], natoms, gv, order, q2)
                   for d in range(3)]
            df_k = math.sqrt(sum(v * v for v in lpr)) / math.sqrt(3.0)
            return df_r - df_k

        for _ in range(80):
            dg = g * 1e-6
            deriv = (f_of(g + dg) - f_of(g)) / dg
            g -= f_of(g) / deriv
            if abs(f_of(g)) < 1e-5:
                break

    return PPPMSetup(g_ewald=float(g), grid=tuple(grid), order=order)


def _bspline(x, n):
    """M_n(x) on its support [0, n], by the recursion of the JAX package's
    _assignment_weights, M_n(x) = (x M_{n-1}(x) + (n - x) M_{n-1}(x - 1))
    / (n - 1), with each M_m(x - k) formed once (the JAX package's
    recursion forms them 2^(n-1) times over): the argument x - k is x less
    1.0 k times on every path of that recursion, so the values are its
    bits, in n (n + 1) / 2 nodes."""
    args = [x]
    for _ in range(n - 1):
        args.append(args[-1] - 1.0)
    # level m = 1: the box function at each shift k = 0..n-1
    level = [torch.where((a >= 0) & (a < 1), 1.0, 0.0).to(x.dtype)
             for a in args]
    for m in range(2, n + 1):
        level = [(args[k] * level[k] + (m - args[k]) * level[k + 1])
                 / (m - 1) for k in range(n - m + 1)]
    return level[0]


def _assignment_weights(frac, order):
    """Order-P charge assignment weights (..., P) of the fractional offsets
    frac (...) in [0, 1): the centred B-spline at each grid offset
    (equivalent to the reference's compute_rho_coeff, pppm.cpp:3108)."""
    offs = torch.arange(order, dtype=frac.dtype, device=frac.device)
    xx = frac[..., None] + (order - 1.0) - offs
    return _bspline(xx, order)


@dataclasses.dataclass(frozen=True)
class PPPMParams:
    """The mesh's parameters; the scalars are Python floats, as the Ewald
    tables' are."""

    g_ewald: float
    qqrd2e: float
    qsqsum: float
    qsum: float
    grid: tuple = (8, 8, 8)
    order: int = 5
    # pppm/stagger (pppm_stagger.cpp): the mesh evaluated twice, the second
    # time with the atoms shifted by half a grid spacing in every
    # dimension, and the two averaged
    stagger: bool = False

    @staticmethod
    def from_setup(s: PPPMSetup, qqrd2e, qsqsum, qsum,
                   stagger=False) -> "PPPMParams":
        return PPPMParams(g_ewald=float(s.g_ewald), qqrd2e=float(qqrd2e),
                          qsqsum=float(qsqsum), qsum=float(qsum),
                          grid=tuple(int(v) for v in s.grid),
                          order=int(s.order), stagger=bool(stagger))


def pppm_forces_params(x, q, box_lengths, p: PPPMParams):
    """pppm_forces of the parameters p, with the stagger pass when set.
    x: positions relative to the box's lower corner."""
    setup = PPPMSetup(g_ewald=p.g_ewald, grid=p.grid, order=p.order)
    out0 = pppm_forces(x, q, box_lengths, setup, p.qqrd2e, p.qsqsum, p.qsum)
    if not p.stagger:
        return out0
    # two interleaved grids, averaged (pppm_stagger.cpp compute():
    # nstagger=2, particle_map with shift 0 then h/2)
    h = box_lengths / torch.tensor(p.grid, dtype=x.dtype, device=x.device)
    out1 = pppm_forces(x + 0.5 * h[None, :], q, box_lengths, setup,
                       p.qqrd2e, p.qsqsum, p.qsum)
    return tuple(0.5 * (a + b) for a, b in zip(out0, out1))


def _fftfreq(n, d, dtype, device):
    """jnp.fft.fftfreq(n, d): ((i + n//2) % n - n//2) / (d * n), the
    divisor formed in Python as there (for some n it is not exactly n * d
    = 1)."""
    i = torch.arange(n, dtype=dtype, device=device)
    k = torch.remainder(i + n // 2, n) - n // 2
    return k / (d * n)


def _integer_pow(x, y: int):
    """x**y by binary powering, as XLA's integer_pow forms it."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _stencil(x, L, grid, order):
    """The assignment stencil of positions x (relative to the box's lower
    corner) on the grid: the (N,P,P,P) weights, the products of the
    per-dimension order-P B-spline weights, and the (N*P^3,) linear grid
    index of each."""
    dtype, dev = x.dtype, x.device
    nx, ny, nz = grid
    h = L / torch.tensor([nx, ny, nz], dtype=dtype, device=dev)
    s = x / h[None, :]
    base = torch.floor(s - (order - 1) / 2.0).to(torch.int64)
    frac = s - base.to(dtype) - (order - 1) / 2.0     # in [0,1)
    w = _assignment_weights(frac, order)                # (N,3,P)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]

    offs = torch.arange(order, device=dev)
    gi = torch.remainder(base[:, :, None] + offs,
                         torch.tensor(grid, device=dev)[:, None])
    gx, gy, gz = gi[:, 0], gi[:, 1], gi[:, 2]           # (N,P)

    w3 = (wx[:, :, None, None] * wy[:, None, :, None]
          * wz[:, None, None, :])                      # (N,P,P,P)
    lin = ((gx[:, :, None, None] * ny + gy[:, None, :, None]) * nz
           + gz[:, None, None, :]).reshape(-1)         # (N*P^3,)
    return w3, lin


def _spread(vals, w3, lin, grid):
    """The (nx,ny,nz) grid of the per-atom values spread by the stencil:
    a scatter-add of N * P^3 weights."""
    nx, ny, nz = grid
    rho = torch.zeros(nx * ny * nz, dtype=w3.dtype, device=w3.device)
    rho.index_add_(0, lin, (w3 * vals[:, None, None, None]).reshape(-1))
    return rho.reshape(nx, ny, nz)


def _modes(grid, L, order, dtype, dev):
    """The FFT mode lattice of the grid: KX, KY, KZ (the wave vectors of
    the box lengths L), k^2 with its k = 0 entry set to 1, and W(k)^2, the
    square of the assignment function's transform
    prod_d sinc(pi m_d / n_d)^order, floored at 1e-12."""
    nx, ny, nz = grid
    two_pi = 2 * math.pi
    kx = two_pi * _fftfreq(nx, float(1) / nx, dtype, dev) / L[0]
    ky = two_pi * _fftfreq(ny, float(1) / ny, dtype, dev) / L[1]
    kz = two_pi * _fftfreq(nz, float(1) / nz, dtype, dev) / L[2]
    KX, KY, KZ = torch.meshgrid(kx, ky, kz, indexing="ij")
    k2 = KX * KX + KY * KY + KZ * KZ
    k2[0, 0, 0] = 1.0

    def sinc(m, nn):
        u = math.pi * m / nn
        zero = m == 0
        return torch.where(zero, 1.0, torch.sin(u) / torch.where(zero, 1.0,
                                                                   u))

    mx = _fftfreq(nx, 1.0, dtype, dev) * nx
    my = _fftfreq(ny, 1.0, dtype, dev) * ny
    mz = _fftfreq(nz, 1.0, dtype, dev) * nz
    MX, MY, MZ = torch.meshgrid(mx, my, mz, indexing="ij")
    wk = _integer_pow(sinc(MX, nx) * sinc(MY, ny) * sinc(MZ, nz), order)
    return KX, KY, KZ, k2, torch.clamp(wk * wk, min=1e-12)


def _fields(KX, KY, KZ, phi_k, w3, lin, n):
    """The ik-differentiated fields of the mode potential phi_k (the three
    inverse transforms as one batch), interpolated at the atoms with the
    spreading weights: (N,3)."""
    fields = torch.real(torch.fft.ifftn(
        -1j * torch.stack([KX, KY, KZ]) * phi_k, dim=(1, 2, 3)))
    vals = fields.reshape(3, -1)[:, lin].reshape(3, n, -1)
    return torch.sum(vals * w3.reshape(1, n, -1), dim=2).T


def pppm_forces(x, q, box_lengths, setup: PPPMSetup, qqrd2e, qsqsum, qsum):
    """The mesh's (f (N,3), elong, virial6) for positions x relative to the
    box's lower corner, charges q and the box lengths (a (3,) tensor); the
    energy less the self and neutralising-background terms, the virial of
    the per-mode terms only (pppm.cpp poisson_ik, as ewald.cpp:466-474)."""
    dtype = x.dtype
    dev = x.device
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    nx, ny, nz = setup.grid
    L = box_lengths.to(dtype)
    n = x.shape[0]
    g = setup.g_ewald

    # --- charge assignment (scatter) ---
    w3, lin = _stencil(x, L, setup.grid, setup.order)
    rho = _spread(q, w3, lin, setup.grid)

    # --- reciprocal convolution, with the B-spline deconvolution: the
    # assignment and the interpolation each smear by W(k), so the
    # effective Green's function carries 1/W(k)^2 ---
    KX, KY, KZ, k2, wk2 = _modes(setup.grid, L, setup.order, dtype, dev)
    green = torch.exp(-k2 / (4 * g * g)) / k2
    green[0, 0, 0] = 0.0

    rho_k = torch.fft.fftn(rho.to(cdtype))
    vol = L[0] * L[1] * L[2]
    # ifftn carries 1/Ngrid: fold Ngrid into phi_k so the real-space fields
    # come out in physical units
    phi_k = 4 * math.pi * green * rho_k / (vol * wk2) * (nx * ny * nz)
    rho2 = torch.abs(rho_k)
    rho2 = rho2 * rho2
    ek = (2 * math.pi / vol) * green * rho2 / wk2       # per-mode energy
    elong = (2 * math.pi / vol) * torch.sum(green * rho2 / wk2)
    elong = elong * qqrd2e
    elong = elong - qqrd2e * (qsqsum * g / math.sqrt(math.pi)
                              + math.pi / (2 * g * g * vol) * qsum * qsum)

    # fields via ik differentiation, interpolated with the same weights
    f = qqrd2e * q[:, None] * _fields(KX, KY, KZ, phi_k, w3, lin, n)

    # mesh virial (pppm.cpp vg coefficients + poisson_ik's virial branch):
    # v_ab = delta_ab - 2 k_a k_b (1/k^2 + 1/(4g^2)) on each mode's energy
    vfac = 2.0 * (1.0 / k2 + 1.0 / (4.0 * g * g))

    def vcomp(ka, kb, diag):
        w = (1.0 if diag else 0.0) - vfac * ka * kb
        return qqrd2e * torch.sum(ek * w)

    virial = torch.stack([
        vcomp(KX, KX, True), vcomp(KY, KY, True), vcomp(KZ, KZ, True),
        vcomp(KX, KY, False), vcomp(KX, KZ, False), vcomp(KY, KZ, False)])
    return f, elong, virial


# --------------------------- pppm/disp -------------------------------------
#
# The dispersion mesh (lidp_tpu/ops/pppm.py :290-468): the mesh analog of
# the geometric-mixing 1/r^6 Ewald function (ops/ewald.py setup_dispersion,
# ewald6_forces), the reference's KSPACE/pppm_disp.cpp geometric branch.
# The charge mesh's stencil, spread and mode lattice, with the per-atom B_i
# spread and the per-mode coefficients of ewald_disp.cpp's func[1] branch
# (:469-478) on the full FFT lattice in place of a half-space k list.


@dataclasses.dataclass(frozen=True)
class PPPMDispSetup:
    g6: float
    grid: tuple
    order: int
    bsum: float
    bsbsum: float


@dataclasses.dataclass(frozen=True)
class PPPMDispParams:
    """The dispersion mesh's parameters, all Python values (the same
    attribute names as PPPMDispSetup; pppm_disp_forces takes either)."""

    g6: float = 1.0
    grid: tuple = (8, 8, 8)
    order: int = 7
    bsum: float = 0.0
    bsbsum: float = 0.0

    @staticmethod
    def from_setup(s: PPPMDispSetup) -> "PPPMDispParams":
        return PPPMDispParams(g6=float(s.g6),
                              grid=tuple(int(v) for v in s.grid),
                              order=int(s.order), bsum=float(s.bsum),
                              bsbsum=float(s.bsbsum))


def setup_pppm_disp(*, accuracy_rel: float, qqrd2e: float, b_atom,
                    natoms: int, cutoff: float, box_lengths,
                    order: int = 7, g6: float | None = None,
                    h_per_g: float = 0.2) -> PPPMDispSetup:
    """The dispersion grid (lidp_tpu/ops/pppm.py setup_pppm_disp): g6 from
    the Newton solve of ops/ewald.newton_g6 unless `kspace_modify
    gewald/disp` pins it, the grid from the spacing h g6 <= h_per_g raised
    to 2/3/5-factorable sizes (the JAX package's rule in place of
    pppm_disp.cpp set_grid_6's error series; order 7 by default)."""
    from lidp_tpu_torch.ops.ewald import newton_g6

    L = np.asarray(box_lengths, float)
    b_atom = np.asarray(b_atom, float)
    bsum = float(np.sum(b_atom))
    bsbsum = float(np.sum(b_atom ** 2))
    if g6 is None:
        accuracy = accuracy_rel * qqrd2e
        g6 = newton_g6(accuracy, bsbsum, natoms, cutoff, float(np.prod(L)))
    grid = []
    for prd in L:
        n = max(2, int(math.ceil(prd * g6 / h_per_g)))
        while not _factorable(n):
            n += 1
        grid.append(n)
    return PPPMDispSetup(g6=float(g6), grid=tuple(grid), order=order,
                         bsum=bsum, bsbsum=bsbsum)


def pppm_disp_forces(x, b_atom, box_lengths, s):
    """The dispersion mesh's (f (N,3), edisp, virial6) for positions x
    relative to the box's lower corner, the per-atom B_i and the box
    lengths.  The mode coefficient (ewald_disp.cpp coefficients()
    func[1]) ke6(k) = -|k|^3 (sqrt(pi) erfc(b) + (0.5/b^2 - 1) e^{-b^2}
    / b), b = |k| / (2 g6), with E = (c_e/2) sum_{k != 0} ke6 |S(k)|^2 -
    self over the full lattice, c_e = 2 pi^{3/2} / (24 V)."""
    dtype = x.dtype
    dev = x.device
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    nx, ny, nz = s.grid
    L = torch.as_tensor(box_lengths, device=dev).to(dtype)
    n = x.shape[0]
    g = s.g6

    b = torch.as_tensor(b_atom, device=dev).to(dtype)
    w3, lin = _stencil(x, L, s.grid, s.order)
    rho_k = torch.fft.fftn(_spread(b, w3, lin, s.grid).to(cdtype))

    # the dispersion Green's function on the mode lattice
    KX, KY, KZ, k2safe, wk2 = _modes(s.grid, L, s.order, dtype, dev)
    h1 = torch.sqrt(k2safe)
    b1 = h1 / (2.0 * g)
    b2 = b1 * b1
    expb2 = torch.exp(-b2)
    erfcb = torch.special.erfc(b1)
    pis = math.sqrt(math.pi)
    ke6 = -h1 * k2safe * (pis * erfcb + (0.5 / b2 - 1.0) * expb2 / b1)
    ke6[0, 0, 0] = 0.0
    # the virial tensor factor (ewald_disp.cpp compute_virial func[1])
    c2v = 3.0 * h1 * (pis * erfcb - expb2 / b1)
    c2v[0, 0, 0] = 0.0

    vol = L[0] * L[1] * L[2]
    c_e = 2.0 * math.pi * pis / (24.0 * vol)
    sk2 = torch.abs(rho_k)
    sk2 = sk2 * sk2 / wk2

    g3 = g ** 3
    virial_self = math.pi * pis * g3 / (6.0 * vol) * s.bsum * s.bsum
    energy_self = -s.bsbsum * g3 * g3 / 12.0 + virial_self
    edisp = 0.5 * c_e * torch.sum(ke6 * sk2) - energy_self

    # forces: phi6_k = c_e ke6 rho_k / W^2 Ngrid (the 0.5 of the
    # full-lattice energy and the 2 of d|S|^2 cancel); f_i = B_i E6(r_i)
    phi_k = c_e * ke6 * rho_k / wk2 * (nx * ny * nz)
    f = b[:, None] * _fields(KX, KY, KZ, phi_k, w3, lin, n)

    def vcomp(ka, kb, diag):
        w = (ke6 if diag else 0.0) - c2v * ka * kb
        return 0.5 * c_e * torch.sum(sk2 * w)

    virial = torch.stack([
        vcomp(KX, KX, True), vcomp(KY, KY, True), vcomp(KZ, KZ, True),
        vcomp(KX, KY, False), vcomp(KX, KZ, False), vcomp(KY, KZ, False)])
    virial = virial - virial_self * torch.tensor(
        [1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    return f, edisp, virial
