"""Multilevel summation (kspace_style msm and msm/cg;
lidp_tpu/ops/msm.py, the counterpart of the reference's KSPACE/msm.cpp).

Each level's grid-to-grid interaction is one FFT convolution on a regular
periodic grid, egrid = IFFT(FFT(qgrid) * Ghat), the stencil and its wrap
baked into Ghat at setup, as in the JAX package.  The hierarchy keeps the
reference's operators:

- the splitting polynomials gamma/dgamma (kspace.cpp:97-133 gcons/dgcons);
- the nodal interpolation polynomials phi of orders 4/6/8/10
  (msm.cpp:2923-3100 compute_phi), dphi by central differences of phi;
- the grid: estimate_1d_error (msm.cpp:252), the power-of-2 boost, levels
  = log2 - 1 for a periodic box (msm.cpp:924-1110), and under
  cutoff/adjust the cost-optimal grid with the coulomb cutoff solved from
  the error model (msm.cpp:936-1053), capped at 0.499 min(L);
- the level kernels g_direct[n] = gamma(rho)/(2^n a) - gamma(rho/2)/
  (2^{n+1} a) (msm.cpp:3169), the top periodic level keeping the
  difference kernel;
- restriction and prolongation by the separable phi(nu/2) stencils over
  odd nu (msm.cpp:2254-2400);
- the self energy 0.5 qscale qsqsum gamma(0)/a (msm.cpp:598), and the
  per-level virial kernels V_ab(r) = -r_a r_b K'(r)/r (the FFT form of
  msm.cpp direct()'s v0..v5_direct stencils).

The setup is host numpy, line for line the JAX package's.  `msm_forces`
is plain PyTorch in the dtype of x; the spread is a scatter-add of
N * order^3 weights (`index_add_`), which on a GPU adds in the order the
atomics land, as the port's PPPM does.  The real-space complement is the
"msm" coulomb kind of ops/pair.py (pair_coul_msm.cpp:115-117).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# gcons[split_order][n]: gamma(rho) = sum_n gcons[s][n] rho^(2n) for rho<=1
# (kspace.cpp:97-123; the Taylor series of s^-1/2 about s=1)
GCONS = {
    2: [15.0 / 8.0, -5.0 / 4.0, 3.0 / 8.0],
    3: [35.0 / 16.0, -35.0 / 16.0, 21.0 / 16.0, -5.0 / 16.0],
    4: [315.0 / 128.0, -105.0 / 32.0, 189.0 / 64.0, -45.0 / 32.0,
        35.0 / 128.0],
    5: [693.0 / 256.0, -1155.0 / 256.0, 693.0 / 128.0, -495.0 / 128.0,
        385.0 / 256.0, -63.0 / 256.0],
    6: [3003.0 / 1024.0, -3003.0 / 512.0, 9009.0 / 1024.0, -2145.0 / 256.0,
        5005.0 / 1024.0, -819.0 / 512.0, 231.0 / 1024.0],
}

# dgcons[split_order][n]: dgamma(rho) = sum_n dgcons[s][n] rho^(2n+1)
DGCONS = {
    2: [-5.0 / 2.0, 3.0 / 2.0],
    3: [-35.0 / 8.0, 21.0 / 4.0, -15.0 / 8.0],
    4: [-105.0 / 16.0, 189.0 / 16.0, -135.0 / 16.0, 35.0 / 16.0],
    5: [-1155.0 / 128.0, 693.0 / 32.0, -1485.0 / 64.0, 385.0 / 32.0,
        -315.0 / 128.0],
    6: [-3003.0 / 256.0, 9009.0 / 256.0, -6435.0 / 128.0, 5005.0 / 128.0,
        -4095.0 / 256.0, 693.0 / 256.0],
}


def gamma(rho, order: int):
    """The softened 1/rho (kspace.h gamma) of array-like rho."""
    rho = np.asarray(rho, float)
    s = order // 2
    rho2 = rho * rho
    g = np.full_like(rho, GCONS[s][0])
    rn = rho2.copy()
    for n in range(1, s + 1):
        g = g + GCONS[s][n] * rn
        rn = rn * rho2
    return np.where(rho <= 1.0, g, 1.0 / np.where(rho > 0, rho, 1.0))


def dgamma(rho, order: int):
    """d gamma / d rho of array-like rho."""
    rho = np.asarray(rho, float)
    s = order // 2
    rho2 = rho * rho
    dg = DGCONS[s][0] * rho
    rn = rho * rho2
    for n in range(1, s):
        dg = dg + DGCONS[s][n] * rn
        rn = rn * rho2
    return np.where(rho <= 1.0, dg,
                    -1.0 / np.where(rho > 0, rho2, 1.0))


def _phi_poly(xi, order: int):
    """compute_phi (msm.cpp:2923): the nodal interpolation basis of a
    numpy array or a tensor, in its own namespace."""
    b = torch if isinstance(xi, torch.Tensor) else np
    axi = b.abs(xi)
    xi2 = xi * xi
    if order == 4:
        p1 = (1.0 - axi) * (1.0 + axi - 1.5 * xi2)
        p2 = -0.5 * (axi - 1.0) * (2.0 - axi) * (2.0 - axi)
        return b.where(axi <= 1, p1, b.where(axi <= 2, p2, 0.0))
    if order == 6:
        p1 = (1.0 - xi2) * (2.0 - axi) * (6.0 + 3.0 * axi - 5.0 * xi2) / 12.0
        p2 = -(axi - 1.0) * (2.0 - axi) * (3.0 - axi) * \
            (4.0 + 9.0 * axi - 5.0 * xi2) / 24.0
        p3 = (axi - 1.0) * (axi - 2.0) * (3.0 - axi) * (3.0 - axi) * \
            (4.0 - axi) / 24.0
        return b.where(axi <= 1, p1, b.where(axi <= 2, p2,
                       b.where(axi <= 3, p3, 0.0)))
    if order == 8:
        p1 = (1.0 - xi2) * (4.0 - xi2) * (3.0 - axi) * \
            (12.0 + 4.0 * axi - 7.0 * xi2) / 144.0
        p2 = -(xi2 - 1.0) * (2.0 - axi) * (3.0 - axi) * (4.0 - axi) * \
            (10.0 + 12.0 * axi - 7.0 * xi2) / 240.0
        p3 = (axi - 1.0) * (axi - 2.0) * (3.0 - axi) * (4.0 - axi) * \
            (5.0 - axi) * (6.0 + 20.0 * axi - 7.0 * xi2) / 720.0
        p4 = -(axi - 1.0) * (axi - 2.0) * (axi - 3.0) * (4.0 - axi) * \
            (4.0 - axi) * (5.0 - axi) * (6.0 - axi) / 720.0
        return b.where(axi <= 1, p1, b.where(axi <= 2, p2,
                       b.where(axi <= 3, p3, b.where(axi <= 4, p4, 0.0))))
    if order == 10:
        p1 = (1.0 - xi2) * (4.0 - xi2) * (9.0 - xi2) * (4.0 - axi) * \
            (20.0 + 5.0 * axi - 9.0 * xi2) / 2880.0
        p2 = -(xi2 - 1.0) * (4.0 - xi2) * (3.0 - axi) * (4.0 - axi) * \
            (5.0 - axi) * (6.0 + 5.0 * axi - 3.0 * xi2) / 1440.0
        p3 = (xi2 - 1.0) * (axi - 2.0) * (3.0 - axi) * (4.0 - axi) * \
            (5.0 - axi) * (6.0 - axi) * \
            (14.0 + 25.0 * axi - 9.0 * xi2) / 10080.0
        p4 = -(axi - 1.0) * (axi - 2.0) * (axi - 3.0) * (4.0 - axi) * \
            (5.0 - axi) * (6.0 - axi) * (7.0 - axi) * \
            (8.0 + 35.0 * axi - 9.0 * xi2) / 40320.0
        p5 = (axi - 1.0) * (axi - 2.0) * (axi - 3.0) * (axi - 4.0) * \
            (5.0 - axi) * (5.0 - axi) * (6.0 - axi) * (7.0 - axi) * \
            (8.0 - axi) / 40320.0
        return b.where(axi <= 1, p1, b.where(axi <= 2, p2,
                       b.where(axi <= 3, p3, b.where(axi <= 4, p4,
                               b.where(axi <= 5, p5, 0.0)))))
    raise ValueError(f"MSM order must be 4, 6, 8, or 10, got {order}")


def _dphi_poly(xi, order: int, h=1e-6):
    """dphi by central differences of phi, step 1e-6 (the JAX package's
    form in place of msm.cpp:3002-3100)."""
    return (_phi_poly(xi + h, order) - _phi_poly(xi - h, order)) / (2 * h)


# error estimator constants (msm.cpp:252-294: Mp from Hardy Table 5.1,
# cprime Hardy Eq 4.17, the empirical rms scalings)
_ERR = {4: (9.0, 1.0 / 6.0, 0.39189561),
        6: (825.0, 1.0 / 30.0, 0.150829428),
        8: (130095.0, 1.0 / 140.0, 0.049632967),
        10: (34096545.0, 1.0 / 630.0, 0.013520855)}


def _estimate_1d_error(h, prd, *, cutoff, order, q2, natoms):
    Mp, cprime, scaling = _ERR[order]
    C_p = 4.0 * cprime * Mp / 3.0 * scaling
    p = order - 1
    err = C_p * h ** (p - 1) / cutoff ** (p + 1)
    return err * q2 * cutoff / (prd * math.sqrt(float(natoms)))


@dataclasses.dataclass(frozen=True)
class MSMSetup:
    order: int
    cutoff: float
    grid: tuple                 # the finest (nx, ny, nz)
    levels: int
    ghat: tuple                 # per-level rfft kernels (numpy complex)
    gamma0: float               # gamma(0)
    qscale: float
    # per-level (6, ...) rfft virial kernels V_ab(r) = -r_a r_b K'(r)/r
    vhat: tuple = ()
    # the adjusted cutoff before the 0.499 min(L) cap (the reference's
    # "new cutoff")
    cutoff_uncapped: float = 0.0


def setup_msm(*, accuracy_rel: float, qqrd2e: float, q, natoms: int,
              cutoff: float, box_lengths, order: int = 10,
              cutoff_adjust: bool = True) -> MSMSetup:
    """The grid, levels and level kernels (msm.cpp set_grid_global +
    get_g_direct; lidp_tpu/ops/msm.py setup_msm).  cutoff_adjust (the
    reference's default, kspace.cpp:71) picks the cost-optimal grid from
    Hardy's hmin estimate and solves the coulomb cutoff from the error
    model (msm.cpp:936-1053), capped at 0.499 min(L) for the minimum-image
    kernels; the caller pushes MSMSetup.cutoff back into the pair style
    (msm.cpp:1048)."""
    L = np.asarray(box_lengths, float)
    q = np.asarray(q, float)
    q2 = float(np.sum(q * q)) * qqrd2e
    accuracy = accuracy_rel * qqrd2e   # two_charge_force

    def _pow2(nv):
        # factorable-by-2 rounding (msm.cpp:1004-1024, factors = {2})
        k = math.log(nv) / math.log(2.0)
        return 2 ** (int(k) + (1 if k - int(k) > 0.5 else 0))

    grid = []
    lv = []
    if cutoff_adjust:
        p = order - 1
        hmin = (3072.0 * (p + 1) / (p - 1)
                / (448.0 * math.pi + 56.0 * math.pi * order / 2 + 1701.0))
        hmin = hmin ** (1.0 / 6.0) * (float(np.prod(L)) / natoms) ** (1 / 3)
        grid = [max(_pow2(max(int(prd / hmin), 2)), 2) for prd in L]
        lv = [int(round(math.log2(g))) + 1 for g in grid]
        h = L / np.asarray(grid)
        Mp, cprime, scaling = _ERR[order]
        C_p = 4.0 * cprime * Mp / 3.0 * scaling
        kk = q2 * C_p / accuracy / math.sqrt(float(natoms))
        ssum = float(np.sum(h ** (2.0 * p - 2.0) / L ** 2))
        cutoff_uncapped = (kk * kk * ssum / 3.0) ** (1.0 / (2.0 * p))
        cutoff = min(cutoff_uncapped, 0.499 * float(np.min(L)))
    else:
        for prd in L:
            nmax = 2
            while _estimate_1d_error(prd / nmax, prd, cutoff=cutoff,
                                     order=order, q2=q2,
                                     natoms=natoms) > accuracy:
                nmax *= 2
                if nmax > 16384:
                    raise ValueError("MSM grid too large for accuracy")
            grid.append(nmax)
            lv.append(int(round(math.log2(nmax))) + 1)
    levels = max(max(lv) - 1, 1)   # periodic: omit the top level

    # per-level FFT kernels: the stencil g_direct over +-(2a/h) grid
    # offsets, wrapped periodically onto the level grid
    ghat = []
    vhat = []
    for n in range(levels):
        gl = [max(g >> n, 2) for g in grid]
        h_n = L / np.asarray(gl)
        a_n = (2.0 ** n) * cutoff
        rad = [int(2.0 * cutoff / (Ld / gf)) for Ld, gf in zip(L, grid)]
        ix = np.arange(-rad[0], rad[0] + 1)
        iy = np.arange(-rad[1], rad[1] + 1)
        iz = np.arange(-rad[2], rad[2] + 1)
        DX, DY, DZ = np.meshgrid(ix * h_n[0], iy * h_n[1], iz * h_n[2],
                                 indexing="ij")
        r = np.sqrt(DX * DX + DY * DY + DZ * DZ)
        rho = r / a_n
        ker = gamma(rho, order) / a_n - gamma(rho / 2.0, order) / (2.0 * a_n)
        # dK/dr for the virial stencils (d/dr gamma(r/a)/a = dgamma/a^2)
        dker = (dgamma(rho, order) / (a_n * a_n)
                - dgamma(rho / 2.0, order) / (4.0 * a_n * a_n))
        rinv = np.where(r > 0, 1.0 / np.where(r > 0, r, 1.0), 0.0)
        wrap = (np.mod(ix, gl[0])[:, None, None],
                np.mod(iy, gl[1])[None, :, None],
                np.mod(iz, gl[2])[None, None, :])
        kgrid = np.zeros(gl)
        np.add.at(kgrid, wrap, ker)
        ghat.append(np.fft.rfftn(kgrid))
        vker = []
        for (da, db) in ((DX, DX), (DY, DY), (DZ, DZ),
                         (DX, DY), (DX, DZ), (DY, DZ)):
            vg = np.zeros(gl)
            np.add.at(vg, wrap, -da * db * dker * rinv)
            vker.append(np.fft.rfftn(vg))
        vhat.append(np.stack(vker))
    return MSMSetup(order=order, cutoff=float(cutoff), grid=tuple(grid),
                    levels=levels, ghat=tuple(ghat),
                    gamma0=float(gamma(0.0, order)), qscale=float(qqrd2e),
                    vhat=tuple(vhat),
                    cutoff_uncapped=float(cutoff_uncapped
                                          if cutoff_adjust else cutoff))


@dataclasses.dataclass(frozen=True)
class MSMParams:
    """The device form of an MSMSetup: the per-level kernels as complex
    tensors, the scalars Python values (msm_forces takes either)."""

    ghat: tuple
    vhat: tuple = ()
    order: int = 10
    cutoff: float = 10.0
    grid: tuple = (8, 8, 8)
    levels: int = 2
    gamma0: float = 1.0
    qscale: float = 1.0

    @staticmethod
    def from_setup(s: MSMSetup, dtype=torch.float64,
                   device="cpu") -> "MSMParams":
        cdtype = torch.complex128 if dtype == torch.float64 \
            else torch.complex64

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device).to(cdtype)

        return MSMParams(ghat=tuple(t(g) for g in s.ghat),
                         vhat=tuple(t(v) for v in s.vhat),
                         order=int(s.order), cutoff=float(s.cutoff),
                         grid=tuple(int(v) for v in s.grid),
                         levels=int(s.levels), gamma0=float(s.gamma0),
                         qscale=float(s.qscale))


def _interp_weights(s, order):
    """(base (N,), offsets (order,), phi weights (N,order), xi (N,order))
    of one dimension: base = floor(s) (particle_map msm.cpp:1454), the
    offsets nlower..nupper, xi = offset - frac."""
    # C truncation, not floor: -(order-1)/2 = -4 for order 10
    nlower = -((order - 1) // 2)
    base = torch.floor(s).to(torch.int64)
    frac = s - base.to(s.dtype)
    offs = torch.arange(nlower, order // 2 + 1, device=s.device)
    xi = offs.to(s.dtype)[None, :] - frac[:, None]
    return base, offs, _phi_poly(xi, order), xi


def msm_forces(x, q, box_lengths, s):
    """The MSM long-range part (f (N,3), elong, virial6) for positions x
    relative to the box's lower corner, charges q, the box lengths and an
    MSMSetup or MSMParams; periodic orthogonal boxes."""
    dtype, dev = x.dtype, x.device
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    nx, ny, nz = s.grid
    order = s.order
    L = torch.as_tensor(box_lengths, dtype=dtype, device=dev)
    h = L / torch.tensor([nx, ny, nz], dtype=dtype, device=dev)
    n = x.shape[0]

    bx, offs, wx, xix = _interp_weights(x[:, 0] / h[0], order)
    by, _, wy, xiy = _interp_weights(x[:, 1] / h[1], order)
    bz, _, wz, xiz = _interp_weights(x[:, 2] / h[2], order)
    gx = torch.remainder(bx[:, None] + offs[None, :], nx)     # (N,P)
    gy = torch.remainder(by[:, None] + offs[None, :], ny)
    gz = torch.remainder(bz[:, None] + offs[None, :], nz)

    w3 = (wx[:, :, None, None] * wy[:, None, :, None]
          * wz[:, None, None, :])                             # (N,P,P,P)
    lin = ((gx[:, :, None, None] * ny + gy[:, None, :, None]) * nz
           + gz[:, None, None, :]).reshape(-1)
    qgrid = torch.zeros(nx * ny * nz, dtype=dtype, device=dev)
    qgrid.index_add_(0, lin, (w3 * q[:, None, None, None]).reshape(-1))
    qgrid = qgrid.reshape(nx, ny, nz)

    # restriction weights: phi(nu/2) over odd nu and 0 (msm.cpp:2254)
    p = order - 1
    nus = np.array([v for v in range(-p, p + 1) if v % 2 or v == 0])
    rw = torch.as_tensor(np.asarray(_phi_poly(nus / 2.0, order)),
                         dtype=dtype, device=dev)

    def restrict1d(g, axis, nc):
        acc = 0.0
        for k, nu in enumerate(nus):
            acc = acc + rw[k] * torch.roll(g, -int(nu), dims=axis)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, 2 * nc, 2)
        return acc[tuple(sl)]

    def prolong1d(e, axis, nf):
        shape = list(e.shape)
        shape[axis] = nf
        up = torch.zeros(shape, dtype=e.dtype, device=dev)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, nf, 2)
        up[tuple(sl)] = e
        acc = 0.0
        for k, nu in enumerate(nus):
            acc = acc + rw[k] * torch.roll(up, int(nu), dims=axis)
        return acc

    # downward pass: restrict each level to the next
    qgrids = [qgrid]
    for _ in range(1, s.levels):
        g = qgrids[-1]
        gl = [max(d >> 1, 2) for d in g.shape]
        g = restrict1d(g, 0, gl[0])
        g = restrict1d(g, 1, gl[1])
        g = restrict1d(g, 2, gl[2])
        qgrids.append(g)

    egrids = []
    virial = torch.zeros(6, dtype=dtype, device=dev)
    for lvl in range(s.levels):
        gh = torch.as_tensor(s.ghat[lvl], device=dev).to(cdtype)
        shape = tuple(qgrids[lvl].shape)
        rho_k = torch.fft.rfftn(qgrids[lvl])
        egrids.append(torch.fft.irfftn(rho_k * gh, s=shape))
        if s.vhat:
            # the grid-level virial W_ab = qscale/2 sum_g q (V_ab (*) q),
            # one batched inverse FFT over the leading ab axis
            vh = torch.as_tensor(s.vhat[lvl], device=dev).to(cdtype)
            vab = torch.fft.irfftn(rho_k[None] * vh, s=shape, dim=(1, 2, 3))
            virial = virial + 0.5 * s.qscale * torch.sum(
                qgrids[lvl][None] * vab, dim=(1, 2, 3))

    # upward pass: prolongate the coarse potentials onto the finer grids
    e = egrids[-1]
    for lvl in range(s.levels - 2, -1, -1):
        fine_shape = qgrids[lvl].shape
        e = prolong1d(e, 0, fine_shape[0])
        e = prolong1d(e, 1, fine_shape[1])
        e = prolong1d(e, 2, fine_shape[2])
        e = e + egrids[lvl]

    # interpolation: energy and fields (fieldforce, msm.cpp:2751)
    evals = e.reshape(-1)[lin].reshape(n, order, order, order)
    e_atom = torch.sum(evals * w3, dim=(1, 2, 3))
    qsqsum = torch.sum(q * q)
    elong = 0.5 * s.qscale * (torch.sum(q * e_atom)
                              - qsqsum * s.gamma0 / s.cutoff)

    dwx = _dphi_poly(xix, order)
    dwy = _dphi_poly(xiy, order)
    dwz = _dphi_poly(xiz, order)
    ekx = torch.sum(evals * dwx[:, :, None, None] * wy[:, None, :, None]
                    * wz[:, None, None, :], dim=(1, 2, 3)) / h[0]
    eky = torch.sum(evals * wx[:, :, None, None] * dwy[:, None, :, None]
                    * wz[:, None, None, :], dim=(1, 2, 3)) / h[1]
    ekz = torch.sum(evals * wx[:, :, None, None] * wy[:, None, :, None]
                    * dwz[:, None, None, :], dim=(1, 2, 3)) / h[2]
    f = s.qscale * q[:, None] * torch.stack([ekx, eky, ekz], dim=-1)
    return f, elong, virial
