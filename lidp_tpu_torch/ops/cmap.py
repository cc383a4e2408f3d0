"""fix cmap: the CHARMM CMAP crossterm corrections (lidp_tpu/ops/cmap.py;
fix_cmap.cpp).

The setup is the reference's, on the host in float64 numpy: the six
hard-coded 24x24 maps read in file order (read_grid_map :636-783), the
periodic-expansion cubic splines of the d/dphi, d/dpsi and cross
derivative grids (set_map_derivatives :839-936, the natural-spline
tridiagonal solve :787-812), and the bicubic weight matrix _WT (bc_coeff
:963-1006).

The term is one pass over the (M,5) crossterm atom rows: phi and psi by
the atan2 convention in degrees (dihedral_angle_atan2 :939-960) with
+180 folded to -180, the grid lookups modulo 24, the 16x16 bicubic weights
(bc_interpol :1009-1045), and the chain-rule forces of post_force
:307-603 with its asymmetric f3/f4 signs and the vcmap virial.  As in the
JAX package the coordinates are taken raw (whole molecules, as the
reference's unwrapped ghosts give them): the dense route, which never
wraps the atoms.  Plain PyTorch, as XLA runs it in the JAX package: no
kernel; the forces reach the atoms by index_add_ (float atomics on the
GPU: the last bits differ between runs), as the bonded terms do.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

CMAPDIM = 24
CMAPXMIN = -360.0
CMAPXMIN2 = -180.0
CMAPDX = 15.0

# the bicubic interpolation weights (Numerical Recipes bcucof, the
# reference's wt table, fix_cmap.cpp:966-983)
_WT = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    [-3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1, 0, 0, 0, 0],
    [2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, -3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1],
    [0, 0, 0, 0, 2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1],
    [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
    [9, -9, 9, -9, 6, 3, -3, -6, 6, -6, -3, 3, 4, 2, 1, 2],
    [-6, 6, -6, 6, -4, -2, 2, 4, -3, 3, 3, -3, -2, -1, -1, -2],
    [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
    [-6, 6, -6, 6, -3, -3, 3, 3, -4, 4, 2, -2, -2, -2, -1, -1],
    [4, -4, 4, -4, 2, 2, -2, -2, 2, -2, -2, 2, 1, 1, 1, 1],
], float)


def read_grid_map(path):
    """The six maps in the reference's hard-coded file order (:683-689):
    ala, ala-pro, pro, pro-pro, gly, gly-pro; (6,24,24).  Blank lines and
    `#` lines are skipped, and a line's numbers end at its first word."""
    vals = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            for tok in s.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    break
    need = 6 * CMAPDIM * CMAPDIM
    if len(vals) < need:
        raise ValueError(f"cmap file too short: {len(vals)} < {need}")
    return np.asarray(vals[:need]).reshape(6, CMAPDIM, CMAPDIM)


def _spline(y):
    """Natural cubic spline second derivatives on the 15-degree grid
    (FixCMAP::spline :787-812)."""
    n = len(y)
    ddy = np.zeros(n)
    u = np.zeros(n - 1)
    for i in range(1, n - 1):
        p = 1.0 / (ddy[i - 1] + 4.0)
        ddy[i] = -p
        u[i] = ((6.0 * y[i + 1] - 12.0 * y[i] + 6.0 * y[i - 1])
                / (CMAPDX * CMAPDX) - u[i - 1]) * p
    ddy[n - 1] = 0.0
    for j in range(n - 2, -1, -1):
        ddy[j] = ddy[j] * ddy[j + 1] + u[j]
    return ddy


def _spline_value(tab, dd, ix, a, b):
    """The cubic spline's value between knots ix and ix+1 at weights a, b."""
    return (a * tab[ix] + b * tab[ix + 1]
            + ((a ** 3 - a) * dd[ix] + (b ** 3 - b) * dd[ix + 1])
            * (CMAPDX * CMAPDX) / 6.0)


def _spline_slope(tab, dd, ix, a2, b2):
    """Its derivative there, given a2 = 3 a^2 - 1 and b2 = 3 b^2 - 1."""
    return ((tab[ix + 1] - tab[ix]) / CMAPDX - a2 / 6.0 * CMAPDX * dd[ix]
            + b2 / 6.0 * CMAPDX * dd[ix + 1])


def _slope_weights(a, b):
    """(3 a^2 - 1, 3 b^2 - 1) as the reference forms them."""
    return 3.0 * a * a - 1.0, 3.0 * b * b - 1.0


def _weights(t):
    """The grid cell of angle t on the expanded axis and its spline
    weights: (ix, a, b)."""
    ix = int((t - CMAPXMIN) / CMAPDX)
    return (ix, (CMAPXMIN + (ix + 1) * CMAPDX - t) / CMAPDX,
            (t - CMAPXMIN - ix * CMAPDX) / CMAPDX)


def set_map_derivatives(m):
    """The periodic-expansion spline derivative grids (:839-936): m
    (24,24) -> (d1, d2, d12), each (24,24), in the JAX function's
    arithmetic order (its d/dphi slope squares the weights with ** 2,
    the others multiply them out), so the grids agree bit for bit."""
    xm = CMAPDIM // 2
    p = CMAPDIM
    two = CMAPDIM * 2
    shift = (np.arange(two) + CMAPDIM - xm) % CMAPDIM
    tmap = m[shift][:, shift]
    tddmap = np.stack([_spline(tmap[i]) for i in range(two)])
    d1o, d2o, d12o = np.zeros((p, p)), np.zeros((p, p)), np.zeros((p, p))
    # the expanded map's splines at each psi: the 48 rows' values and
    # slopes in one numpy pass (element by element the scalar arithmetic),
    # and their splines along phi, which do not depend on phi (the
    # reference forms them anew for every phi, to the same values)
    tmap_t, tdd_t = tmap.T, tddmap.T
    for j in range(xm, CMAPDIM + xm):
        ix, a, b = _weights((j - xm) * CMAPDX - 180.0)
        tmp_y = _spline_value(tmap_t, tdd_t, ix, a, b)
        tmp_dy = _spline_slope(tmap_t, tdd_t, ix, *_slope_weights(a, b))
        dd_y, dd_dy = _spline(tmp_y), _spline(tmp_dy)
        for i in range(xm, CMAPDIM + xm):
            ix, a, b = _weights((i - xm) * CMAPDX - 180.0)
            d1o[i % p, j % p] = _spline_slope(
                tmp_y, dd_y, ix, 3.0 * a ** 2 - 1.0, 3.0 * b ** 2 - 1.0)
            d2o[i % p, j % p] = _spline_value(tmp_dy, dd_dy, ix, a, b)
            d12o[i % p, j % p] = _spline_slope(tmp_dy, dd_dy, ix,
                                               *_slope_weights(a, b))
    return d1o, d2o, d12o


@dataclasses.dataclass(frozen=True)
class CMAPParams:
    """The JAX CMAPParams: atoms (M,5) 0-based atom rows, ctype (M,) the
    map 1..6 (0: no term), the (6,24,24) grid and its derivative grids;
    energy: fix_modify ID energy yes, the crossterm energy folded into the
    potential energy."""

    atoms: torch.Tensor
    ctype: torch.Tensor
    grid: torch.Tensor
    d1grid: torch.Tensor
    d2grid: torch.Tensor
    d12grid: torch.Tensor
    energy: bool = False


def make_cmap_params(cmapfile, crossterms, dtype=torch.float64,
                     device="cpu", energy=False) -> CMAPParams:
    """CMAPParams of the map file and the CMAP section's rows (M,6) [type
    a1..a5], 1-based atom ids (lidp_tpu make_cmap_params)."""
    grid = read_grid_map(cmapfile)
    d1, d2, d12 = (np.zeros_like(grid) for _ in range(3))
    for t in range(6):
        d1[t], d2[t], d12[t] = set_map_derivatives(grid[t])
    ct = np.asarray(crossterms, np.int64)
    if ct.size == 0:
        ct = np.zeros((1, 6), np.int64)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return CMAPParams(
        atoms=torch.as_tensor(ct[:, 1:6] - 1, device=device),
        ctype=torch.as_tensor(ct[:, 0], device=device), grid=t(grid),
        d1grid=t(d1), d2grid=t(d2), d12grid=t(d12), energy=energy)


def _dot(a, b):
    return torch.sum(a * b, dim=1)


def cmap_forces(x, p: CMAPParams, need_ev=True):
    """(f (N,3), ecmap, virial6) of the crossterms (post_force :307-603,
    over every row at once; lidp_tpu cmap_forces); the virial zero
    without need_ev, as the JAX function gives it."""
    ai = p.atoms
    x1, x2, x3, x4, x5 = (x[ai[:, k]] for k in range(5))
    valid = p.ctype > 0
    t1i = torch.clamp(p.ctype - 1, 0, 5)

    vb21, vb32, vb34, vb45 = x2 - x1, x3 - x2, x3 - x4, x4 - x5
    vb12, vb23, vb43, vb54 = -vb21, -vb32, -vb34, -vb45
    cross = torch.linalg.cross
    a1, b1 = cross(vb12, vb23), cross(vb43, vb23)
    a2, b2 = cross(vb23, vb34), cross(vb45, vb43)

    r32 = torch.sqrt(_dot(vb32, vb32))
    r43 = torch.sqrt(_dot(vb43, vb43))
    a1sq, b1sq = _dot(a1, a1), _dot(b1, b1)
    a2sq, b2sq = _dot(a2, a2), _dot(b2, b2)
    valid = (valid & (a1sq >= 1e-4) & (b1sq >= 1e-4) & (a2sq >= 1e-4)
             & (b2sq >= 1e-4))
    a1sq, b1sq, a2sq, b2sq, r32, r43 = (
        torch.where(v > 0, v, 1.0) for v in (a1sq, b1sq, a2sq, b2sq, r32,
                                             r43))

    dpr21r32, dpr34r32 = _dot(vb21, vb32), _dot(vb34, vb32)
    dpr32r43, dpr45r43 = _dot(vb32, vb43), _dot(vb45, vb43)
    rad2deg = 180.0 / math.pi

    def dihed(fv, av, bv, absg):
        return torch.atan2(absg * _dot(fv, bv), _dot(av, bv)) * rad2deg

    phi = dihed(vb21, a1, b1, r32)
    psi = dihed(vb32, a2, b2, r43)
    phi = torch.where(phi == 180.0, -180.0, phi)
    psi = torch.where(psi == 180.0, -180.0, psi)
    phi1 = torch.where(phi < 0.0, phi + 360.0, phi)
    psi1 = torch.where(psi < 0.0, psi + 360.0, psi)

    # the derivative grids' cell (truncated) and the map's (floored)
    li1 = ((phi1 + CMAPXMIN2) / CMAPDX + CMAPDIM / 2.0).to(torch.int64)
    li2 = ((psi1 + CMAPXMIN2) / CMAPDX + CMAPDIM / 2.0).to(torch.int64)
    li3 = torch.floor((phi - CMAPXMIN2) / CMAPDX).to(torch.int64)
    li4 = torch.floor((psi - CMAPXMIN2) / CMAPDX).to(torch.int64)

    def g4(gr, ia, ib):
        ia0, ib0 = ia % CMAPDIM, ib % CMAPDIM
        ia1, ib1 = (ia + 1) % CMAPDIM, (ib + 1) % CMAPDIM
        return torch.stack([gr[t1i, ia0, ib0], gr[t1i, ia1, ib0],
                            gr[t1i, ia1, ib1], gr[t1i, ia0, ib1]], dim=-1)

    xv = torch.cat([g4(p.grid, li3, li4), g4(p.d1grid, li1, li2) * CMAPDX,
                    g4(p.d2grid, li1, li2) * CMAPDX,
                    g4(p.d12grid, li1, li2) * (CMAPDX * CMAPDX)], dim=-1)
    wt = torch.as_tensor(_WT.T, dtype=x.dtype, device=x.device)
    cij = (xv @ wt).reshape(-1, 4, 4)

    # the grid axis: g_axis[low] = -180 + 15 low (init :168-179)
    t = (phi - (CMAPXMIN2 + li3.to(x.dtype) * CMAPDX)) / CMAPDX
    uu = (psi - (CMAPXMIN2 + li4.to(x.dtype) * CMAPDX)) / CMAPDX
    E = torch.zeros_like(phi)
    dEdPhi = torch.zeros_like(phi)
    dEdPsi = torch.zeros_like(phi)
    for i in range(3, -1, -1):
        E = t * E + ((cij[:, i, 3] * uu + cij[:, i, 2]) * uu
                     + cij[:, i, 1]) * uu + cij[:, i, 0]
        dEdPhi = uu * dEdPhi + (3.0 * cij[:, 3, i] * t
                                + 2.0 * cij[:, 2, i]) * t + cij[:, 1, i]
        dEdPsi = t * dEdPsi + (3.0 * cij[:, i, 3] * uu
                               + 2.0 * cij[:, i, 2]) * uu + cij[:, i, 1]
    E = torch.where(valid, E, 0.0)
    dP = torch.where(valid, dEdPhi * (rad2deg / CMAPDX), 0.0)[:, None]
    dS = torch.where(valid, dEdPsi * (rad2deg / CMAPDX), 0.0)[:, None]

    # dphi/dr and dpsi/dr (:497-530), then F = -(dE/dangle)(dangle/dr)
    def col(v):
        return v[:, None]

    c1 = col(r32 / a1sq)
    dphidr1 = c1 * a1
    dphidr2 = (-c1 * a1 - col(dpr21r32 / a1sq / r32) * a1
               + col(dpr34r32 / b1sq / r32) * b1)
    dphidr3 = (col(dpr34r32 / b1sq / r32) * b1
               - col(dpr21r32 / a1sq / r32) * a1 - col(r32 / b1sq) * b1)
    dphidr4 = col(r32 / b1sq) * b1
    c2 = col(r43 / a2sq)
    dpsidr1 = c2 * a2
    dpsidr2 = (c2 * a2 + col(dpr32r43 / a2sq / r43) * a2
               - col(dpr45r43 / b2sq / r43) * b2)
    dpsidr3 = (col(dpr45r43 / b2sq / r43) * b2
               - col(dpr32r43 / a2sq / r43) * a2 - col(r43 / b2sq) * b2)
    dpsidr4 = col(r43 / b2sq) * b2

    fs = (dP * dphidr1, dP * dphidr2 + dS * dpsidr1,
          -dP * dphidr3 - dS * dpsidr2, -dP * dphidr4 - dS * dpsidr3,
          -dS * dpsidr4)
    f = torch.zeros_like(x)
    for k, fk in enumerate(fs):
        f.index_add_(0, ai[:, k], fk)
    if need_ev:
        arms = (vb12, vb32, vb43 + vb32, vb54 + vb43 + vb32)
        pairs = tuple(zip(arms, (fs[0], fs[2], fs[3], fs[4])))
        vir = torch.stack([
            torch.sum(sum(d[:, a] * fv[:, b] for d, fv in pairs))
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])
    else:
        vir = x.new_zeros(6)
    return f, torch.sum(E), vir
