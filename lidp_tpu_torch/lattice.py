"""Lattices and atom creation (`lattice` + `create_atoms` commands).

Reproduces the reference semantics (lattice.cpp, create_atoms.cpp):
``lattice STYLE RHO`` in lj units sets the scale from the reduced density
(scale = (nbasis/(Vprimitive*rho))^(1/dim), lattice.cpp:258-264) and
``create_atoms ... box`` fills the box with basis atoms using the reference's
epsilon-shrunk insertion test (create_atoms.cpp:284-328).  numpy only; an
own copy of lidp_tpu/lattice.py.
"""

from __future__ import annotations

import numpy as np

_BASES = {
    "fcc": np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    ),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "sc": np.array([[0.0, 0.0, 0.0]]),
    # 2d styles (lattice.cpp: sq, sq2, hex)
    "sq": np.array([[0.0, 0.0, 0.0]]),
    "sq2": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
    "hex": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
}

# primitive cell vectors diverging from the identity (lattice.cpp:150-155);
# (a1x, a2y, a3z) — all styles here are axis-aligned
_CELL = {
    "hex": np.array([1.0, np.sqrt(3.0), 1.0]),
}


def lattice_spacing3(style: str, scale: float, units: str = "lj",
                     dim: int = 3) -> np.ndarray:
    """Per-axis lattice spacings (xlattice, ylattice, zlattice)."""
    basis = _BASES[style]
    cell = _CELL.get(style, np.ones(3))
    if units == "lj":
        # scale is the reduced density rho*; the reference's exact
        # division order (lattice.cpp:264 nbasis/volume/rho) matters for
        # bit-exact coordinates -> geometry-hashed velocity streams
        vprim = float(np.prod(cell[:dim]))
        a = (len(basis) / vprim / scale) ** (1.0 / dim)
    else:
        a = float(scale)
    return cell * a


def lattice_spacing(style: str, scale: float, units: str = "lj",
                    dim: int = 3) -> float:
    """Scalar spacing for cubic/square lattices (legacy callers)."""
    s3 = lattice_spacing3(style, scale, units, dim)
    return float(s3[0])


def create_atoms_box(style: str, spacing, nx: int, ny: int, nz: int):
    """Fill an (nx, ny, nz)-cell orthogonal box with lattice-basis atoms.

    Returns (positions (N,3) float64, box_hi (3,)). Box lo is the origin.
    Iteration order is (k, j, i, basis) like create_atoms, though downstream
    consumers here do not depend on atom order (velocities are geometry-seeded).
    For 2d lattices pass nz=1; basis z components are all 0.
    """
    basis = _BASES[style]
    spacing = np.broadcast_to(np.asarray(spacing, np.float64), (3,))
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    cells = np.stack([i, j, k], axis=-1).reshape(-1, 1, 3).astype(np.float64)
    pts = (cells + basis[None, None, :, :].reshape(1, len(basis), 3)).reshape(-1, 3)
    pts = pts * spacing
    hi = np.array([nx, ny, nz], np.float64) * spacing
    return pts, hi


def create_atoms_bounds(style: str, spacing, box_lo, box_hi):
    """Fill [box_lo, box_hi) with lattice atoms, reference insertion rule.

    create_atoms.cpp:284-328 (single rank): the insertion box is
    [boxlo - eps, boxhi - 2*eps) with eps = L * 1e-6, so sites sitting
    exactly on a shrink-expanded upper face are kept while the periodic
    upper face site (== boxhi) is excluded.  Iteration order (k, j, i,
    basis) fixes atom IDs for loop-all velocity streams.
    """
    basis = _BASES[style]
    s = np.broadcast_to(np.asarray(spacing, np.float64), (3,))
    cell = _CELL.get(style, np.ones(3))
    # Lattice::lattice2box (lattice.cpp:476-492) computes
    # (primitive . lattice_coord) * scale; replicate that multiply order
    # exactly — velocity `loop geom` streams hash the coordinate BITS.
    # s == cell * a with cell[0] == 1 for every supported style.
    a = s[0]
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    eps = (hi - lo) * 1.0e-6
    ins_lo = lo - eps
    ins_hi = hi - 2.0 * eps
    ilo = np.floor(lo / s).astype(int) - 1
    ihi = np.ceil(hi / s).astype(int) + 1
    k, j, i = np.meshgrid(np.arange(ilo[2], ihi[2] + 1),
                          np.arange(ilo[1], ihi[1] + 1),
                          np.arange(ilo[0], ihi[0] + 1), indexing="ij")
    cells = np.stack([i, j, k], axis=-1).reshape(-1, 1, 3).astype(np.float64)
    pts = (cells + basis[None, None, :, :].reshape(1, len(basis), 3))
    pts = (pts.reshape(-1, 3) * cell) * a
    keep = np.all((pts >= ins_lo) & (pts < ins_hi), axis=1)
    return pts[keep]
