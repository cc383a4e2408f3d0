"""`velocity ... create` — initial velocity generation.

Bit-compatible with the reference Velocity::create (velocity.cpp:165-410):
  * ``loop all``  — one sequential RanPark stream over global atom ids;
  * ``loop geom`` — per-atom streams seeded by the Jenkins hash of (seed, x);
  * ``mom yes`` / ``rot yes`` zeroing and rescale to the target temperature
    using the group temperature with dof = dim*N - dim (no fixes defined yet
    at velocity-command time in all bundled inputs).

Host-side numpy; runs once at setup.  An own copy of lidp_tpu/velocity.py
(`loop all` always takes the Python RanPark loop).
"""

from __future__ import annotations

import numpy as np

from lidp_tpu_torch import rng
from lidp_tpu_torch.units import Units


def _temperature(v, mass_per_atom, units: Units, dof: float) -> float:
    ke2 = float(np.sum(mass_per_atom[:, None] * v * v)) * units.mvv2e
    return ke2 / (dof * units.boltz)


def create(
    x: np.ndarray,
    mass_per_atom: np.ndarray,
    t_desired: float,
    seed: int,
    *,
    units: Units,
    dist: str = "uniform",
    loop: str = "all",
    momentum: bool = False,
    rotation: bool = False,
    dim: int = 3,
    image: np.ndarray | None = None,
    box_lengths: np.ndarray | None = None,
    group: np.ndarray | None = None,
    v_prev: np.ndarray | None = None,
    temp_group: np.ndarray | None = None,
) -> np.ndarray:
    """group: velocity-group mask — the RNG stream is consumed for ALL atoms
    (loop all, velocity.cpp:278-304) but velocities are assigned, momentum-
    zeroed and rescaled only on group members.  temp_group: the rescale
    temperature compute's group (velocity ... temp ID), defaults to `group`.
    """
    n = x.shape[0]
    v = np.zeros((n, 3))
    factor = 1.0 / np.sqrt(mass_per_atom)

    if loop == "all":
        draws = np.zeros((n, 3))
        r = rng.RanPark(seed)
        for i in range(n):
            if dist == "uniform":
                draws[i] = (r.uniform() - 0.5, r.uniform() - 0.5,
                            r.uniform() - 0.5)
            else:
                draws[i] = (r.gaussian(), r.gaussian(), r.gaussian())
        v = draws * factor[:, None]
    elif loop == "geom":
        streams = rng.park_geom_streams(seed, x)
        if dist == "uniform":
            g = np.stack(streams.uniform3(), axis=-1) - 0.5
        else:
            g = np.stack(streams.gaussian3(), axis=-1)
        v = g * factor[:, None]
    else:
        raise ValueError(f"unsupported velocity loop style: {loop}")

    if dim == 2:
        v[:, 2] = 0.0

    if group is not None:
        base = v_prev if v_prev is not None else np.zeros((n, 3))
        v = np.where(group[:, None], v, base)
    gm = group if group is not None else np.ones(n, bool)

    xu = x
    if image is not None and box_lengths is not None:
        xu = x + image * box_lengths

    if momentum:
        m = mass_per_atom[gm]
        vcm = (m[:, None] * v[gm]).sum(0) / m.sum()
        v[gm] -= vcm
    if rotation:
        # like the momentum branch: angular momentum/inertia from the
        # velocity group only, correction applied to group members only
        # (Velocity::zero_rotation acts on the group, velocity.cpp:742)
        m = mass_per_atom[gm]
        xg = xu[gm]
        xcm = (m[:, None] * xg).sum(0) / m.sum()
        d = xg - xcm
        L = (m[:, None] * np.cross(d, v[gm])).sum(0)
        inertia = np.zeros((3, 3))
        inertia[0, 0] = np.sum(m * (d[:, 1] ** 2 + d[:, 2] ** 2))
        inertia[1, 1] = np.sum(m * (d[:, 0] ** 2 + d[:, 2] ** 2))
        inertia[2, 2] = np.sum(m * (d[:, 0] ** 2 + d[:, 1] ** 2))
        inertia[0, 1] = inertia[1, 0] = -np.sum(m * d[:, 0] * d[:, 1])
        inertia[0, 2] = inertia[2, 0] = -np.sum(m * d[:, 0] * d[:, 2])
        inertia[1, 2] = inertia[2, 1] = -np.sum(m * d[:, 1] * d[:, 2])
        omega = np.linalg.solve(inertia, L)
        v[gm] -= np.cross(omega, d)

    tg = temp_group if temp_group is not None else gm
    ng = int(np.count_nonzero(tg))
    dof = dim * ng - dim  # ComputeTemp: extra_dof = dim, no fixes yet
    t_current = _temperature(v[tg], mass_per_atom[tg], units, dof)
    if t_current == 0.0:
        raise ValueError("Attempting to rescale a 0.0 temperature")
    # Velocity::rescale scales only the velocity group's atoms
    v[gm] *= np.sqrt(t_desired / t_current)
    return v


def ramp(x, v, group, v_dim: int, v_lo: float, v_hi: float,
         coord_dim: int, coord_lo: float, coord_hi: float,
         sum_flag: bool) -> np.ndarray:
    """velocity ... ramp (velocity.cpp:631): linear ramp of one velocity
    component against one coordinate, clamped outside [coord_lo, coord_hi];
    `sum yes` adds to the existing component."""
    frac = np.clip((x[:, coord_dim] - coord_lo) / (coord_hi - coord_lo),
                   0.0, 1.0)
    vramp = v_lo + frac * (v_hi - v_lo)
    out = v.copy()
    if sum_flag:
        out[group, v_dim] += vramp[group]
    else:
        out[group, v_dim] = vramp[group]
    return out
