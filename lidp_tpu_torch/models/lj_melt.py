"""The bench/in.lj configuration: 32k-atom LJ melt, NVE
(lidp_tpu/models/lj_melt.py).

Mirrors the reference benchmark input (bench/in.lj): fcc lattice at reduced
density 0.8442, 20x20x20 cells (x scale factors supported), T*=1.44
velocities seeded geometrically (seed 87287), lj/cut 2.5, neighbor skin 0.3
rebuilt every 20 steps without checking.

    melt = build(scale=1, dtype=torch.float32, neighbor="slots")  # on the GPU
    sys, res, nlist, istate = melt.runner.setup(melt.system)
    sys, res, nlist, istate = melt.runner.run(sys, res, nlist, istate, 100)
    row = thermo_row(sys, res, melt.thermo)      # Python floats
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from lidp_tpu_torch import lattice, resolve_device, units, velocity
from lidp_tpu_torch.box import Box
from lidp_tpu_torch.forcefield import ForceField
from lidp_tpu_torch.integrate import nve
from lidp_tpu_torch.integrate.driver import Runner, nve_integrator
from lidp_tpu_torch.integrate.slot_runner import SlotRunner
from lidp_tpu_torch.ops.cells import CellConfig
from lidp_tpu_torch.ops.pair import make_pair_params
from lidp_tpu_torch.state import System, make_system
from lidp_tpu_torch.thermo import ThermoParams


@dataclasses.dataclass
class LJMelt:
    system: System
    runner: Any          # Runner or SlotRunner
    thermo: ThermoParams
    natoms: int


def _lj_cut_pair(dtype, device):
    """One atom type, epsilon = sigma = 1, lj/cut 2.5, unshifted."""
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    return make_pair_params(one, one, 2.5 * one, coul=False, dtype=dtype,
                            device=device)


def build(scale: float = 1, dtype=torch.float64, *, neighbor: str = "cells",
          bin_cap: int = 40, compensated: bool = False,
          cap_slack: float | None = None, device="cuda") -> LJMelt:
    """neighbor: 'cells' (generic Runner on the cell grid) or 'slots'
    (SlotRunner, state in cell-slot order).  The JAX package's 'list'
    (neighbor lists) and 'none' (dense all-pairs) are not ported.
    `bin_cap` sizes the bins of a neighbor list and nothing else: it is
    accepted for the JAX signature and read by neither ported mode."""
    if neighbor in ("list", "none"):
        raise NotImplementedError(
            f"neighbor={neighbor!r} needs ops/neighbor.py or the dense "
            f"route, which are not ported (ROADMAP queue 1 items 3-4); use "
            f"'cells' or 'slots'")
    if neighbor not in ("cells", "slots"):
        raise ValueError(f"unknown neighbor mode {neighbor!r}")
    device = resolve_device(device)
    u = units.LJ
    rho, nx = 0.8442, int(round(20 * scale))
    a = lattice.lattice_spacing("fcc", rho)
    x_np, hi = lattice.create_atoms_box("fcc", a, nx, nx, nx)
    n = x_np.shape[0]

    v_np = velocity.create(
        x_np, np.ones(n), 1.44, 87287, units=u, dist="uniform", loop="geom")

    box = Box.create(np.zeros(3), hi, dtype=dtype, device=device)
    sys = make_system(x_np, box=box, v=v_np, dtype=dtype, device=device)

    ff = ForceField(pair=_lj_cut_pair(dtype, device))

    # slack 1.5 (cap 40 at this density) holds the melt's density
    # fluctuations up to about 110,000 atoms; the largest cell occupancy is
    # an extreme-value statistic over the number of cells, so bigger boxes
    # get 1.75.  Overflow is carried sticky through a run and checked at
    # its end.
    if cap_slack is None:
        cap_slack = 1.5 if n <= 110_000 else 1.75
    ncfg = CellConfig.for_box(hi, 2.5 + u.skin, density=rho,
                              cap_slack=cap_slack)

    tp = ThermoParams.create(np.ones(n), dof=3 * n - 3, units=u, norm=True,
                             natoms=n, dtype=dtype, device=device)
    if neighbor == "slots":
        runner = SlotRunner(ff=ff, neighbor_cfg=ncfg, dt=u.dt,
                            ftm2v=u.ftm2v, n=n, rebuild_every=20)
        return LJMelt(system=sys, runner=runner, thermo=tp, natoms=n)

    nvep = nve.NVEParams.create(u.dt, u.ftm2v, np.ones(n), dtype=dtype,
                                device=device)
    runner = Runner(ff=ff, integ=nve_integrator(nvep, compensated=compensated),
                    neighbor_cfg=ncfg, rebuild_every=20)
    return LJMelt(system=sys, runner=runner, thermo=tp, natoms=n)

