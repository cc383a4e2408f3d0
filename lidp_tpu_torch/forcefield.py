"""Force-field composition (lidp_tpu/forcefield.py).

`ForceField` is the container the panel engine (parallel/shard.py) and the
cell engine read.  `compute_forces` is ported for the cell engine's pair
term: a non-polar force field evaluated on a `Cells` grid.  The dense
all-pairs route (`nlist=None`), neighbour lists, k-space, bonded terms and
the polar term through this function wait (ROADMAP queue 1 items 3-5);
they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lidp_tpu_torch.ops.ewald import EwaldParams
from lidp_tpu_torch.ops.pair import PairParams
from lidp_tpu_torch.ops.polarization import PolarizationSettings


@dataclasses.dataclass(frozen=True)
class ForceField:
    pair: PairParams
    ewald: Optional[EwaldParams] = None
    polar: Optional[PolarizationSettings] = None
    qqrd2e: float = 1.0
    # (N,3) numpy: the shift that wraps the positions of the run's start
    # into the box, frozen for the polar F.r virial (the script engine
    # sets it, as the JAX package's Simulation does)
    polar_xshift: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class ForceResult:
    f: torch.Tensor
    evdwl: torch.Tensor
    ecoul: torch.Tensor
    elong: torch.Tensor
    epol: torch.Tensor
    ebond: torch.Tensor
    virial: torch.Tensor       # (6,) xx yy zz xy xz yz
    mu: torch.Tensor           # induced dipoles after SCF
    scf_iters: torch.Tensor
    scf_diverged: torch.Tensor
    eangle: torch.Tensor | float = 0.0
    edihed: torch.Tensor | float = 0.0
    eimp: torch.Tensor | float = 0.0
    ecmap: torch.Tensor | float = 0.0
    efix: torch.Tensor | float = 0.0

    @property
    def epair(self):
        """Thermo E_pair = evdwl + ecoul + elong + epol (pair + kspace)."""
        return self.evdwl + self.ecoul + self.elong + self.epol

    @property
    def emol(self):
        """Thermo E_mol = bond + angle + dihedral + improper."""
        return self.ebond + self.eangle + self.edihed + self.eimp

    @property
    def pe(self):
        """Total potential: E_pair + E_mol + fix energies."""
        return self.epair + self.emol + self.efix


def pair_only_result(sys, f, evdwl, ecoul, virial) -> ForceResult:
    """ForceResult of a pair term alone: every other energy is one shared
    zero, the dipoles are the system's."""
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    izero = torch.zeros((), dtype=torch.int32, device=f.device)
    return ForceResult(
        f=f, evdwl=evdwl, ecoul=ecoul, elong=zero, epol=zero, ebond=zero,
        virial=virial, mu=sys.mu, scf_iters=izero,
        scf_diverged=izero.to(torch.bool))


def pair_route(sys, ff, cells) -> str:
    """Which function compute_forces evaluates the pair term with on this
    grid: "cell_pair_forces_lj" (the CUDA kernel on a GPU) or
    "cell_pair_forces" (plain PyTorch, on a GPU too).  The kernel's gate is
    the JAX package's _pallas_ok without its backend test: lj/cut alone, one
    atom type, float32, an orthogonal fully periodic box, at least 3 bins in
    every dimension.  A benchmark asks here which route its times are of."""
    from lidp_tpu_torch.ops.cell_kernels import supported

    p = ff.pair
    ok = (supported(p, p.lj3.shape[0] - 1 > 1, p.coul)
          and sys.x.dtype == torch.float32
          and not sys.box.triclinic and all(sys.box.periodic)
          and min(cells.atom_of_slot.shape[:3]) >= 3)
    return "cell_pair_forces_lj" if ok else "cell_pair_forces"


def compute_forces(sys, ff: ForceField, nlist=None,
                   need_ev: bool = True) -> ForceResult:
    """Evaluate the pair term of a non-polar force field on a Cells grid.

    The single-type float32 LJ case goes to the CUDA kernel
    (ops/cell_kernels.cell_pair_forces_lj); every other case (float64,
    several types, coulomb, an open face, a dimension of one bin) to the
    plain roll kernel ops/cells.cell_pair_forces, on the GPU too;
    `pair_route` names the one taken.
    need_ev=False skips the energy and virial sums (zeros are returned)."""
    from lidp_tpu_torch.ops.cell_kernels import cell_pair_forces_lj
    from lidp_tpu_torch.ops.cells import Cells, cell_pair_forces

    if ff.polar is not None or ff.ewald is not None:
        raise NotImplementedError(
            "compute_forces with a polar or k-space term is not ported: the "
            "polarizable step runs on the panel engine (parallel/shard.py); "
            "ROADMAP queue 1 item 3, the dense route")
    if nlist is None:
        raise NotImplementedError(
            "the dense all-pairs route of compute_forces is not ported "
            "(ops/pair.dense_pair_forces; ROADMAP queue 1 item 3)")
    if not isinstance(nlist, Cells):
        raise NotImplementedError(
            "neighbour lists are not ported (ops/neighbor.py; ROADMAP "
            "queue 1 item 4)")
    if pair_route(sys, ff, nlist) == "cell_pair_forces_lj":
        f, ev, ec, vir = cell_pair_forces_lj(
            sys.x, sys.mask, nlist, sys.box, ff.pair, need_ev=need_ev)
    else:
        f, ev, ec, vir = cell_pair_forces(
            sys.x, sys.q, sys.type, sys.mask, nlist, sys.box, ff.pair,
            need_ev=need_ev)
    return pair_only_result(sys, f, ev, ec, vir)
