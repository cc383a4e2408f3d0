"""Force-field composition (lidp_tpu/forcefield.py).

`ForceField` is the container the panel engine (parallel/shard.py), the
cell engine and the dense route read.  `compute_forces` evaluates either
the dense route (`nlist=None`: the all-pairs LJ + coulomb pass, the Ewald
sum and the polarization term on (N,N) tensors, in the JAX package's
order) or the pair term of a non-polar force field on a `Cells` grid.
Neighbour lists (ROADMAP queue 1 item 5), bonded terms and the other
k-space styles (item 6) raise NotImplementedError.
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
    # (N,3): the shift that wraps the positions of the run's start into
    # the box, frozen for the polar F.r virial (the script engine sets it,
    # as the JAX package's Simulation does); numpy for the panel engine, a
    # tensor on the dense route
    polar_xshift: Optional[object] = None
    # (N,N) int8 special-bond codes of the dense pair pass
    # (topology.special_codes_dense), None for no special pairs
    sp_code: Optional[torch.Tensor] = None
    # validation: the serial Gauss-Seidel solve (scf_solve_gauss_seidel)
    # in place of scf_solve under polar_gs / polar_gs_ranked
    reference_gs: bool = False


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
    """Evaluate the force field.

    nlist=None: the dense route (dense_forces), every term the force
    field holds.  A Cells grid: the pair term of a non-polar force field;
    the single-type float32 LJ case goes to the CUDA kernel
    (ops/cell_kernels.cell_pair_forces_lj), every other case (float64,
    several types, coulomb, an open face, a dimension of one bin) to the
    plain roll kernel ops/cells.cell_pair_forces, on the GPU too;
    `pair_route` names the one taken.
    need_ev=False skips the cell route's energy and virial sums (zeros are
    returned); the dense route computes them always, as in the JAX
    package."""
    from lidp_tpu_torch.ops.cell_kernels import cell_pair_forces_lj
    from lidp_tpu_torch.ops.cells import Cells, cell_pair_forces

    if nlist is None:
        return dense_forces(sys, ff)
    if not isinstance(nlist, Cells):
        raise NotImplementedError(
            "neighbour lists are not ported (ops/neighbor.py; ROADMAP "
            "queue 1 item 5, neighbour lists)")
    if ff.polar is not None or ff.ewald is not None or ff.pair.excl_mol:
        raise NotImplementedError(
            "a polar or k-space term or excl_mol on a cell grid is not "
            "ported: the port runs them on the dense route (nlist=None) "
            "or the panel engine (ROADMAP queue 1 item 6, breadth)")
    if pair_route(sys, ff, nlist) == "cell_pair_forces_lj":
        f, ev, ec, vir = cell_pair_forces_lj(
            sys.x, sys.mask, nlist, sys.box, ff.pair, need_ev=need_ev)
    else:
        f, ev, ec, vir = cell_pair_forces(
            sys.x, sys.q, sys.type, sys.mask, nlist, sys.box, ff.pair,
            need_ev=need_ev)
    return pair_only_result(sys, f, ev, ec, vir)


def dense_forces(sys, ff: ForceField) -> ForceResult:
    """The dense route of lidp_tpu/forcefield.py compute_forces
    (nlist=None) in its order: the all-pairs LJ + coulomb pass with the
    special codes, the Ewald sum, then the polarization term (the Wolf
    field E0, the (N,3,N,3) tensor, the dipole solve from sys.mu under
    use_previous, the polar forces and epol).  Plain PyTorch on (N,N)
    tensors: no kernel of ops/panel.py runs here."""
    from lidp_tpu_torch.ops import ewald as ewald_ops
    from lidp_tpu_torch.ops import pair as pair_ops
    from lidp_tpu_torch.ops import polarization as pol_ops

    x = sys.x
    zero = x.new_zeros(())
    f = torch.zeros_like(x)
    evdwl = ecoul = elong = epol = zero
    virial = x.new_zeros(6)
    mu = sys.mu
    scf_iters = 0
    scf_diverged = torch.zeros((), dtype=torch.bool, device=x.device)

    if ff.pair is not None:
        sp = ff.sp_code if ff.sp_code is not None else 0
        fp, ev, ec, vir = pair_ops.dense_pair_forces(
            x, sys.q, sys.type, sp, sys.mask, sys.box, ff.pair, mol=sys.mol)
        f = f + fp
        evdwl, ecoul = evdwl + ev, ecoul + ec
        virial = virial + vir

    if ff.ewald is not None:
        fk, el, vk = ewald_ops.ewald_forces(x, sys.q, sys.box.volume,
                                            ff.ewald)
        f = f + fk
        elong = elong + el
        virial = virial + vk

    if ff.polar is not None:
        s = ff.polar
        e0 = pol_ops.static_field_wolf(x, sys.q, sys.mol, sys.mask, sys.box,
                                       ff.pair.cut_coulsq, ff.qqrd2e)
        tensor = pol_ops.dipole_field_tensor(x, sys.alpha, sys.mask,
                                             sys.box, s)
        mu_init = sys.mu if s.use_previous else None
        if ff.reference_gs and (s.polar_gs or s.polar_gs_ranked):
            rank = pol_ops.rank_metric_compute(x, sys.alpha, sys.mol,
                                               sys.mask, sys.box)
            mu, scf_iters, scf_diverged = pol_ops.scf_solve_gauss_seidel(
                e0, sys.alpha, tensor, s, rank_metric=rank, mu_init=mu_init)
        else:
            mu, scf_iters, scf_diverged = pol_ops.scf_solve(
                e0, sys.alpha, tensor, s, mu_init=mu_init)
        del tensor      # its N^2 x 9 values go before the dipole pass's
        fpol, upol, vpol = pol_ops.dipole_forces_energy(
            x, sys.q, sys.mol, sys.alpha, mu, sys.mask, sys.box,
            ff.pair.cut_coulsq, ff.qqrd2e, s, xshift=ff.polar_xshift)
        f = f + fpol
        epol = epol + upol
        virial = virial + vpol

    return ForceResult(
        f=f, evdwl=evdwl, ecoul=ecoul, elong=elong, epol=epol, ebond=zero,
        virial=virial, mu=mu,
        scf_iters=torch.tensor(scf_iters, dtype=torch.int32,
                               device=x.device),
        scf_diverged=scf_diverged)
