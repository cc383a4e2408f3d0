"""Force-field composition (lidp_tpu/forcefield.py).

`ForceField` is the container the panel engine (parallel/shard.py), the
cell engine and the dense route read.  `compute_forces` evaluates, in the
JAX package's order, the pair term (the all-pairs pass of the dense route,
`nlist=None`, with the special codes; or the cell grid of a `Cells`, with
the sparse special-bond correction unless same-molecule pairs are
excluded), then the k-space term (the Ewald sum, rescaled to the live box
under a barostat, or PPPM, which reads the live box at every call) and
the polarization term on (N,N) tensors.  The bonded terms (bond, angle,
dihedral with the CHARMM weighted 1-4 term into E_vdwl and E_coul, and
improper; ops/bonded.py) come after the pair term on either route, as in
the JAX package.  The many-body EAM term (pair_style eam, eam/alloy,
eam/fs; ops/eam.py) takes the pair term's place on a `Cells` grid, with
`pair` None; the dense route raises for it, as the JAX package's does.
Neighbour lists (ROADMAP queue 1 item 5) and the other k-space styles
(item 6) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lidp_tpu_torch.ops.ewald import EwaldParams
from lidp_tpu_torch.ops.pair import PairParams
from lidp_tpu_torch.ops.polarization import PolarizationSettings
from lidp_tpu_torch.ops.pppm import PPPMParams


@dataclasses.dataclass(frozen=True)
class ForceField:
    # None under EAM (the JAX package's ForceField(pair=None, eam=...))
    pair: Optional[PairParams]
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
    # (N,S) special lists of the cell grid's correction
    # (topology.special_lists: partner indices, the fill at N, and their
    # levels 1-3), None for no special pairs
    sp_idx: Optional[torch.Tensor] = None
    sp_lvl: Optional[torch.Tensor] = None
    # validation: the serial Gauss-Seidel solve (scf_solve_gauss_seidel)
    # in place of scf_solve under polar_gs / polar_gs_ranked
    reference_gs: bool = False
    # the mesh k-space (kspace_style pppm, pppm/cg, pppm/stagger) in place
    # of the Ewald sum
    pppm: Optional[PPPMParams] = None
    # a barostat moves the box: the Ewald tables are recomputed for the
    # live box at each call (rescale_coeffs; the analog of
    # force->kspace->setup(), fix_nh.cpp:877)
    kspace_dynamic: bool = False
    # the bonded terms: tuples of ops.bonded BondParams, AngleParams,
    # DihedralParams and ImproperParams, one per hybrid sub-style; () for
    # none
    bond: tuple = ()
    angle: tuple = ()
    dihedral: tuple = ()
    improper: tuple = ()
    # pair_style eam / eam/alloy / eam/fs: an ops.eam EAMParams or
    # EAMAlloyParams, evaluated on the cell grid in place of the pair term
    eam: Optional[object] = None


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


def pair_only_result(sys, f, evdwl, ecoul, virial,
                     bonded=None) -> ForceResult:
    """ForceResult of a pair term (and the bonded terms' energies
    `bonded`, a dict of ebond, eangle, edihed, eimp) alone: every other
    energy is one shared zero, the dipoles are the system's."""
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    izero = torch.zeros((), dtype=torch.int32, device=f.device)
    return ForceResult(
        f=f, evdwl=evdwl, ecoul=ecoul, elong=zero, epol=zero,
        virial=virial, mu=sys.mu, scf_iters=izero,
        scf_diverged=izero.to(torch.bool),
        **(bonded or dict(ebond=zero)))


def bonded_terms(sys, ff: ForceField, f, evdwl, ecoul, virial):
    """The bonded block of lidp_tpu/forcefield.py compute_forces (:326-380)
    in its order: each bond style (quartic's pair subtraction into E_vdwl
    and the virial), angle style, dihedral style (the charmm dihedral's
    weighted 1-4 term into E_vdwl and E_coul, as the reference tallies
    it) and improper style, summed onto the pair term's f, evdwl, ecoul and
    virial.  Returns (f, evdwl, ecoul, virial, {ebond, eangle, edihed,
    eimp})."""
    from lidp_tpu_torch.ops import bonded as bonded_ops

    x = sys.x
    e = {k: x.new_zeros(()) for k in ("ebond", "eangle", "edihed", "eimp")}
    for bp in ff.bond:
        if bp.style == "quartic":
            fb, eb, vb, dev, dvp = bonded_ops.bond_quartic_full(x, sys.box,
                                                                bp)
            evdwl = evdwl + dev
            virial = virial + dvp
        else:
            fb, eb, vb = bonded_ops.bond_forces(x, sys.box, bp)
        f, virial = f + fb, virial + vb
        e["ebond"] = e["ebond"] + eb
    for ap in ff.angle:
        fa, ea, va = bonded_ops.angle_forces(x, sys.box, ap)
        f, virial = f + fa, virial + va
        e["eangle"] = e["eangle"] + ea
    for dp in ff.dihedral:
        fd, ed, vd = bonded_ops.dihedral_forces(x, sys.box, dp)
        f, virial = f + fd, virial + vd
        e["edihed"] = e["edihed"] + ed
        if dp.style in ("charmm", "charmmfsw") and dp.q is not None:
            f14, ev14, ec14, v14 = bonded_ops.charmm_14_forces(x, sys.box,
                                                               dp)
            f, virial = f + f14, virial + v14
            evdwl, ecoul = evdwl + ev14, ecoul + ec14
    for ip in ff.improper:
        fi, ei, vi = bonded_ops.improper_forces(x, sys.box, ip)
        f, virial = f + fi, virial + vi
        e["eimp"] = e["eimp"] + ei
    return f, evdwl, ecoul, virial, e


def pair_route(sys, ff, cells) -> str:
    """Which function compute_forces evaluates the pair term with on this
    grid: "cell_pair_forces_lj" (the CUDA kernel on a GPU) or
    "cell_pair_forces" (plain PyTorch, on a GPU too); under EAM
    "eam_cell_forces" or "eam_alloy_cell_forces" (ops/eam.py, plain
    PyTorch).  The kernel's gate is
    the JAX package's _pallas_ok without its backend test: lj/cut alone, one
    atom type, no special lists, float32, an orthogonal fully periodic box,
    at least 3 bins in every dimension, and no neigh_modify exclusion.  A
    benchmark asks here which route its times are of."""
    from lidp_tpu_torch.ops.cell_kernels import supported
    from lidp_tpu_torch.ops.eam import EAMAlloyParams

    if ff.eam is not None:
        return ("eam_alloy_cell_forces" if isinstance(ff.eam, EAMAlloyParams)
                else "eam_cell_forces")
    p = ff.pair
    ok = (supported(p, p.lj3.shape[0] - 1 > 1, p.coul)
          and p.excl is None and not p.excl_mol
          and ff.sp_idx is None and sys.x.dtype == torch.float32
          and not sys.box.triclinic and all(sys.box.periodic)
          and min(cells.atom_of_slot.shape[:3]) >= 3)
    return "cell_pair_forces_lj" if ok else "cell_pair_forces"


def compute_forces(sys, ff: ForceField, nlist=None,
                   need_ev: bool = True) -> ForceResult:
    """Evaluate the force field (lidp_tpu/forcefield.py compute_forces).

    nlist=None: the dense route (dense_forces), every term the force field
    holds.  A Cells grid: the pair term on the grid, then the sparse
    special-bond correction where the force field has special lists (not
    with excl_mol, as in the JAX package), the k-space term and the
    polarization term of the dense route.  The pair term
    of the single-type float32 LJ case goes to the CUDA kernel
    (ops/cell_kernels.cell_pair_forces_lj), every other case (float64,
    several types, coulomb, special lists, an open face, a dimension of
    one bin) to the plain roll kernel ops/cells.cell_pair_forces, on the
    GPU too; EAM to ops/eam.py's two passes; `pair_route` names the one
    taken.
    need_ev=False skips the cell pair term's energy and virial sums (zeros
    are returned for them); the correction, the Ewald sum and the
    polarization term compute theirs always, as in the JAX package."""
    from lidp_tpu_torch.ops.bonded import special_correction_sparse
    from lidp_tpu_torch.ops.cell_kernels import cell_pair_forces_lj
    from lidp_tpu_torch.ops.cells import Cells, cell_pair_forces
    from lidp_tpu_torch.ops.eam import eam_alloy_cell_forces, eam_cell_forces

    if nlist is None:
        return dense_forces(sys, ff)
    if not isinstance(nlist, Cells):
        raise NotImplementedError(
            "neighbour lists are not ported (ops/neighbor.py; ROADMAP "
            "queue 1 item 5, neighbour lists)")
    route = pair_route(sys, ff, nlist)
    if route == "eam_alloy_cell_forces":
        f, ev, vir = eam_alloy_cell_forces(
            sys.x, sys.type, sys.mask, nlist, sys.box, ff.eam,
            need_ev=need_ev)
        ec = ev.new_zeros(())
    elif route == "eam_cell_forces":
        f, ev, vir = eam_cell_forces(sys.x, sys.mask, nlist, sys.box, ff.eam,
                                     need_ev=need_ev)
        ec = ev.new_zeros(())
    elif route == "cell_pair_forces_lj":
        f, ev, ec, vir = cell_pair_forces_lj(
            sys.x, sys.mask, nlist, sys.box, ff.pair, need_ev=need_ev)
    else:
        f, ev, ec, vir = cell_pair_forces(
            sys.x, sys.q, sys.type, sys.mask, nlist, sys.box, ff.pair,
            need_ev=need_ev, mol=sys.mol)
    if ff.sp_idx is not None and not ff.pair.excl_mol:
        fc, dev, dec, dvir = special_correction_sparse(
            sys.x, sys.q, sys.type, ff.sp_idx, ff.sp_lvl, sys.mask, sys.box,
            ff.pair)
        f, ev, ec, vir = f + fc, ev + dev, ec + dec, vir + dvir
    f, ev, ec, vir, bonded = bonded_terms(sys, ff, f, ev, ec, vir)
    if ff.ewald is None and ff.pppm is None and ff.polar is None:
        return pair_only_result(sys, f, ev, ec, vir, bonded)
    return _long_range_terms(sys, ff, f, ev, ec, vir, bonded)


def dense_forces(sys, ff: ForceField) -> ForceResult:
    """The dense route of lidp_tpu/forcefield.py compute_forces
    (nlist=None) in its order: the all-pairs LJ + coulomb pass with the
    special codes, the bonded terms (bonded_terms), then the k-space sum
    and the polarization term (_long_range_terms).  Plain PyTorch on
    (N,N) tensors: no kernel of ops/panel.py runs here."""
    from lidp_tpu_torch.ops import pair as pair_ops

    if ff.eam is not None:
        raise NotImplementedError("pair_style eam requires the cell path")
    x = sys.x
    zero = x.new_zeros(())
    f = torch.zeros_like(x)
    evdwl = ecoul = zero
    virial = x.new_zeros(6)
    if ff.pair is not None:
        sp = ff.sp_code if ff.sp_code is not None else 0
        fp, ev, ec, vir = pair_ops.dense_pair_forces(
            x, sys.q, sys.type, sp, sys.mask, sys.box, ff.pair, mol=sys.mol)
        f = f + fp
        evdwl, ecoul = evdwl + ev, ecoul + ec
        virial = virial + vir
    f, evdwl, ecoul, virial, bonded = bonded_terms(sys, ff, f, evdwl, ecoul,
                                                   virial)
    return _long_range_terms(sys, ff, f, evdwl, ecoul, virial, bonded)


def _long_range_terms(sys, ff: ForceField, f, evdwl, ecoul,
                      virial, bonded) -> ForceResult:
    """The terms after the pair term, on either route, in the JAX
    package's order: the k-space term (the Ewald sum, its tables rescaled
    to the live box under kspace_dynamic; or PPPM on the positions
    relative to the box's lower corner and the live box lengths), then the
    polarization term (the Wolf
    field E0, the (N,3,N,3) tensor, the dipole solve from sys.mu under
    use_previous, the polar forces and epol), all on (N,N) tensors; the
    ForceResult of the pair term's f, evdwl, ecoul and virial with
    them and the bonded energies `bonded`."""
    from lidp_tpu_torch.ops import ewald as ewald_ops
    from lidp_tpu_torch.ops import polarization as pol_ops
    from lidp_tpu_torch.ops.pppm import pppm_forces_params

    x = sys.x
    zero = x.new_zeros(())
    elong = epol = zero
    mu = sys.mu
    scf_iters = 0
    scf_diverged = torch.zeros((), dtype=torch.bool, device=x.device)

    if ff.ewald is not None or ff.pppm is not None:
        if ff.ewald is not None:
            ewp = ff.ewald
            if ff.kspace_dynamic:
                ewp = ewald_ops.rescale_coeffs(ewp, sys.box.lengths)
            fk, el, vk = ewald_ops.ewald_forces(x, sys.q, sys.box.volume,
                                                ewp)
        else:
            fk, el, vk = pppm_forces_params(x - sys.box.lo, sys.q,
                                            sys.box.lengths, ff.pppm)
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
        f=f, evdwl=evdwl, ecoul=ecoul, elong=elong, epol=epol, **bonded,
        virial=virial, mu=mu,
        scf_iters=torch.tensor(scf_iters, dtype=torch.int32,
                               device=x.device),
        scf_diverged=scf_diverged)
