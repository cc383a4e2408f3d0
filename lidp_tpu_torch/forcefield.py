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
The k-space breadth follows the JAX package's order: the TIP4P
charge-site coulomb (ops/tip4p.py) after the pair term, the charge
k-space on the charge sites with its forces redistributed, then MSM
(ops/msm.py), the pppm/disp dispersion mesh and the ewald/disp dispersion
sum, each into E_long and the virial.  The pair term is that of
`pair`, then of each hybrid sub-style in `extra_pairs` (one masked pass
each, with its own special correction on the cell grid; the dsf and wolf
kinds' self energy into E_coul when energies are asked for), then the
DREIDING hydrogen bonds (ops/hbond.py) into E_vdwl and the DPD term
(ops/dpd.py), as in the JAX package; fix cmap's crossterms (ops/cmap.py)
come last, into ForceResult.ecmap and, under fix_modify energy yes, efix.
Neighbour lists (ROADMAP queue 1 item 5) raise NotImplementedError.
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
    # the TIP4P off-site charges (ops.tip4p.TIP4PParams): the coulomb
    # term on the charge sites after the pair term, and the charge
    # k-space on them; tip4p_cut: the bare cutoff coulomb of the tip4p/cut
    # styles in place of the erfc form
    tip4p: Optional[object] = None
    tip4p_cut: bool = False
    # the ewald/disp dispersion sum (ops.ewald.Ewald6Params) and the
    # pppm/disp mesh (ops.pppm.PPPMDispParams), both on the per-atom B_i
    # of b_atom (N,)
    ewald6: Optional[object] = None
    b_atom: Optional[torch.Tensor] = None
    pppm_disp: Optional[object] = None
    # the multilevel summation (kspace_style msm; ops.msm.MSMParams)
    msm: Optional[object] = None
    # pair_style hybrid and hybrid/overlay: the sub-styles after the first
    # (`pair`), one masked pass each, their unassigned type pairs excluded
    # by their excl tables
    extra_pairs: tuple = ()
    # pair_style dpd and dpd/tstat (ops.dpd.DPDParams), with `pair` None:
    # the dense (N,N) pass at every size
    dpd: Optional[object] = None
    # the DREIDING hydrogen bonds (pair hbond/dreiding/lj and /morse, alone
    # or as hybrid sub-styles; ops.hbond.HbondParams, one per sub-style):
    # the 3-body donor-hydrogen-acceptor [M, N] pass after the pair passes,
    # on either route
    hbond: tuple = ()
    # fix cmap's crossterms (ops.cmap.CMAPParams): after the long-range
    # terms, into ForceResult.ecmap, and into efix (the potential energy)
    # under fix_modify energy yes
    cmap: Optional[object] = None


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
          and not ff.extra_pairs and ff.dpd is None
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
    from lidp_tpu_torch.ops.pair import dsf_wolf_self_energy
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
    else:
        # the pair table, then each hybrid sub-style: one masked pass
        # each, its special correction and the dsf/wolf self energy
        total = None
        for p in (ff.pair,) + tuple(ff.extra_pairs):
            if p is ff.pair and route == "cell_pair_forces_lj":
                out = cell_pair_forces_lj(sys.x, sys.mask, nlist, sys.box, p,
                                          need_ev=need_ev)
            else:
                out = cell_pair_forces(sys.x, sys.q, sys.type, sys.mask,
                                       nlist, sys.box, p, need_ev=need_ev,
                                       mol=sys.mol)
            if ff.sp_idx is not None and not p.excl_mol:
                out = [a + b for a, b in zip(out, special_correction_sparse(
                    sys.x, sys.q, sys.type, ff.sp_idx, ff.sp_lvl, sys.mask,
                    sys.box, p))]
            out = list(out)
            if need_ev and has_self_energy(p):
                out[2] = out[2] + dsf_wolf_self_energy(p, sys.q, sys.mask)
            total = out if total is None else [a + b for a, b in
                                               zip(total, out)]
        f, ev, ec, vir = total
    f, ev, vir = hbond_term(sys, ff, f, ev, vir, need_ev)
    f, ev, vir = dpd_term(sys, ff, f, ev, vir, need_ev)
    f, ec, vir = tip4p_term(sys, ff, f, ec, vir)
    f, ev, ec, vir, bonded = bonded_terms(sys, ff, f, ev, ec, vir)
    if all(getattr(ff, k) is None for k in ("ewald", "pppm", "polar", "msm",
                                            "pppm_disp", "ewald6", "cmap")):
        return pair_only_result(sys, f, ev, ec, vir, bonded)
    return _long_range_terms(sys, ff, f, ev, ec, vir, bonded, need_ev)


def has_self_energy(p) -> bool:
    """Whether a pair table's coulomb kind tallies a self energy into
    E_coul (dsf and wolf: ops/pair.py dsf_wolf_self_energy)."""
    return p.coul and p.coul_kind in ("dsf", "wolf")


def hbond_term(sys, ff: ForceField, f, evdwl, virial, need_ev: bool = True):
    """The hydrogen bonds of each hbond sub-style (ops/hbond.py
    hbond_forces; lidp_tpu/forcefield.py:276-284) added to f, evdwl and
    virial; they pass through without ff.hbond."""
    if not ff.hbond:
        return f, evdwl, virial
    from lidp_tpu_torch.ops.hbond import hbond_forces

    for hp in ff.hbond:
        fh, evh, virh = hbond_forces(sys.x, sys.mask, sys.box, hp,
                                     need_ev=need_ev)
        f, evdwl, virial = f + fh, evdwl + evh, virial + virh
    return f, evdwl, virial


def cmap_term(sys, ff: ForceField, f, virial, need_ev: bool = True):
    """fix cmap's crossterms (ops/cmap.py cmap_forces;
    lidp_tpu/forcefield.py:459-468): (f, virial, ecmap, efix), efix the
    crossterm energy under fix_modify energy yes, else 0."""
    zero = sys.x.new_zeros(())
    if ff.cmap is None:
        return f, virial, zero, zero
    from lidp_tpu_torch.ops.cmap import cmap_forces

    fc, ec, vc = cmap_forces(sys.x, ff.cmap, need_ev=need_ev)
    return f + fc, virial + vc, ec, ec if ff.cmap.energy else zero


def dpd_term(sys, ff: ForceField, f, evdwl, virial, need_ev: bool = True):
    """The DPD pairs (ops/dpd.py dpd_forces at the System's step, with the
    special codes) added to f, evdwl and virial; they pass through
    without ff.dpd."""
    if ff.dpd is None:
        return f, evdwl, virial
    from lidp_tpu_torch.ops.dpd import dpd_forces

    fd, evd, vird = dpd_forces(sys.x, sys.v, sys.type, sys.mask, sys.box,
                               ff.dpd, sys.step, sp_code=ff.sp_code,
                               need_ev=need_ev)
    return f + fd, evdwl + evd, virial + vird


def tip4p_term(sys, ff: ForceField, f, ecoul, virial):
    """The TIP4P charge-site coulomb (lidp_tpu/forcefield.py :296-304),
    the dense (N,N) pass with the special codes, its forces redistributed
    onto O, H1, H2, added to f, ecoul and virial; they pass through
    without ff.tip4p."""
    if ff.tip4p is None:
        return f, ecoul, virial
    from lidp_tpu_torch.ops.tip4p import redistribute, tip4p_coul_dense

    sp = ff.sp_code if ff.sp_code is not None else 0
    fcs, ec4, vc4 = tip4p_coul_dense(
        sys.x, sys.q, sp, sys.mask, sys.box, ff.pair.cut_coulsq,
        ff.pair.g_ewald, ff.qqrd2e, ff.pair.special_coul, ff.tip4p,
        mode="cut" if ff.tip4p_cut else "long")
    return f + redistribute(fcs, ff.tip4p), ecoul + ec4, virial + vc4


def dense_forces(sys, ff: ForceField) -> ForceResult:
    """The dense route of lidp_tpu/forcefield.py compute_forces
    (nlist=None) in its order: the all-pairs pass of the pair style and
    of each hybrid sub-style with the special codes, the hydrogen bonds,
    the DPD pairs, the TIP4P sites, the bonded terms (bonded_terms), then
    the k-space sum, the polarization term and fix cmap's crossterms
    (_long_range_terms).  Plain PyTorch on
    (N,N) tensors: no kernel of ops/panel.py runs here."""
    from lidp_tpu_torch.ops import pair as pair_ops
    from lidp_tpu_torch.ops.pair import dsf_wolf_self_energy

    if ff.eam is not None:
        raise NotImplementedError("pair_style eam requires the cell path")
    x = sys.x
    zero = x.new_zeros(())
    f = torch.zeros_like(x)
    evdwl = ecoul = zero
    virial = x.new_zeros(6)
    sp = ff.sp_code if ff.sp_code is not None else 0
    for p in ((ff.pair,) + tuple(ff.extra_pairs) if ff.pair is not None
              else ()):
        fp, ev, ec, vir = pair_ops.dense_pair_forces(
            x, sys.q, sys.type, sp, sys.mask, sys.box, p, mol=sys.mol)
        if has_self_energy(p):
            ec = ec + dsf_wolf_self_energy(p, sys.q, sys.mask)
        f = f + fp
        evdwl, ecoul = evdwl + ev, ecoul + ec
        virial = virial + vir
    f, evdwl, virial = hbond_term(sys, ff, f, evdwl, virial)
    f, evdwl, virial = dpd_term(sys, ff, f, evdwl, virial)
    f, ecoul, virial = tip4p_term(sys, ff, f, ecoul, virial)
    f, evdwl, ecoul, virial, bonded = bonded_terms(sys, ff, f, evdwl, ecoul,
                                                   virial)
    return _long_range_terms(sys, ff, f, evdwl, ecoul, virial, bonded)


def _long_range_terms(sys, ff: ForceField, f, evdwl, ecoul,
                      virial, bonded, need_ev: bool = True) -> ForceResult:
    """The terms after the pair term, on either route, in the JAX
    package's order: the k-space term (the Ewald sum, its tables rescaled
    to the live box under kspace_dynamic; or PPPM on the positions
    relative to the box's lower corner and the live box lengths; on the
    TIP4P charge sites where there are some), MSM, the pppm/disp mesh,
    the ewald/disp dispersion sum, then the polarization term (the Wolf
    field E0, the (N,3,N,3) tensor, the dipole solve from sys.mu under
    use_previous, the polar forces and epol), all on (N,N) tensors; the
    ForceResult of the pair term's f, evdwl, ecoul and virial with
    them and the bonded energies `bonded`; last fix cmap's crossterms
    (cmap_term), with their virial only under need_ev, as the JAX
    package forms it."""
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
        # TIP4P: the charge sum sees the charge sites and its forces
        # redistribute onto O, H1, H2 (pppm_tip4p.cpp particle_map +
        # fieldforce)
        xk = x
        if ff.tip4p is not None:
            from lidp_tpu_torch.ops.tip4p import charge_sites

            xk = charge_sites(x, sys.box, ff.tip4p)
        if ff.ewald is not None:
            ewp = ff.ewald
            if ff.kspace_dynamic:
                ewp = ewald_ops.rescale_coeffs(ewp, sys.box.lengths)
            fk, el, vk = ewald_ops.ewald_forces(xk, sys.q, sys.box.volume,
                                                ewp)
        else:
            fk, el, vk = pppm_forces_params(xk - sys.box.lo, sys.q,
                                            sys.box.lengths, ff.pppm)
        if ff.tip4p is not None:
            from lidp_tpu_torch.ops.tip4p import redistribute

            fk = redistribute(fk, ff.tip4p)
        f = f + fk
        elong = elong + el
        virial = virial + vk

    # then MSM, the pppm/disp mesh and the ewald/disp dispersion sum, each
    # into E_long as every k-space energy (ewald_disp.cpp compute())
    if ff.msm is not None:
        from lidp_tpu_torch.ops.msm import msm_forces

        fm, em, vm = msm_forces(x - sys.box.lo, sys.q, sys.box.lengths,
                                ff.msm)
        f, elong, virial = f + fm, elong + em, virial + vm
    if ff.pppm_disp is not None:
        from lidp_tpu_torch.ops.pppm import pppm_disp_forces

        f6, e6, v6 = pppm_disp_forces(x - sys.box.lo, ff.b_atom,
                                      sys.box.lengths, ff.pppm_disp)
        f, elong, virial = f + f6, elong + e6, virial + v6
    if ff.ewald6 is not None:
        f6, e6, v6 = ewald_ops.ewald6_forces(x, ff.b_atom, sys.box.volume,
                                             ff.ewald6)
        f, elong, virial = f + f6, elong + e6, virial + v6

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

    f, virial, ecmap, efix = cmap_term(sys, ff, f, virial, need_ev)
    return ForceResult(
        f=f, evdwl=evdwl, ecoul=ecoul, elong=elong, epol=epol, **bonded,
        ecmap=ecmap, efix=efix, virial=virial, mu=mu,
        scf_iters=torch.tensor(scf_iters, dtype=torch.int32,
                               device=x.device),
        scf_diverged=scf_diverged)
